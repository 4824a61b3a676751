"""Forward-backward consistency / occlusion masking (extension).

NOT in the reference (Kr-Stam/CUDA_Optical_Flow_2 has no flow validation at
all — its only QA is the visual arrow overlay, main.cu:114-174); provided
because dense-flow consumers routinely need a per-pixel validity signal:
backward warping the reverse flow and testing the cycle residual is the
standard occlusion test (|F_fw(x) + F_bw(x + F_fw(x))| small where the
estimate is trustworthy).

Design: the check is a warp (the same backward-warp primitive the models
use) plus elementwise math — it jits into the surrounding pipeline, and
``consistent_flow`` runs forward and backward estimation as one program so
XLA can schedule the two independent passes back to back on-device.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from cuda_optical_flow_2_tpu.ops.warp import warp_bilinear

__all__ = [
    "fb_consistency",
    "occlusion_mask",
    "occlusion_score",
    "consistent_flow",
    "fill_occluded_flow",
]


def fb_consistency(
    flow_fw: jax.Array, flow_bw: jax.Array
) -> jax.Array:
    """Cycle residual |F_fw(x) + F_bw(x + F_fw(x))| per pixel.

    Args:
      flow_fw: (..., H, W, 2) forward flow (prev -> next, the framework's
        convention prev(x) = next(x + d)).
      flow_bw: (..., H, W, 2) backward flow (next -> prev).
    Returns: (..., H, W) float residual magnitude; ~0 where the two fields
    are cycle-consistent, large at occlusions and mistracks.
    """
    cyc2, _ = _cycle_terms(flow_fw, flow_bw)
    return jnp.sqrt(cyc2)


def occlusion_mask(
    flow_fw: jax.Array,
    flow_bw: jax.Array,
    alpha: float = 0.01,
    beta: float = 0.5,
) -> jax.Array:
    """Boolean occlusion/mistrack mask from the cycle residual.

    Uses the standard magnitude-adaptive threshold (Sundaram et al. 2010):
    occluded where |cycle|^2 > alpha * (|F_fw|^2 + |F_bw(x+F_fw)|^2) + beta.
    Returns True where the flow should NOT be trusted.
    """
    return occlusion_score(flow_fw, flow_bw, alpha=alpha) > beta


def occlusion_score(
    flow_fw: jax.Array, flow_bw: jax.Array, alpha: float = 0.01
) -> jax.Array:
    """Continuous occlusion evidence: ``|cycle|^2 - alpha * mag^2``.

    :func:`occlusion_mask` is exactly ``occlusion_score(...) > beta`` — the
    score is the thresholdable form, so precision/recall tradeoffs can be
    swept over ``beta`` from ONE forward/backward flow pair (the layered-
    motion benchmark's PR curves, docs/studies/layered_motion_study.py).
    """
    cyc2, mag2 = _cycle_terms(flow_fw, flow_bw)
    return cyc2 - alpha * mag2


def _cycle_terms(
    flow_fw: jax.Array, flow_bw: jax.Array
) -> tuple[jax.Array, jax.Array]:
    """Shared core of the cycle test: backward-warp the reverse flow once,
    return (|cycle|^2, |F_fw|^2 + |F_bw(x+F_fw)|^2)."""
    bw_u = warp_bilinear(flow_bw[..., 0], flow_fw)
    bw_v = warp_bilinear(flow_bw[..., 1], flow_fw)
    ru = flow_fw[..., 0] + bw_u
    rv = flow_fw[..., 1] + bw_v
    cyc2 = ru * ru + rv * rv
    mag2 = (
        flow_fw[..., 0] ** 2
        + flow_fw[..., 1] ** 2
        + bw_u * bw_u
        + bw_v * bw_v
    )
    return cyc2, mag2


def consistent_flow(
    prev: jax.Array,
    nxt: jax.Array,
    config,
    alpha: float = 0.01,
    beta: float = 0.5,
    fill: bool = False,
) -> tuple[jax.Array, jax.Array]:
    """Forward flow plus its occlusion mask, in one jittable call.

    Runs the configured model (LK/HS/FB via the config type) in both
    directions and applies :func:`occlusion_mask`.  With ``fill=True`` the
    masked pixels are additionally replaced by the side-aware diffusion
    fill (:func:`fill_occluded_flow`, single-frame-pair layout only) —
    best-effort values where the mask says "don't trust the estimate".

    Returns (flow, occluded): (..., H, W, 2) and boolean (..., H, W).
    """
    from cuda_optical_flow_2_tpu.models import pyramidal_flow

    flow_fw = pyramidal_flow(prev, nxt, config)
    flow_bw = pyramidal_flow(nxt, prev, config)
    occ = occlusion_mask(flow_fw, flow_bw, alpha=alpha, beta=beta)
    if fill:
        flow_fw = fill_occluded_flow(flow_fw, occ)
    return flow_fw, occ


def fill_occluded_flow(
    flow: jax.Array,
    occ: jax.Array,
    iterations: int = 96,
    beta: float = 1.0,
) -> jax.Array:
    """Replace occluded flow with a side-aware diffusion fill.

    Flow in occluded regions is unknowable from two frames; every estimator
    extrapolates there (the layered-motion benchmark measures 1.6-5.7 px
    unmatched EPE, docs/PERF.md).  But the occluded pixels belong to the
    surface being COVERED, so the right fill comes from the occludee's
    side of the band — a plain two-sided diffusion barely helps (mixes
    occluder and occludee flow: 2.64 -> 2.51 on the disk case), while a
    background-side oracle fill reaches 0.46.

    Side selection without truth: the occluder is the side whose flow
    points INTO the occluded region (it is covering it).  Each trusted
    source pixel gets weight ``exp(-beta * max(0, f . n))`` where ``n`` is
    the inward normal of the occluded region (gradient of the blurred
    mask); the diffusion's per-step normalization turns this into a local
    softmin over the inward projection, so the fill is dominated by the
    occludee.  Measured on the layered benchmark with the TRUE mask
    (docs/studies/occlusion_fill_study.py): unmatched EPE 2.64 -> 1.84
    (disk), 4.37 -> 3.15 (bar), 1.76 -> 0.83 (two-disks) at the defaults
    — improvement on every case; larger beta trades cases
    non-monotonically (numerically safe, but tuned per content).  With
    the DETECTED mask (occlusion_mask on TV-L1 flow) the gains shrink
    with mask quality but remain positive.  Matched pixels are returned
    bit-identical.

    Args:
      flow: (H, W, 2) dense flow.
      occ: (H, W) bool — True where the flow should be replaced
        (:func:`occlusion_mask`, or dataset truth).
      iterations: diffusion sweeps; the fill front advances one pixel per
        sweep, so ~2x the widest occluded band is enough (default covers
        bands up to ~45 px).
      beta: inward-projection penalty (1/px); 0 = plain two-sided
        diffusion.
    Returns: (H, W, 2) flow with occluded pixels filled.
    """
    from jax import lax

    from cuda_optical_flow_2_tpu.models.horn_schunck import (
        _DXC,
        _DYC,
        _avg3x3,
    )
    from cuda_optical_flow_2_tpu.ops.conv import stencil2d

    u = jnp.asarray(flow, jnp.float32)
    occf = jnp.asarray(occ, jnp.float32)
    m = occf
    for _ in range(4):
        m = 0.5 * _avg3x3(m) + 0.5 * occf
    gx = -stencil2d(m, _DXC)
    gy = -stencil2d(m, _DYC)
    norm = jnp.sqrt(gx * gx + gy * gy) + 1e-6
    proj = (u[..., 0] * gx + u[..., 1] * gy) / norm
    src_w = jnp.exp(-beta * jnp.clip(proj, 0.0, 30.0))
    trusted = (1.0 - occf) * src_w
    keep = (1.0 - occf)[..., None] > 0

    def sweep(_, state):
        known, wgt = state
        num = jnp.stack(
            [_avg3x3(known[..., 0]), _avg3x3(known[..., 1])], -1
        )
        den = _avg3x3(wgt[..., 0])[..., None]
        newu = num / jnp.maximum(den, 1e-9)
        filled = (den[..., 0] > 1e-9)[..., None]
        known = jnp.where(keep, known, jnp.where(filled, newu, known))
        wgt = jnp.where(
            keep, wgt, jnp.maximum(wgt, filled.astype(jnp.float32))
        )
        return known, wgt

    known, _ = lax.fori_loop(
        0, iterations, sweep, (u * trusted[..., None], trusted[..., None])
    )
    return jnp.where(keep, u, known)
