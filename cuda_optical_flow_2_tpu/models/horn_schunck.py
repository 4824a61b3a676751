"""Horn-Schunck dense optical flow — a second model family (extension).

NOT in the reference (Kr-Stam/CUDA_Optical_Flow_2 implements pyramidal
Lucas-Kanade only); provided so the framework covers the other classic dense
method: a GLOBAL variational flow with a smoothness prior, where LK is a
local least-squares fit.  HS fills in textureless regions (where LK's
structure tensor is singular) by propagating flow from neighbors.

Formulation: the Jacobi relaxation

    u <- u_bar - Ix (Ix u_bar + Iy v_bar + It) / (alpha^2 + Ix^2 + Iy^2)
    v <- v_bar - Iy (Ix u_bar + Iy v_bar + It) / (alpha^2 + Ix^2 + Iy^2)

is a 3x3 stencil (the neighbor average u_bar) plus elementwise math, which
XLA fuses into a few kernels; the fixed-iteration loop is a
``lax.scan`` (static trip count, no data-dependent control flow).  The
pyramidal driver reuses the LK scaffolding: the same Gaussian pyramid,
exact-2x flow upsampler, and backward warp (ops/ + models/lucas_kanade).
Everything is jittable with the config static, and batches over leading dims.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax

from cuda_optical_flow_2_tpu.config import BilateralConfig
from cuda_optical_flow_2_tpu.ops.gradients import spatial_gradients, temporal_gradient
from cuda_optical_flow_2_tpu.ops.pyramid import build_pyramid
from cuda_optical_flow_2_tpu.ops.resize import upsample_flow

__all__ = [
    "HSConfig",
    "hs_level",
    "horn_schunck",
    "hs_preprocess",
    "hs_coarse_to_fine",
    "pyramidal_hs",
]

# Horn & Schunck 1981 neighbor-average weights (4-neighbors 1/6, diagonals
# 1/12; center 0 — the center enters through the data term).
HS_AVG_3X3 = np.array(
    [
        [1 / 12, 1 / 6, 1 / 12],
        [1 / 6, 0.0, 1 / 6],
        [1 / 12, 1 / 6, 1 / 12],
    ],
    dtype=np.float32,
)


@dataclasses.dataclass(frozen=True)
class HSConfig:
    """Horn-Schunck configuration (frozen/hashable; jit with it static).

    Attributes:
      alpha: smoothness weight; larger = smoother flow (classic range 1-20
        for 8-bit-scale intensities).
      iterations: Jacobi relaxation sweeps per pyramid level.
      levels: pyramid depth (1 = original single-scale Horn-Schunck).
      temporal_kernel: as in LKConfig ("gauss3" recommended).
      prefilter: optional joint-bilateral pre-smoothing, as in LKConfig.
      max_displacement: spatial-TP halo budget, as in LKConfig.
    """

    alpha: float = 10.0
    iterations: int = 100
    levels: int = 3
    temporal_kernel: str = "gauss3"
    prefilter: Optional[BilateralConfig] = None
    max_displacement: int = 32
    # Robust (Charbonnier) penalties via lagged diffusivity — the same
    # mechanism as DISConfig.refine_penalty: per-pixel data/smoothness
    # weights frozen per chunk of ROBUST_CHUNK sweeps, eps -> inf =
    # quadratic.  Robust HS is a "TV-lite" operating point:
    # discontinuity-preserving smoothing at HS cost (accuracy on the
    # layered benchmark — docs/PERF.md).  Note the pyramidal driver
    # relaxes the per-level RESIDUAL, so the smoothness weight sees the
    # residual's gradients; motion-boundary steps survive coarse-to-fine
    # into the residual, which is what the weight needs.
    penalty: str = "quadratic"
    eps_data: float = 3.0
    eps_smooth: float = 0.1

    def __post_init__(self) -> None:
        if self.alpha <= 0:
            raise ValueError(f"alpha must be > 0, got {self.alpha}")
        if self.iterations < 1 or self.levels < 1:
            raise ValueError("iterations and levels must be >= 1")
        if self.penalty not in ("quadratic", "charbonnier"):
            raise ValueError(f"unknown penalty {self.penalty!r}")
        if self.eps_data <= 0 or self.eps_smooth <= 0:
            raise ValueError("eps_data and eps_smooth must be > 0")


def hs_level(
    prev: jax.Array,
    nxt: jax.Array,
    flow_init: jax.Array | None,
    config: HSConfig,
) -> jax.Array:
    """Jacobi-relaxed HS flow for one level, warm-started at ``flow_init``.

    ``nxt`` should already be warped by ``flow_init`` when warm-starting from
    a coarser level (the returned flow then includes ``flow_init``).
    """
    robust = _robust_eps(config)
    ix, iy = spatial_gradients(prev, normalize=True)
    it = temporal_gradient(prev, nxt, config.temporal_kernel, normalize=True)

    if flow_init is None:
        uv0 = jnp.zeros(prev.shape + (2,), prev.dtype)
    else:
        uv0 = flow_init

    if robust is not None:
        return _robust_relax_xla(
            uv0, ix, iy, it, config.iterations, config.alpha, robust
        )
    denom = config.alpha**2 + ix * ix + iy * iy

    def sweep(uv, _):
        u_bar = _avg3x3(uv[..., 0])
        v_bar = _avg3x3(uv[..., 1])
        rate = (ix * u_bar + iy * v_bar + it) / denom
        return jnp.stack([u_bar - ix * rate, v_bar - iy * rate], axis=-1), None

    uv, _ = lax.scan(sweep, uv0, None, length=config.iterations)
    return uv


def _robust_eps(config) -> tuple[float, float] | None:
    """(eps_data, eps_smooth) for the Charbonnier penalty, else None."""
    if getattr(config, "penalty", "quadratic") != "charbonnier":
        return None
    return (config.eps_data, config.eps_smooth)


def _avg3x3(x: jax.Array) -> jax.Array:
    """HS neighbor average as shifted adds (zero-padded, == conv2d(HS_AVG_3X3)).

    Pad-and-slice shifts fuse with the surrounding elementwise update of
    each sweep.
    """
    pad = [(0, 0)] * (x.ndim - 2) + [(1, 1), (1, 1)]
    xp = jnp.pad(x, pad)
    h, w = x.shape[-2:]

    def sh(dy: int, dx: int) -> jax.Array:
        return lax.slice_in_dim(
            lax.slice_in_dim(xp, 1 + dy, 1 + dy + h, axis=-2),
            1 + dx,
            1 + dx + w,
            axis=-1,
        )

    cross = sh(-1, 0) + sh(1, 0) + sh(0, -1) + sh(0, 1)
    diag = sh(-1, -1) + sh(-1, 1) + sh(1, -1) + sh(1, 1)
    return cross * jnp.asarray(1 / 6, x.dtype) + diag * jnp.asarray(1 / 12, x.dtype)


# Sweeps per lagged-weight chunk of the Charbonnier relaxation.
ROBUST_CHUNK = 16

# Central-difference masks for the lagged-diffusivity flow gradient
# (du[x] = (u[x-1] - u[x+1])/2 — only the squared magnitude is used).
_DXC = np.array([[0.5, 0.0, -0.5]], np.float32)
_DYC = _DXC.T


def _robust_relax_xla(
    flow: jax.Array,
    ix: jax.Array,
    iy: jax.Array,
    it: jax.Array,
    iterations: int,
    alpha: float,
    robust: tuple[float, float],
) -> jax.Array:
    """Charbonnier relaxation by lagged diffusivity.

    Shared by robust HS (HSConfig.penalty) and robust DIS refinement
    (DISConfig.refine_penalty).  The lagged weights are recomputed from the
    current flow every ``ROBUST_CHUNK`` sweeps and frozen within the chunk.
    Zero-shift boundary throughout (stencil2d / _avg3x3).
    """
    from cuda_optical_flow_2_tpu.ops.conv import stencil2d

    ed, es = robust
    alpha2 = alpha * alpha

    def chunk(uv, sweeps: int) -> jax.Array:
        u, v = uv[..., 0], uv[..., 1]
        r = ix * u + iy * v + it
        wd = ed * lax.rsqrt(r * r + ed * ed)
        g2 = (
            stencil2d(u, _DXC) ** 2
            + stencil2d(v, _DXC) ** 2
            + stencil2d(u, _DYC) ** 2
            + stencil2d(v, _DYC) ** 2
        )
        ws = es * lax.rsqrt(g2 + es * es)
        s_plane = jnp.maximum((ws + _avg3x3(ws)) * 0.5, 1e-12)
        inv_s = 1.0 / s_plane
        inv_denom = 1.0 / (alpha2 * s_plane + wd * (ix * ix + iy * iy))
        for _ in range(sweeps):
            u_bar = (ws * _avg3x3(u) + _avg3x3(ws * u)) * 0.5 * inv_s
            v_bar = (ws * _avg3x3(v) + _avg3x3(ws * v)) * 0.5 * inv_s
            rate = wd * (ix * u_bar + iy * v_bar + it) * inv_denom
            u = u_bar - ix * rate
            v = v_bar - iy * rate
        return jnp.stack([u, v], axis=-1)

    k = min(ROBUST_CHUNK, iterations)
    n_full, rem = divmod(iterations, k)
    uv = flow
    for _ in range(n_full):
        uv = chunk(uv, k)
    if rem:
        uv = chunk(uv, rem)
    return uv


def horn_schunck(prev: jax.Array, nxt: jax.Array, config: HSConfig) -> jax.Array:
    """Single-scale Horn-Schunck (the 1981 algorithm), (..., H, W) -> flow."""
    return hs_level(prev, nxt, None, config)


def lk_preproc_config(config):
    """LKConfig view of any model config, for the shared preprocess/warp
    plumbing: the knobs every family carries (levels, prefilter,
    max_displacement) — ONE place to thread new knobs through, used by the
    HS/FB/TVL1 families alike."""
    return dataclasses.replace(
        _LK_PREPROC,
        levels=config.levels,
        prefilter=config.prefilter,
        max_displacement=config.max_displacement,
    )


def _lk_like(config: HSConfig):
    return lk_preproc_config(config)


def hs_preprocess(frame: jax.Array, config: HSConfig) -> list[jax.Array]:
    """Frame -> (optionally bilateral-filtered) Gaussian pyramid (shared with LK)."""
    from cuda_optical_flow_2_tpu.models.lucas_kanade import preprocess

    return preprocess(frame, _lk_like(config))


def hs_coarse_to_fine(
    prev_pyr: list[jax.Array],
    next_pyr: list[jax.Array],
    config: HSConfig,
    init_flow: jax.Array | None = None,
) -> jax.Array:
    """Coarse-to-fine HS over prebuilt pyramids; returns the finest flow.

    Uses the same backward warp as the LK pipeline; the warped residual is
    relaxed at each level and accumulated on the carried flow.
    """
    from cuda_optical_flow_2_tpu.models.lucas_kanade import warp_fn

    warp = warp_fn(_lk_like(config))
    flow = init_flow
    for k in range(config.levels - 1, -1, -1):
        p, n = prev_pyr[k], next_pyr[k]
        if flow is None:
            flow = hs_level(p, n, None, config)
        else:
            flow = upsample_flow(flow, p.shape[-2:])
            warped = warp(n, flow)
            flow = flow + hs_level(p, warped, None, config)
    return flow


def pyramidal_hs(prev: jax.Array, nxt: jax.Array, config: HSConfig) -> jax.Array:
    """Coarse-to-fine Horn-Schunck: handles motion beyond one pixel/iteration.

    Same scaffolding as the LK pipeline: Gaussian pyramids, exact-2x flow
    upsampling, bilinear warp; see :func:`hs_coarse_to_fine`.
    """
    return hs_coarse_to_fine(
        hs_preprocess(prev, config), hs_preprocess(nxt, config), config
    )


# Minimal LKConfig used purely to drive the shared preprocess() (pyramid +
# optional bilateral); its LK-specific fields are irrelevant here.
from cuda_optical_flow_2_tpu.config import LKConfig as _LKConfig  # noqa: E402

_LK_PREPROC = _LKConfig(levels=3, window=9)

pyramidal_hs_jit = jax.jit(pyramidal_hs, static_argnames=("config",))
