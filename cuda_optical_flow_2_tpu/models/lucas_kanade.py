"""Pyramidal Lucas-Kanade dense optical flow — the production pipeline.

Accelerator-resident replacement for the reference's orchestration layer:
gpu::calc_opt_flow (OptFlowGpu.cu:1909-1979) and the coarse-to-fine driver
loop in main (main.cu:256-262).  Differences by design (SURVEY.md section 7):

* The whole pipeline is one pure jitted function over float32 planar
  grayscale ``jax.Array``s — no per-op host round trips (the reference crosses
  the PCIe boundary ~24 times per level per frame).
* Coarse-to-fine propagation carries ONE dense flow down the pyramid:
  upsample x2 -> bilinear-warp the next frame -> solve for the residual ->
  add.  The reference instead stores per-level flows and composes them at
  visualization time (main.cu:138-147); :func:`compose_flow_pyramid`
  reproduces that exact composition for parity checks.
* The 2x2 solve is guarded (|det| < eps -> 0) instead of dividing by a raw,
  possibly zero determinant (OptFlowGpu.cu:1835).
* The hot per-level stage (gradients -> window sums -> solve) runs as one
  fused Pallas-Triton kernel on the GPU (kernels/lk_fused.py) and as the
  pure-XLA ops elsewhere; kernels.residual_impl makes the choice.

All entry points accept leading batch dims: images (..., H, W), flows
(..., H, W, 2).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from cuda_optical_flow_2_tpu.config import LKConfig
from cuda_optical_flow_2_tpu.kernels import lk_fused, residual_impl
from cuda_optical_flow_2_tpu.ops.bilateral import bilateral_filter
from cuda_optical_flow_2_tpu.ops.gradients import spatial_gradients, temporal_gradient
from cuda_optical_flow_2_tpu.ops.pyramid import build_pyramid
from cuda_optical_flow_2_tpu.ops.resize import upsample_flow
from cuda_optical_flow_2_tpu.ops.solve import solve_2x2, solve_2x2_unguarded
from cuda_optical_flow_2_tpu.ops.warp import warp_bilinear, warp_nearest
from cuda_optical_flow_2_tpu.ops.window import structure_tensor_sums

__all__ = [
    "lk_level",
    "pyramidal_lk",
    "pyramidal_lk_pyramid",
    "compose_flow_pyramid",
    "solve_flow",
]


def solve_flow(sums, config: LKConfig) -> jax.Array:
    """2x2 solve from structure-tensor sums, guarded per ``config.det_eps``
    (eps=0.0 reproduces the reference's unguarded divide, OptFlowGpu.cu:1835)."""
    if config.det_eps == 0.0:
        return solve_2x2_unguarded(*sums)
    return solve_2x2(*sums, eps=config.det_eps)


def _lk_residual_xla(
    prev: jax.Array, nxt: jax.Array, config: LKConfig
) -> jax.Array:
    """Residual flow between prev and (already warped) next — pure-XLA path."""
    ix, iy = spatial_gradients(prev, config.normalize_gradients)
    it = temporal_gradient(prev, nxt, config.temporal_kernel, config.normalize_gradients)
    sums = structure_tensor_sums(
        ix, iy, it, config.window, config.window_method, config.window_weights
    )
    return solve_flow(sums, config)


def _lk_residual(prev: jax.Array, nxt: jax.Array, config: LKConfig) -> jax.Array:
    if residual_impl(jax.default_backend(), prev.dtype, prev.shape, config) == "triton":
        return lk_fused.lk_residual(prev, nxt, config)
    return _lk_residual_xla(prev, nxt, config)


def lk_level(
    prev: jax.Array,
    nxt: jax.Array,
    flow_init: jax.Array | None,
    config: LKConfig,
) -> jax.Array:
    """One pyramid level: warp -> gradients -> window sums -> solve (+iterate).

    Twin of gpu::calc_opt_flow (OptFlowGpu.cu:1909-1979) with the warp
    implementing the documented intent (bilinear, per-pixel initial flow)
    rather than the reference's (0,0)-sampling nearest shift.
    ``config.iterations`` > 1 re-warps with the refined flow and re-solves,
    which the reference never does but BASELINE config 2 requires.
    """
    if flow_init is None:
        # Coarsest level: no prior flow, so no warp (reference:
        # OptFlowGpu.cu:1917-1921 skips the shift at level == maxLevel-1).
        flow = _lk_residual(prev, nxt, config)
        if config.warp_mode == "none" or config.iterations == 1:
            return flow
        return lk_level(prev, nxt, flow, _with_iterations(config, config.iterations - 1))
    flow = flow_init
    if config.warp_mode == "none":
        # Without warping, re-iterating recomputes the same residual.
        return flow + _lk_residual(prev, nxt, config)
    warp = warp_fn(config)
    for _ in range(config.iterations):
        flow = flow + _lk_residual(prev, warp(nxt, flow), config)
    return flow


def _with_iterations(config: LKConfig, iterations: int) -> LKConfig:
    import dataclasses

    return dataclasses.replace(config, iterations=iterations)


def warp_fn(config):
    """The configured backward warp: XLA's bilinear gather, or nearest."""
    return warp_nearest if config.warp_mode == "nearest" else warp_bilinear


def _validate(prev: jax.Array, nxt: jax.Array, config: LKConfig) -> None:
    if prev.shape != nxt.shape:
        raise ValueError(f"frame shapes differ: {prev.shape} vs {nxt.shape}")
    h, w = prev.shape[-2:]
    top = config.levels - 1
    if (h >> top) < 2 or (w >> top) < 2:
        raise ValueError(
            f"{config.levels} pyramid levels need an image of at least "
            f"{2 << top}x{2 << top}; got {h}x{w}"
        )


def preprocess(frame: jax.Array, config: LKConfig) -> list[jax.Array]:
    """Frame -> (optionally bilateral-filtered) Gaussian pyramid.

    The per-frame half of the reference main loop (main.cu:232-250:
    grayscale -> bilateral -> gauss_pyramid); grayscale conversion happens at
    the ingestion boundary (ops/color.py), so this takes a planar float
    frame.
    """
    if config.prefilter is not None:
        pf = config.prefilter
        frame = bilateral_filter(
            frame, None, pf.window, pf.sigma_spatial, pf.sigma_range
        )
    return build_pyramid(frame, config.levels)


def coarse_to_fine(
    prev_pyr: list[jax.Array],
    next_pyr: list[jax.Array],
    config: LKConfig,
    init_flow: jax.Array | None = None,
) -> list[jax.Array]:
    """Coarse-to-fine pass over prebuilt pyramids; returns the flow pyramid.

    Twin of the per-frame flow loop (main.cu:256-262), with the carried flow
    upsampled and warped per level instead of the reference's per-level
    residual fields.  ``init_flow`` (coarsest-level resolution and pixel
    units) warm-starts the coarsest level — the streaming layer passes the
    previous pair's flow here.
    """
    flows: list[jax.Array | None] = [None] * config.levels
    flow = init_flow
    for k in range(config.levels - 1, -1, -1):
        if flow is not None:
            flow = upsample_flow(flow, prev_pyr[k].shape[-2:])
        flow = lk_level(prev_pyr[k], next_pyr[k], flow, config)
        flows[k] = flow
    return flows  # type: ignore[return-value]


def pyramidal_lk_pyramid(
    prev: jax.Array, nxt: jax.Array, config: LKConfig
) -> list[jax.Array]:
    """Coarse-to-fine LK returning the full flow pyramid (finest first).

    Level k flow is in level-k pixel units, matching the reference's
    per-level flow pyramid (main.cu:256-262).  The two frames' pyramids are
    built in ONE stacked pass — the pyramid stencil and the prefilter
    batch over the pair, halving the preprocess dispatch count.
    """
    _validate(prev, nxt, config)  # equal shapes guaranteed below
    both = preprocess(jnp.stack([prev, nxt], axis=0), config)
    prev_pyr = [lvl[0] for lvl in both]
    next_pyr = [lvl[1] for lvl in both]
    return coarse_to_fine(prev_pyr, next_pyr, config)


def pyramidal_lk(prev: jax.Array, nxt: jax.Array, config: LKConfig) -> jax.Array:
    """Dense flow (..., H, W, 2) from a frame pair — the flagship entry point.

    ``prev``/``nxt`` are planar grayscale float images (any leading batch
    dims).  Jit with ``static_argnames=("config",)``.
    """
    return pyramidal_lk_pyramid(prev, nxt, config)[0]


# Jitted convenience wrapper; config is hashable (frozen dataclass).
pyramidal_lk_jit = jax.jit(pyramidal_lk, static_argnames=("config",))


def compose_flow_pyramid(
    flow_pyramid: list[jax.Array], level: int = 0
) -> jax.Array:
    """Reference-exact composition of a per-level flow pyramid at ``level``.

    Twin of the visualizer's accumulation (main.cu:138-147): at each pixel
    (i, j) of the target level, total = sum over k >= level of
    2^(k-level) * flow[k][i >> (k-level), j >> (k-level)].
    """
    target = flow_pyramid[level]
    h, w = target.shape[-3:-1]
    total = jnp.zeros_like(target)
    for k in range(len(flow_pyramid) - 1, level - 1, -1):
        scale = k - level
        f = flow_pyramid[k]
        # (i >> scale, j >> scale) sampling == nearest upsample by 2^scale.
        up = jnp.repeat(jnp.repeat(f, 1 << scale, axis=-3), 1 << scale, axis=-2)
        uh, uw = up.shape[-3:-1]
        if uh < h or uw < w:  # floor-halved odd dims: extend with edge pixels
            pad = [(0, 0)] * (up.ndim - 3) + [(0, h - uh), (0, w - uw), (0, 0)]
            up = jnp.pad(up, pad, mode="edge")
        up = up[..., :h, :w, :]
        total = total + up * float(1 << scale)
    return total
