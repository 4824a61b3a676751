"""Flow upsampling and nearest-neighbor upscaling.

``upsample_flow`` is the coarse-to-fine propagation step: the reference never
materializes an upsampled flow — its warp samples the coarser field directly
at (i >> s, j >> s) and scales by 2^s (the *correct* accumulation lives in the
visualizer, main.cu:138-147) — but the production pipeline carries a single
dense flow down the pyramid, so the coarser field is resized to the finer grid
and doubled.

``upscale_nn`` is the debug-path twin of utils::upscale_1ch/upscale_3ch
(OptFlowUtils.cpp:21-61): exact 2^n pixel replication.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

__all__ = ["downsample_flow", "upsample_flow", "upscale_nn"]


def _up2x_axis(x: jax.Array, axis: int) -> jax.Array:
    """Exact 2x bilinear upsample along ``axis`` (half-pixel convention).

    Matches jax.image.resize(..., "bilinear", antialias=False) for a 2x
    target: out[2k] = 0.75*in[k] + 0.25*in[k-1], out[2k+1] = 0.75*in[k] +
    0.25*in[k+1], edges clamped.  Pure shifts + interleave, which fuse into
    one elementwise pass (resize's general-scale path is a gather-and-
    contract form).
    """
    lo = jnp.concatenate(
        [jax.lax.slice_in_dim(x, 0, 1, axis=axis), jax.lax.slice_in_dim(x, 0, -1, axis=axis)],
        axis=axis,
    )
    hi = jnp.concatenate(
        [jax.lax.slice_in_dim(x, 1, None, axis=axis), jax.lax.slice_in_dim(x, -1, None, axis=axis)],
        axis=axis,
    )
    even = 0.75 * x + 0.25 * lo
    odd = 0.75 * x + 0.25 * hi
    stacked = jnp.stack([even, odd], axis=axis + 1 if axis >= 0 else x.ndim + axis + 1)
    new_shape = list(x.shape)
    ax = axis if axis >= 0 else x.ndim + axis
    new_shape[ax] = 2 * new_shape[ax]
    return stacked.reshape(new_shape)


def upsample_flow(flow: jax.Array, shape: tuple[int, int]) -> jax.Array:
    """Resize (..., h, w, 2) flow to (..., H, W, 2) and scale values by H/h.

    Bilinear with the pixel-magnitude scaling the finer grid requires; for
    the exact 2x pyramid step this is a doubling, matching the visualizer's
    2^scale multiplier (main.cu:144-146).  The (near-)2x case — the only one
    the pyramid produces — runs the dedicated stencil upsampler (odd target
    dims get one edge-replicated row/column); other scales fall back to
    jax.image.resize.

    Grid convention, deliberately half-pixel: pyr_down centers coarse pixel
    k at fine 2k while this upsampler places it at fine 2k+0.5, so the
    coarse-to-fine seed carries a half-fine-pixel offset on spatially
    varying fields (uniform flow is unaffected).  Measured end to end
    (256x320 rotation field, levels=3): a 2k-aligned upsampler is NOT
    better — LK EPE 0.070 vs 0.063 for this form, FB identical at 0.014 —
    because the reference's own accumulation convention (flow[k] sampled at
    i >> s, main.cu:138-147) puts coarse k's footprint at fine [2k, 2k+1],
    whose center IS 2k+0.5; the per-level solve absorbs the residual either
    way.  Kept half-pixel; do not "fix" without re-measuring.
    """
    th, tw = shape
    h, w = flow.shape[-3:-1]
    if (th, tw) == (h, w):
        return flow
    if th in (2 * h, 2 * h + 1) and tw in (2 * w, 2 * w + 1):
        out = _up2x_axis(_up2x_axis(flow, -3), -2)
        if th == 2 * h + 1:
            out = jnp.concatenate([out, out[..., -1:, :, :]], axis=-3)
        if tw == 2 * w + 1:
            out = jnp.concatenate([out, out[..., :, -1:, :]], axis=-2)
        return out * jnp.asarray([2.0, 2.0], dtype=flow.dtype)
    scale = jnp.asarray([tw / w, th / h], dtype=flow.dtype)
    out = jax.image.resize(
        flow, flow.shape[:-3] + (th, tw, 2), method="bilinear", antialias=False
    )
    return out * scale


def downsample_flow(flow: jax.Array, shape: tuple[int, int]) -> jax.Array:
    """Resize (..., H, W, 2) flow DOWN to a coarser pyramid level's (h, w).

    The pyramid-step counterpart of :func:`upsample_flow` (not a strict
    inverse: the two use offset grid conventions — see upsample_flow — so a
    round trip shifts a spatially varying field by a quarter coarse pixel,
    immaterial for the warm-start seeding it serves):
    binomial blur + 2x decimation per octave (values halved per octave),
    per component through :func:`ops.pyramid.pyr_down` — the strided
    stencil the image pyramid itself uses.  ``shape`` must be reachable by
    floor-halving.  Border rows/cols dip toward zero (the decimation's zero
    padding), which is immaterial for its use as a warm-start seed.
    """
    from cuda_optical_flow_2_tpu.ops.pyramid import pyr_down

    th, tw = shape
    h, w = flow.shape[-3:-1]
    half = jnp.asarray(0.5, flow.dtype)
    while (h, w) != (th, tw):
        if h // 2 < th or w // 2 < tw:
            raise ValueError(
                f"{shape} is not a floor-halving of {flow.shape[-3:-1]}"
            )
        h, w = h // 2, w // 2
        flow = (
            jnp.stack(
                [pyr_down(flow[..., 0]), pyr_down(flow[..., 1])], axis=-1
            )
            * half
        )
    return flow


def upscale_nn(img: jax.Array, n: int) -> jax.Array:
    """Replicate each pixel into a 2^n x 2^n block (debug visualization).

    Twin of utils::upscale_1ch / upscale_3ch (OptFlowUtils.cpp:21-61); operates
    on (..., H, W) planes.
    """
    f = 1 << n
    out = jnp.repeat(img, f, axis=-2)
    return jnp.repeat(out, f, axis=-1)
