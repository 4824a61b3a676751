"""Backward image warping by a flow field.

Replacement for the *intent* of cpu::shift_back_pyramid
(OptFlowCPU.cpp:241-282): sample the next frame at ``x + flow(x)`` so that the
residual motion left for the current level is small.  The reference's
implementation is nearest-neighbor and carries an indexing bug that samples
the coarser flow at pixel (0, 0) only (OptFlowCPU.cpp:260-261, documented in
SURVEY.md section 2.2 C9); the bilinear production warp here implements the
documented intent (BASELINE config 3 demands bilinear warping).

Out-of-bounds samples keep the unwarped pixel value, matching the reference's
``continue`` on out-of-range coordinates (OptFlowCPU.cpp:270-273).

Implementation note: the gather is expressed with ``jnp.take`` on a
flattened image, which XLA lowers to a single dynamic gather (no texture
units are used).  Coordinates are clamped so every lane stays in bounds and the
out-of-bounds mask selects the fallback afterwards.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

__all__ = ["warp_bilinear", "warp_bilinear_band", "warp_nearest"]


def _gather_2d(img: jax.Array, yi: jax.Array, xi: jax.Array) -> jax.Array:
    """img (..., H, W) indexed at integer maps yi, xi (index maps may have
    fewer rows than ``img`` — used by the band warp)."""
    h, w = img.shape[-2:]
    flat = img.reshape(img.shape[:-2] + (h * w,))
    idx = yi * w + xi
    n = idx.shape[-2] * idx.shape[-1]
    out = jnp.take_along_axis(
        flat, idx.reshape(idx.shape[:-2] + (n,)), axis=-1
    )
    return out.reshape(idx.shape)


def _coords(img: jax.Array) -> tuple[jax.Array, jax.Array]:
    h, w = img.shape[-2:]
    ys = jax.lax.broadcasted_iota(jnp.float32, (h, w), 0)
    xs = jax.lax.broadcasted_iota(jnp.float32, (h, w), 1)
    return ys, xs


def warp_bilinear(img: jax.Array, flow: jax.Array) -> jax.Array:
    """Bilinear backward warp: out(x) = img(x + flow(x)).

    Args:
      img: (..., H, W) float image.
      flow: (..., H, W, 2) flow in pixels, channel 0 = u (x), 1 = v (y).
    """
    h, w = img.shape[-2:]
    ys, xs = _coords(img)
    fx = xs + flow[..., 0]
    fy = ys + flow[..., 1]
    valid = (fx >= 0) & (fx <= w - 1) & (fy >= 0) & (fy <= h - 1)

    fx_c = jnp.clip(fx, 0.0, w - 1)
    fy_c = jnp.clip(fy, 0.0, h - 1)
    x0 = jnp.floor(fx_c)
    y0 = jnp.floor(fy_c)
    tx = fx_c - x0
    ty = fy_c - y0
    x0i = x0.astype(jnp.int32)
    y0i = y0.astype(jnp.int32)
    x1i = jnp.minimum(x0i + 1, w - 1)
    y1i = jnp.minimum(y0i + 1, h - 1)

    v00 = _gather_2d(img, y0i, x0i)
    v01 = _gather_2d(img, y0i, x1i)
    v10 = _gather_2d(img, y1i, x0i)
    v11 = _gather_2d(img, y1i, x1i)
    top = v00 + tx * (v01 - v00)
    bot = v10 + tx * (v11 - v10)
    out = top + ty * (bot - top)
    return jnp.where(valid, out, img)


def warp_bilinear_band(
    img: jax.Array,
    flow: jax.Array,
    img_row0,
    out_row0,
    h_global: int,
) -> jax.Array:
    """Bilinear backward warp of a horizontal band of a taller global image.

    The building block of the spatially-sharded pipeline (parallel/spatial.py):
    ``img`` holds global rows [img_row0, img_row0 + img.shape[-2]) of an
    ``h_global``-row image, ``flow`` covers output rows
    [out_row0, out_row0 + flow.shape[-3]).  Sample validity is judged against
    the GLOBAL image bounds — so out-of-image samples fall back to the
    unwarped pixel exactly like :func:`warp_bilinear` on the full image —
    while gathers stay inside the band.  The caller must provide enough band
    overhang that every globally-valid sample lands inside ``img``
    (|v| <= img overhang beyond the output rows, minus 1 for the bilinear
    neighbor).  With img_row0 = out_row0 = 0 and h_global = img rows this is
    exactly :func:`warp_bilinear`.  Row origins may be traced scalars.
    """
    hi, w = img.shape[-2:]
    hf = flow.shape[-3]
    ys = jax.lax.broadcasted_iota(jnp.float32, (hf, w), 0)
    xs = jax.lax.broadcasted_iota(jnp.float32, (hf, w), 1)
    fx = xs + flow[..., 0]
    fy_g = ys + out_row0 + flow[..., 1]
    valid = (fx >= 0) & (fx <= w - 1) & (fy_g >= 0) & (fy_g <= h_global - 1)

    fx_c = jnp.clip(fx, 0.0, w - 1)
    # Floor and fraction in GLOBAL row coordinates, indices shifted to the
    # band by integer arithmetic: subtracting img_row0 from the float
    # coordinate first would re-round the fraction (float32 ulps scale with
    # the global row index), perturbing the bilinear weights vs
    # warp_bilinear by up to ~1e-5 — enough to move the sharded pipeline's
    # solve output by ~1e-3.  This form is bit-identical to the unsharded
    # warp for identical flow.
    fy_c = jnp.clip(fy_g, 0.0, h_global - 1)
    x0 = jnp.floor(fx_c)
    y0 = jnp.floor(fy_c)
    tx = fx_c - x0
    ty = fy_c - y0
    row0_i = jnp.asarray(img_row0, jnp.int32)
    x0i = x0.astype(jnp.int32)
    y0i = y0.astype(jnp.int32) - row0_i
    x1i = jnp.minimum(x0i + 1, w - 1)
    y1i = jnp.minimum(y0.astype(jnp.int32) + 1, h_global - 1) - row0_i

    v00 = _gather_2d(img, y0i, x0i)
    v01 = _gather_2d(img, y0i, x1i)
    v10 = _gather_2d(img, y1i, x0i)
    v11 = _gather_2d(img, y1i, x1i)
    top = v00 + tx * (v01 - v00)
    bot = v10 + tx * (v11 - v10)
    out = top + ty * (bot - top)
    # Fallback: the band's own pixels at the output rows.
    start = jnp.asarray(out_row0 - img_row0, jnp.int32)
    own = jax.lax.dynamic_slice_in_dim(img, start, hf, axis=-2)
    return jnp.where(valid, out, own)


def warp_nearest(img: jax.Array, flow: jax.Array) -> jax.Array:
    """Nearest-neighbor backward warp with C trunc-toward-zero coordinates.

    Matches the reference warp's sampling rule (``int new_pos_x = j + u``
    truncates toward zero, OptFlowCPU.cpp:268-269) given a per-pixel flow;
    out-of-bounds keeps the unwarped pixel.
    """
    h, w = img.shape[-2:]
    ys, xs = _coords(img)
    fx = jnp.trunc(xs + flow[..., 0])
    fy = jnp.trunc(ys + flow[..., 1])
    valid = (fx >= 0) & (fx < w) & (fy >= 0) & (fy < h)
    xi = jnp.clip(fx, 0, w - 1).astype(jnp.int32)
    yi = jnp.clip(fy, 0, h - 1).astype(jnp.int32)
    out = _gather_2d(img, yi, xi)
    return jnp.where(valid, out, img)
