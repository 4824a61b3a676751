"""Fused LK residual kernel: gradients + windowed sums + 2x2 solve, one pass.

Replaces the composition G7 + G13 + G16 of the reference hot path
(OptFlowGpu.cu:1929-1964): where the reference launches 12 kernels with ~24
PCIe transfers per level, this computes the residual flow of a level in one
GPU kernel that reads the two frames once and writes only (u, v).  It is
written in Pallas for the Triton route (``backend="triton"``), so the same
kernel body runs in interpret mode on the CPU for the tests.

Design (one program per square output tile):

* The frames are zero-padded once in XLA by ``r + 1`` (window reach plus the
  3x3 gradient stencil) — zero padding IS the reference's boundary semantics
  (bounds-check-and-skip, OptFlowGpu.cu:1569-1586) — and far enough past the
  bottom/right edge that every load of every tile is in bounds.
* A program holds a ``G x G`` grid of gradient products (``G`` a power of
  two) whose central ``T = G - 2r`` square is its output tile; tiles step by
  ``T``, so neighbouring programs re-read a halo of ``r + 1`` from L2.
* Gradients come from nine shifted ``G x G`` loads of each frame (the 3x3
  masks are compile-time constants); products outside the image are zeroed.
* Each windowed sum is two matrix products with constant band matrices,
  ``S = B_h @ P @ B_w``: ``B_h[i, k] = taps[k - i]`` sums rows ``i .. i+2r``
  of ``P`` (the window centred on output row ``i``), ``B_w`` likewise along
  columns.  The products run on the tensor cores in TF32x3 (float32-level
  accuracy from three TF32 passes), which the determinant
  ``a*d - b^2`` needs: plain TF32 keeps ~3 decimal digits.
* The guarded 2x2 solve runs on the same tile; only (u, v) reach HBM.
"""

from __future__ import annotations

import functools

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

from cuda_optical_flow_2_tpu.config import LKConfig
from cuda_optical_flow_2_tpu.constants import MASKS
from cuda_optical_flow_2_tpu.ops.gradients import SOBEL_GAIN
from cuda_optical_flow_2_tpu.ops.window import window_weight_taps

__all__ = ["MAX_WINDOW", "lk_residual", "tile_side", "warps_for"]

# Largest window whose output tile is still a useful share of the 64-wide
# product grid (64 - 2*16 = 32).
MAX_WINDOW = 33

# Algorithm of the band-matrix products on the GPU.
_GPU_DOT = lax.DotAlgorithmPreset.TF32_TF32_F32_X3


def tile_side(window: int) -> int:
    """Side ``G`` of the product grid one program holds for ``window``."""
    return 32 if window <= 9 else 64


def warps_for(g: int, h: int, w: int) -> int:
    """Triton warps per program: 8 for 64-wide tiles on frames of 1 Mpx and
    more, else 4 (measured on the H100 at the PAPER_1080P and REFERENCE_GPU
    level shapes: 8 warps cut the 1080p level by a quarter and slowed the
    640x480 one; PERF.md)."""
    return 8 if g == 64 and h * w >= 1 << 20 else 4


def _band(g: int, taps: np.ndarray) -> np.ndarray:
    """(g, g) band matrix with ``B[i, i + d] = taps[d]`` for d in [0, 2r]."""
    b = np.zeros((g, g), np.float32)
    for d, c in enumerate(taps):
        idx = np.arange(g - d)
        b[idx, idx + d] = c
    return b


def _solve2x2(sum_ix2, sum_iy2, sum_ixiy, sum_ixit, sum_iyit, det_eps: float):
    """Guarded per-pixel 2x2 LK solve (ops/solve.py is the XLA twin).

    det_eps=0 reproduces the reference's raw 1/det (OptFlowGpu.cu:1835).
    """
    det = sum_ix2 * sum_iy2 - sum_ixiy * sum_ixiy
    if det_eps > 0.0:
        safe = jnp.abs(det) >= det_eps
        inv_det = 1.0 / jnp.where(safe, det, 1.0)
        u = jnp.where(safe, (-sum_iy2 * sum_ixit + sum_ixiy * sum_iyit) * inv_det, 0.0)
        v = jnp.where(safe, (sum_ixiy * sum_ixit - sum_ix2 * sum_iyit) * inv_det, 0.0)
    else:
        inv_det = 1.0 / det
        u = (-sum_iy2 * inv_det) * sum_ixit + (sum_ixiy * inv_det) * sum_iyit
        v = (sum_ixiy * inv_det) * sum_ixit - (sum_ix2 * inv_det) * sum_iyit
    return u, v


def _lk_kernel(
    x_ref,
    y_ref,
    bh_ref,
    bw_ref,
    u_ref,
    v_ref,
    *,
    g: int,
    t: int,
    r: int,
    img_h: int,
    img_w: int,
    sobel_x: np.ndarray,
    sobel_y: np.ndarray,
    temporal: np.ndarray,
    det_eps: float,
    centered: bool,
    precision,
):
    bi = pl.program_id(0)
    r0 = pl.program_id(1) * t
    c0 = pl.program_id(2) * t

    # Product-grid cell (i, j) is image pixel (r0 - r + i, c0 - r + j); its
    # 3x3 neighbour (a - 1, b - 1) sits at padded (r0 + i + a, c0 + j + b).
    def tap(ref, a, b):
        return ref[bi, pl.ds(r0 + a, g), pl.ds(c0 + b, g)]

    ix = iy = it = None
    for a in range(3):
        for b in range(3):
            cx, cy, ct = (float(m[a, b]) for m in (sobel_x, sobel_y, temporal))
            if cx == cy == ct == 0.0:
                continue
            p = tap(x_ref, a, b)
            if cx:
                ix = p * cx if ix is None else ix + p * cx
            if cy:
                iy = p * cy if iy is None else iy + p * cy
            if ct:
                d = (tap(y_ref, a, b) - p) * ct
                it = d if it is None else it + d

    rows = r0 - r + lax.broadcasted_iota(jnp.int32, (g, g), 0)
    cols = c0 - r + lax.broadcasted_iota(jnp.int32, (g, g), 1)
    inside = (rows >= 0) & (rows < img_h) & (cols >= 0) & (cols < img_w)
    # The reference's window sums see zero gradients outside the image.
    ix = jnp.where(inside, ix, 0.0)
    iy = jnp.where(inside, iy, 0.0)
    it = jnp.where(inside, it, 0.0)

    bh = bh_ref[...]
    bw = bw_ref[...]

    def win(p):
        rows_summed = lax.dot(bh, p, precision=precision,
                              preferred_element_type=jnp.float32)
        return lax.dot(rows_summed, bw, precision=precision,
                       preferred_element_type=jnp.float32)

    sums = [win(ix * ix), win(iy * iy), win(ix * iy), win(ix * it), win(iy * it)]
    if centered:
        # Mean-normalized (DIS-style) normal equations: every raw product
        # sum becomes the centered one, S_ab - S_a S_b / n, n = the window's
        # in-image pixel count (ops/window.centered_structure_tensor_sums
        # is the XLA twin).
        s_ix, s_iy, s_it = win(ix), win(iy), win(it)
        inv_n = 1.0 / jnp.maximum(win(jnp.where(inside, 1.0, 0.0)), 1.0)
        sums = [
            sums[0] - s_ix * s_ix * inv_n,
            sums[1] - s_iy * s_iy * inv_n,
            sums[2] - s_ix * s_iy * inv_n,
            sums[3] - s_ix * s_it * inv_n,
            sums[4] - s_iy * s_it * inv_n,
        ]
    u, v = _solve2x2(*sums, det_eps)

    keep = (lax.broadcasted_iota(jnp.int32, (g, g), 0) < t) & (
        lax.broadcasted_iota(jnp.int32, (g, g), 1) < t
    )
    plt.store(u_ref.at[bi, pl.ds(r0, g), pl.ds(c0, g)], u, mask=keep)
    plt.store(v_ref.at[bi, pl.ds(r0, g), pl.ds(c0, g)], v, mask=keep)


def lk_residual(
    prev: jax.Array,
    nxt: jax.Array,
    config: LKConfig,
    interpret: bool = False,
    centered: bool = False,
    tile: int | None = None,
    num_warps: int | None = None,
) -> jax.Array:
    """Residual flow between prev and (already warped) next, one fused kernel.

    Drop-in for models/lucas_kanade._lk_residual_xla; returns (..., H, W, 2)
    float32.  ``centered=True`` mean-normalizes the window sums (the
    DIS-style, illumination-offset-invariant data term — models/dis.py).
    ``interpret=True`` runs the kernel body on the CPU (tests).  ``tile``
    overrides :func:`tile_side` and ``num_warps`` :func:`warps_for` (the
    kernel study sweeps them; one pipeline stage measured as fast as two).
    """
    if config.window > MAX_WINDOW:
        raise ValueError(f"window {config.window} > {MAX_WINDOW}")
    lead = prev.shape[:-2]
    h, w = prev.shape[-2:]
    x = prev.reshape((-1, h, w)).astype(jnp.float32)
    y = nxt.reshape((-1, h, w)).astype(jnp.float32)
    bsz = x.shape[0]

    r = config.window // 2
    g = tile or tile_side(config.window)
    t = g - 2 * r
    nth, ntw = pl.cdiv(h, t), pl.cdiv(w, t)
    # Every tile loads rows [i*t, i*t + g + 2) of the padded frame and
    # stores rows [i*t, i*t + g) of the output (masked to its t x t tile).
    hp, wp = (nth - 1) * t + g + 2, (ntw - 1) * t + g + 2
    pad = ((0, 0), (r + 1, hp - h - r - 1), (r + 1, wp - w - r - 1))
    xp = jnp.pad(x, pad)
    yp = jnp.pad(y, pad)

    temporal = MASKS[config.temporal_kernel]
    sobel_scale = 1.0
    if config.normalize_gradients:
        temporal = temporal / temporal.sum()
        sobel_scale = 1.0 / SOBEL_GAIN
    taps = window_weight_taps(config.window, config.window_weights)
    band = _band(g, taps)

    kernel = functools.partial(
        _lk_kernel,
        g=g,
        t=t,
        r=r,
        img_h=h,
        img_w=w,
        sobel_x=MASKS["sobel_x"] * sobel_scale,
        sobel_y=MASKS["sobel_y"] * sobel_scale,
        temporal=temporal,
        det_eps=config.det_eps,
        centered=centered,
        # TF32x3 is a GPU tensor-core algorithm; the CPU interpreter
        # evaluates the same products in plain float32.
        precision=lax.Precision.HIGHEST if interpret else _GPU_DOT,
    )
    out_rows, out_cols = (nth - 1) * t + g, (ntw - 1) * t + g
    out = jax.ShapeDtypeStruct((bsz, out_rows, out_cols), jnp.float32)
    u, v = pl.pallas_call(
        kernel,
        grid=(bsz, nth, ntw),
        out_shape=(out, out),
        backend="triton",
        compiler_params=plt.CompilerParams(
            num_warps=num_warps or warps_for(g, h, w), num_stages=1
        ),
        interpret=interpret,
        name="lk_residual",
    )(xp, yp, jnp.asarray(band), jnp.asarray(band.T))
    flow = jnp.stack([u[:, :h, :w], v[:, :h, :w]], axis=-1)
    return flow.reshape(lead + (h, w, 2))
