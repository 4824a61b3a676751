"""Windowed structure-tensor sums ("srm" in the reference).

Replacement for G13 (g_srm_1ch_float, OptFlowGpu.cu:1549-1625) and
its int twin cpu::srm_1ch (OptFlowCPU.cpp:162-200).  The reference evaluates
the full ww*wh tap loop per pixel (19x19 -> 361 MACs/pixel, five times); a box
window is separable, so every backend here is O(window) or O(1) per pixel:

* "sep_conv":      two 1-D all-ones convolutions (default — robust fp32
                   accumulation, XLA fuses the surrounding elementwise work).
* "cumsum":        integral image (cumsum + shifted differences) — O(1)/pixel;
                   exact for integer dtypes, but fp32 suffers cancellation on
                   large images, so it is the default only for int paths.
* "reduce_window": lax.reduce_window with an add monoid (XLA's native form).

Zero padding outside the image matches the reference's bounds-check-and-skip.
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax

from cuda_optical_flow_2_tpu.ops.conv import sep_conv2d

__all__ = [
    "window_sum",
    "window_weight_taps",
    "structure_tensor_sums",
    "centered_structure_tensor_sums",
]


def window_weight_taps(window: int, weights: str) -> np.ndarray:
    """1-D window weight taps, scaled so each axis sums to ``window``.

    The scaling keeps the 2-D total weight at ``window**2`` — the same
    scale as the flat box sum — so ``det_eps`` thresholds and any
    magnitude-sensitive downstream use carry over unchanged between
    weightings.

    * "box":   all-ones (the reference's flat window).
    * "tri":   trapezoid = convolution of two odd boxes of radii
               ``r//2`` and ``r - r//2`` (support = window).  Its transfer
               function is a product of two sincs with interleaved zeros —
               min -0.01 vs the box's -0.22.
    * "gauss": truncated Gaussian, sigma = window/6 (support = window).
    """
    if weights == "box":
        return np.ones((window,), np.float32)
    r = window // 2
    if weights == "tri":
        r1, r2 = r // 2, r - r // 2
        t = np.convolve(np.ones(2 * r1 + 1), np.ones(2 * r2 + 1))
    elif weights == "gauss":
        x = np.arange(window) - r
        t = np.exp(-0.5 * (x / (window / 6.0)) ** 2)
    else:
        raise ValueError(f"unknown window_weights {weights!r}")
    return (t * (window / t.sum())).astype(np.float32)


def _window_sum_cumsum(x: jax.Array, window: int) -> jax.Array:
    """Integral-image box sum with zero padding; exact for integer dtypes."""
    r = window // 2
    h, w = x.shape[-2:]
    # Integral image with a leading zero row/col: ii[i, j] = sum(x[:i, :j]).
    ii = jnp.cumsum(jnp.cumsum(x, axis=-2, dtype=x.dtype), axis=-1, dtype=x.dtype)
    pad = [(0, 0)] * (x.ndim - 2) + [(1, 0), (1, 0)]
    ii = jnp.pad(ii, pad)

    def corner(dy: int, dx: int) -> jax.Array:
        ys = np.clip(np.arange(h) + dy, 0, h)
        xs = np.clip(np.arange(w) + dx, 0, w)
        return ii[..., ys, :][..., :, xs]

    # sum over [i-r, i+r] x [j-r, j+r] clipped to the image.
    return (
        corner(r + 1, r + 1) - corner(-r, r + 1) - corner(r + 1, -r) + corner(-r, -r)
    )


def window_sum(
    x: jax.Array, window: int, method: str = "sep_conv", weights: str = "box"
) -> jax.Array:
    """Sum of ``x`` over the window x window box centered at each pixel.

    Zero contribution outside the image (reference: OptFlowGpu.cu:1569-1586
    skips out-of-bounds taps).  ``window`` must be odd.

    ``weights`` != "box" applies the separable :func:`window_weight_taps`
    weighting (always via the sep_conv path — weighted sums are not
    box-decomposable, so ``method`` is ignored for them).
    """
    if window % 2 != 1:
        raise ValueError(f"window must be odd, got {window}")
    if weights != "box":
        taps = window_weight_taps(window, weights)
        return sep_conv2d(x, taps, taps)
    if method == "sep_conv":
        ones = np.ones((window,), dtype=np.float32)
        return sep_conv2d(x, ones, ones)
    if method == "cumsum":
        return _window_sum_cumsum(x, window)
    if method == "reduce_window":
        r = window // 2
        lead = x.ndim - 2
        return lax.reduce_window(
            x,
            jnp.zeros((), x.dtype),
            lax.add,
            window_dimensions=(1,) * lead + (window, window),
            window_strides=(1,) * (lead + 2),
            padding=((0, 0),) * lead + ((r, r), (r, r)),
        )
    raise ValueError(f"unknown window_sum method {method!r}")


def structure_tensor_sums(
    ix: jax.Array,
    iy: jax.Array,
    it: jax.Array,
    window: int,
    method: str = "sep_conv",
    weights: str = "box",
) -> tuple[jax.Array, jax.Array, jax.Array, jax.Array, jax.Array]:
    """The five windowed product sums of the LK normal equations.

    Replaces the reference's five separate srm_1ch_float launches
    (OptFlowGpu.cu:1948-1960) with one fused, stacked window reduction: the
    products are stacked on a leading axis so XLA runs a single windowed sum
    over a (5, H, W) array.  ``weights`` selects the window weighting
    (LKConfig.window_weights — "box" is the reference's flat sum).

    Returns (sum_ix2, sum_iy2, sum_ixiy, sum_ixit, sum_iyit).
    """
    prods = jnp.stack([ix * ix, iy * iy, ix * iy, ix * it, iy * it])
    sums = window_sum(prods, window, method, weights)
    return sums[0], sums[1], sums[2], sums[3], sums[4]


def centered_structure_tensor_sums(
    ix: jax.Array,
    iy: jax.Array,
    it: jax.Array,
    window: int,
    method: str = "sep_conv",
    valid: jax.Array | None = None,
    weights: str = "box",
) -> tuple[jax.Array, jax.Array, jax.Array, jax.Array, jax.Array]:
    """Mean-normalized ("centered") LK normal-equation sums.

    The DIS-style data term (Kroeger et al. 2016, §3 "mean-normalized sum of
    squared differences") subtracts each window's intensity mean from both
    the template and the warped patch, which cancels additive illumination
    changes between frames.  The Gauss-Newton normal equations of that
    residual replace every raw product sum with the centered one:

        Σ_W (a - ā)(b - b̄)  =  S_ab - S_a · S_b / n

    where ``n`` is the number of in-image pixels in the window (windows are
    zero-padded outside the image like :func:`window_sum`, so border windows
    center over their real pixels only).  The centered Hessian is a
    covariance matrix — positive semi-definite, so the usual ``det`` guard
    semantics carry over.

    ``valid`` (optional, same shape) marks the pixels the count plane may
    include — the spatial-TP band path passes the in-GLOBAL-image mask so a
    shard's zero halo rows (whose gradients are zeroed but which lie inside
    the band) don't inflate ``n`` (the fused kernel's ``inside`` mask is the
    same correction).

    Returns (sum_ix2, sum_iy2, sum_ixiy, sum_ixit, sum_iyit), centered —
    drop-in for :func:`structure_tensor_sums` ahead of the 2x2 solve.
    """
    ones = jnp.ones_like(ix) if valid is None else valid.astype(ix.dtype)
    planes = jnp.stack(
        [ix * ix, iy * iy, ix * iy, ix * it, iy * it, ix, iy, it, ones]
    )
    s = window_sum(planes, window, method, weights)
    inv_n = 1.0 / jnp.maximum(s[8], 1.0)
    g11 = s[0] - s[5] * s[5] * inv_n
    g22 = s[1] - s[6] * s[6] * inv_n
    g12 = s[2] - s[5] * s[6] * inv_n
    b1 = s[3] - s[5] * s[7] * inv_n
    b2 = s[4] - s[6] * s[7] * inv_n
    return g11, g22, g12, b1, b2
