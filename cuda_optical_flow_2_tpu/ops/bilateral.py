"""Joint bilateral pre-filter.

Replacement for G18 (g_bilinear_filter, OptFlowGpu.cu:1984-2083 —
named "bilinear" in the reference but actually a joint bilateral filter): for
each pixel, a spatial Gaussian (runtime-generated mask) times a range Gaussian
on the guide intensity, normalized by the total weight.

The reference evaluates double-precision ``pow(M_E, ...)`` per tap per pixel;
the production filter runs float32 with ``exp`` (float64 costs many times
the float32 rate on most GPUs).  The tap loop is unrolled at trace time (window is a
static config value): each tap is a static 2-D shift, so XLA fuses the whole
filter into one elementwise loop over shifted copies — no gathers.

The constant ``1/(2*pi*sigmaB^2)`` range normalization appears in both the
numerator and denominator and cancels; it is kept for parity with the
reference formula (OptFlowGpu.cu:2030).
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

from cuda_optical_flow_2_tpu.constants import generate_gaussian_kernel

__all__ = ["bilateral_filter", "bilateral_filter_band"]


def _shift2d(
    x: jax.Array, dy: int, dx: int, row0=0, h_global: int | None = None
) -> tuple[jax.Array, jax.Array]:
    """Zero-padded static shift; returns (shifted, in_bounds_mask).

    ``row0``/``h_global`` express the rows in GLOBAL image coordinates for
    the banded (spatial-TP) variant; the default treats the array as the
    whole image."""
    h, w = x.shape[-2:]
    hg = h if h_global is None else h_global
    out = jnp.roll(x, shift=(-dy, -dx), axis=(-2, -1))
    ys = jax.lax.broadcasted_iota(jnp.int32, (h, w), 0) + row0
    xs = jax.lax.broadcasted_iota(jnp.int32, (h, w), 1)
    mask = (ys + dy >= 0) & (ys + dy < hg) & (xs + dx >= 0) & (xs + dx < w)
    return out, mask


def _tap_loop(
    img: jax.Array,
    guide: jax.Array,
    window: int,
    sigma_spatial: float,
    sigma_range: float,
    row0=0,
    h_global: int | None = None,
) -> jax.Array:
    spatial = generate_gaussian_kernel(sigma_spatial, window).astype(np.float32)
    wh, ww = spatial.shape
    hwh, hww = wh >> 1, ww >> 1
    sigma_b2 = float(sigma_range) ** 2
    range_norm = np.float32(1.0 / (2.0 * np.pi * sigma_b2))
    inv_2s2 = np.float32(0.5 / sigma_b2)

    img = img.astype(jnp.float32)
    guide = guide.astype(jnp.float32)
    num = jnp.zeros_like(img)
    den = jnp.zeros_like(img)
    for m in range(wh):
        for n in range(ww):
            dy, dx = m - hwh, n - hww
            g_s, mask = _shift2d(guide, dy, dx, row0, h_global)
            i_s, _ = _shift2d(img, dy, dx, row0, h_global)
            k = g_s - guide
            wgt = range_norm * jnp.exp(-(k * k) * inv_2s2) * np.float32(spatial[m, n])
            wgt = jnp.where(mask, wgt, 0.0)
            num = num + i_s * wgt
            den = den + wgt
    return num / den


def bilateral_filter(
    img: jax.Array,
    guide: jax.Array | None = None,
    window: int = 9,
    sigma_spatial: float = 2.0,
    sigma_range: float = 10.0,
) -> jax.Array:
    """Edge-preserving smoothing of (..., H, W) float images.

    Defaults are the reference's live operating point (main.cu:240: ww=wh=9,
    sigmaS=2, sigmaB=10).  ``guide`` defaults to ``img`` (self-guided), which
    is how the reference calls it (gray guides gray).
    """
    if guide is None:
        guide = img
    return _tap_loop(img, guide, window, sigma_spatial, sigma_range)


def bilateral_filter_band(
    img_band: jax.Array,
    row0,
    h_global: int,
    window: int = 9,
    sigma_spatial: float = 2.0,
    sigma_range: float = 10.0,
) -> jax.Array:
    """Self-guided bilateral on a row BAND of an ``h_global``-row image.

    The spatial-TP shard-local form: ``row0`` is the (traced) global row of
    band row 0, so out-of-image tap masking acts on the GLOBAL image.  Rows
    at least ``window // 2`` from the band edges (where the caller's halo
    exchange supplies real neighbor rows) match the whole-image filter
    float-for-float; band-edge rows read rolled-around values and must be
    cropped by the caller.
    """
    return _tap_loop(
        img_band, img_band, window, sigma_spatial, sigma_range, row0, h_global
    )
