"""2-D stencil convolutions over single-plane images.

Replacement for the reference's conv kernel family (G2-G8,
OptFlowGpu.cu:108-1191).  The reference ships six hand-tiled CUDA variants of
the same zero-padded correlation; here one XLA ``conv_general_dilated`` covers
them all, and the fused residual kernel (kernels/lk_fused.py) subsumes the
gradient convs on its path.  Every conv pins ``Precision.HIGHEST``: on the
GPU a float32 conv may otherwise run in TF32 (~3 decimal digits), and these
convs feed the LK determinant ``a*d - b^2``, which cancels badly.

All functions take planar images shaped ``(..., H, W)`` (any leading batch
dims) and perform *correlation* (no mask flip) with zero padding, matching the
reference's bounds-checked tap loops (e.g. OptFlowGpu.cu:1061-1084).
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax

__all__ = ["conv2d", "sep_conv2d", "stencil2d"]


def _as_batched(x: jax.Array) -> tuple[jax.Array, tuple[int, ...]]:
    """Collapse leading dims into one batch dim: (..., H, W) -> (B, H, W)."""
    lead = x.shape[:-2]
    h, w = x.shape[-2:]
    return x.reshape((-1, h, w)), lead


def conv2d(x: jax.Array, mask, *, dtype=None) -> jax.Array:
    """Zero-padded 2-D correlation of a planar image with a small mask.

    Args:
      x: image(s), shape (..., H, W).
      mask: 2-D stencil (kh, kw) — NumPy array or nested list; baked into the
        jitted program as a constant (the reference keeps it in
        ``__constant__ float mask[25]``, OptFlowGpu.cu:190).
      dtype: accumulation/output dtype; defaults to x.dtype (floating) or
        float32 for integer inputs.

    Returns: same spatial shape as ``x``.
    """
    mask = np.asarray(mask)
    if mask.ndim != 2:
        raise ValueError(f"mask must be 2-D, got shape {mask.shape}")
    if dtype is None:
        dtype = x.dtype if jnp.issubdtype(x.dtype, jnp.floating) else jnp.float32
    xb, lead = _as_batched(x.astype(dtype))
    kh, kw = mask.shape
    kernel = jnp.asarray(mask, dtype=dtype).reshape(1, 1, kh, kw)
    out = lax.conv_general_dilated(
        xb[:, None],  # (B, 1, H, W)
        kernel,
        window_strides=(1, 1),
        padding=((kh // 2, (kh - 1) // 2), (kw // 2, (kw - 1) // 2)),
        dimension_numbers=("NCHW", "OIHW", "NCHW"),
        precision=lax.Precision.HIGHEST,
    )
    return out[:, 0].reshape(lead + x.shape[-2:])


def sep_conv2d(x: jax.Array, col, row, *, dtype=None) -> jax.Array:
    """Separable zero-padded correlation: rank-1 mask = col (x) row.

    Two 1-D passes instead of a dense kh*kw loop (the box window sums and
    other separable masks).
    """
    col = np.asarray(col).reshape(-1)
    row = np.asarray(row).reshape(-1)
    if dtype is None:
        dtype = x.dtype if jnp.issubdtype(x.dtype, jnp.floating) else jnp.float32
    xb, lead = _as_batched(x.astype(dtype))
    kh, kw = col.size, row.size
    kcol = jnp.asarray(col, dtype=dtype).reshape(1, 1, kh, 1)
    krow = jnp.asarray(row, dtype=dtype).reshape(1, 1, 1, kw)
    out = lax.conv_general_dilated(
        xb[:, None],
        kcol,
        window_strides=(1, 1),
        padding=((kh // 2, (kh - 1) // 2), (0, 0)),
        dimension_numbers=("NCHW", "OIHW", "NCHW"),
        precision=lax.Precision.HIGHEST,
    )
    out = lax.conv_general_dilated(
        out,
        krow,
        window_strides=(1, 1),
        padding=((0, 0), (kw // 2, (kw - 1) // 2)),
        dimension_numbers=("NCHW", "OIHW", "NCHW"),
        precision=lax.Precision.HIGHEST,
    )
    return out[:, 0].reshape(lead + x.shape[-2:])


def stencil2d(x: jax.Array, mask, *, dtype=None) -> jax.Array:
    """Shift-form zero-padded 2-D correlation (conv2d twin).

    Same semantics as :func:`conv2d` (correlation, zero pad, same shape)
    computed as a sum of statically shifted copies — pad + slice + FMA per
    nonzero tap — instead of ``lax.conv_general_dilated``, so XLA fuses it
    with the surrounding elementwise work (the DIS refinement and the
    robust relaxation use it).
    """
    mask = np.asarray(mask)
    if mask.ndim != 2:
        raise ValueError(f"mask must be 2-D, got shape {mask.shape}")
    if dtype is None:
        dtype = x.dtype if jnp.issubdtype(x.dtype, jnp.floating) else jnp.float32
    kh, kw = mask.shape
    ph_t, ph_b = kh // 2, (kh - 1) // 2
    pw_l, pw_r = kw // 2, (kw - 1) // 2
    x = x.astype(dtype)
    h, w = x.shape[-2:]
    pad = [(0, 0)] * (x.ndim - 2) + [(ph_t, ph_b), (pw_l, pw_r)]
    xp = jnp.pad(x, pad)
    out = jnp.zeros_like(x)
    for i in range(kh):
        for j in range(kw):
            tap = float(mask[i, j])
            if tap == 0.0:
                continue
            sl = xp[..., i : i + h, j : j + w]
            out = out + tap * sl
    return out
