"""Quadratic polynomial expansion (Farnebäck 2003) — basis of the FB model.

Approximates each pixel's neighborhood as f(o) ~ o^T A o + b^T o + c over
local offsets o = (x, y), weighted by a Gaussian applicability w = g(y)g(x).
With spatially invariant applicability the weighted least-squares solution is

    r = G^{-1} v,   G = B^T W B (6x6 constant),   v = B^T W f (per pixel),

and every component of v is a separable correlation of f with {g, g*o, g*o^2}
along each axis (basis (1, x, y, x^2, y^2, xy) separates; Farnebäck 2003
section 3.3).  NOT in the reference (Kr-Stam/CUDA_Optical_Flow_2 implements
Lucas-Kanade only); provided for the Farnebäck model family extension.

Formulation: the six correlations are static shifted adds (pad-and-slice)
that XLA fuses into a handful of bandwidth-bound passes.  G is inverted in NumPy at trace time and baked in as
constants; boundary semantics are zero-padded f with the interior G
(constant-certainty expansion), matching the NumPy oracle in the tests.
"""

from __future__ import annotations

import functools

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax

__all__ = ["gaussian_1d", "mixing_matrix", "poly_expansion"]


def gaussian_1d(n: int, sigma: float) -> np.ndarray:
    """Normalized odd-length Gaussian applicability factor."""
    if n % 2 != 1 or n < 3:
        raise ValueError(f"poly_n must be odd and >= 3, got {n}")
    o = np.arange(n, dtype=np.float64) - n // 2
    g = np.exp(-(o * o) / (2.0 * sigma * sigma))
    return (g / g.sum()).astype(np.float64)


@functools.lru_cache(maxsize=32)
def mixing_matrix(n: int, sigma: float) -> np.ndarray:
    """Rows 1..5 of G^{-1}: maps v = (m00, m10, m01, m20, m02, m11) to the
    coefficients (bx, by, axx, ayy, axy*2) in basis order (x, y, x^2, y^2, xy)."""
    g = gaussian_1d(n, sigma)
    o = np.arange(n, dtype=np.float64) - n // 2
    yy, xx = np.meshgrid(o, o, indexing="ij")
    w = np.outer(g, g)
    basis = np.stack(
        [np.ones_like(xx), xx, yy, xx * xx, yy * yy, xx * yy], axis=-1
    )  # (n, n, 6)
    G = np.einsum("yx,yxk,yxl->kl", w, basis, basis)
    return np.linalg.inv(G)[1:6, :]  # (5, 6); row order (x, y, x^2, y^2, xy)


def _corr1d(x: jax.Array, k: np.ndarray, axis: int) -> jax.Array:
    """Zero-padded 1-D correlation: out[i] = sum_j k[j] x[i + j - r].

    Static pad-and-slice shifts (the _avg3x3 pattern from models/horn_schunck)
    so XLA fuses the taps with the surrounding arithmetic.
    """
    n = k.size
    r = n // 2
    size = x.shape[axis]
    pad = [(0, 0)] * x.ndim
    pad[axis] = (r, r)
    xp = jnp.pad(x, pad)
    acc = None
    for j in range(n):
        c = float(k[j])
        if c == 0.0:
            continue
        piece = lax.slice_in_dim(xp, j, j + size, axis=axis) * jnp.asarray(
            c, x.dtype
        )
        acc = piece if acc is None else acc + piece
    return acc


def poly_expansion(
    f: jax.Array, n: int = 7, sigma: float = 1.5
) -> tuple[jax.Array, jax.Array, jax.Array, jax.Array, jax.Array]:
    """Per-pixel quadratic expansion of (..., H, W) -> (bx, by, axx, ayy, axy).

    f(o) ~ o^T [[axx, axy], [axy, ayy]] o + (bx, by)^T o + c with o = (x, y)
    in (column, row) offsets — matching the codebase's flow convention
    (flow[..., 0] = u along width).  The constant term c is not returned
    (the displacement solve never uses it).
    """
    if not jnp.issubdtype(f.dtype, jnp.floating):
        f = f.astype(jnp.float32)
    g = gaussian_1d(n, sigma)
    o = np.arange(n, dtype=np.float64) - n // 2
    g1, g2 = g * o, g * o * o

    # Row-axis (y) passes shared across the column-axis (x) taps.
    ty0 = _corr1d(f, g, -2)
    ty1 = _corr1d(f, g1, -2)
    ty2 = _corr1d(f, g2, -2)
    v = (
        _corr1d(ty0, g, -1),   # m00:  1
        _corr1d(ty0, g1, -1),  # m10:  x
        _corr1d(ty1, g, -1),   # m01:  y
        _corr1d(ty0, g2, -1),  # m20:  x^2
        _corr1d(ty2, g, -1),   # m02:  y^2
        _corr1d(ty1, g1, -1),  # m11:  xy
    )

    m = mixing_matrix(n, float(sigma))
    out = []
    for k in range(5):
        acc = None
        for l in range(6):
            c = float(m[k, l])
            if abs(c) < 1e-15:
                continue
            piece = v[l] * jnp.asarray(c, f.dtype)
            acc = piece if acc is None else acc + piece
        out.append(acc)
    bx, by, axx, ayy, axy2 = out
    return bx, by, axx, ayy, axy2 * jnp.asarray(0.5, f.dtype)
