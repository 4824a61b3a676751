"""Closed-form 2x2 Lucas-Kanade solve.

Replacement for G16 (g_inv_matrix_float, OptFlowGpu.cu:1819-1846).
Per pixel, with A = [[sumIx2, sumIxIy], [sumIxIy, sumIy2]] and
b = [sumIxIt, sumIyIt], the flow is d = -A^-1 b:

    u = (-sumIy2 * sumIxIt + sumIxIy * sumIyIt) / det
    v = ( sumIxIy * sumIxIt - sumIx2 * sumIyIt) / det

The reference divides by the raw determinant in double precision with no
det==0 guard (OptFlowGpu.cu:1831-1845); the production solve stays in
float32 (the fused kernel's and the XLA twin's) and adds the |det| < eps -> (0, 0) guard
(a documented deviation, SURVEY.md section 5 "failure detection").  The
unguarded variant reproduces the reference's inf/nan propagation for the
compat tests.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

__all__ = ["solve_2x2", "solve_2x2_unguarded"]


def solve_2x2(
    sum_ix2: jax.Array,
    sum_iy2: jax.Array,
    sum_ixiy: jax.Array,
    sum_ixit: jax.Array,
    sum_iyit: jax.Array,
    eps: float = 1e-8,
) -> jax.Array:
    """Guarded LK solve -> flow (..., 2); (0, 0) where |det| < eps."""
    det = sum_ix2 * sum_iy2 - sum_ixiy * sum_ixiy
    safe = jnp.abs(det) >= eps
    inv_det = jnp.where(safe, det, jnp.ones_like(det))
    inv_det = 1.0 / inv_det
    u = (-sum_iy2 * sum_ixit + sum_ixiy * sum_iyit) * inv_det
    v = (sum_ixiy * sum_ixit - sum_ix2 * sum_iyit) * inv_det
    zero = jnp.zeros_like(u)
    return jnp.stack([jnp.where(safe, u, zero), jnp.where(safe, v, zero)], axis=-1)


def solve_2x2_unguarded(
    sum_ix2: jax.Array,
    sum_iy2: jax.Array,
    sum_ixiy: jax.Array,
    sum_ixit: jax.Array,
    sum_iyit: jax.Array,
) -> jax.Array:
    """Reference-exact solve: raw 1/det, inf/nan pass through (compat mode)."""
    det = sum_ix2 * sum_iy2 - sum_ixiy * sum_ixiy
    inv_det = 1.0 / det
    u = (-sum_iy2 * inv_det) * sum_ixit + (sum_ixiy * inv_det) * sum_iyit
    v = (sum_ixiy * inv_det) * sum_ixit - (sum_ix2 * inv_det) * sum_iyit
    return jnp.stack([u, v], axis=-1)
