"""Grayscale conversion.

Replacement for G1 (g_grayscale_avg_2d, OptFlowGpu.cu:48-60).  The
reference keeps the gray value replicated across 3 interleaved uchar channels
for the whole pipeline; here the boundary op produces a single planar float32
channel once, and everything downstream is 1-channel (SURVEY.md section 7,
"uint8->float ingestion").
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

__all__ = ["grayscale", "grayscale_u8"]


def grayscale(rgb: jax.Array, dtype=jnp.float32) -> jax.Array:
    """(..., H, W, 3) uint8/float -> (..., H, W) float average of R, G, B.

    Production profile: true float mean (no integer truncation).
    """
    x = rgb.astype(dtype)
    return (x[..., 0] + x[..., 1] + x[..., 2]) * (1.0 / 3.0)


def grayscale_u8(rgb: jax.Array) -> jax.Array:
    """Exact-compat grayscale: integer (r+g+b)/3 with C truncating division.

    Matches cpu::grayscale_avg_cpu (OptFlowCPU.cpp:19-31) / g_grayscale_avg_2d
    (OptFlowGpu.cu:48-60) bit-exactly; returns (..., H, W) uint8.
    """
    s = rgb.astype(jnp.int32)
    avg = (s[..., 0] + s[..., 1] + s[..., 2]) // 3
    return avg.astype(jnp.uint8)
