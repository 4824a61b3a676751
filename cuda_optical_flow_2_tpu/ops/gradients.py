"""Spatial and temporal image gradients (Ix, Iy, It).

Replacement for the reference's STEP 1 (OptFlowGpu.cu:1929-1940):
Ix/Iy are Sobel correlations of the previous frame; It is the difference of a
temporal smoothing correlation applied to both frames ("dt3" = the GPU path's
unnormalized Dt_3x3, kernels.cpp:20-24; "gauss3" = the CPU path's binomial,
OptFlowCPU.cpp:336-338).  The elementwise subtraction the reference performs
on the host (utils::arr_sub_float, OptFlowUtils.hpp:21-31) is fused here.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from cuda_optical_flow_2_tpu.constants import MASKS
from cuda_optical_flow_2_tpu.ops.conv import conv2d

__all__ = ["spatial_gradients", "temporal_gradient"]


def _float_dtype(x: jax.Array):
    return x.dtype if jnp.issubdtype(x.dtype, jnp.floating) else jnp.float32


# Gain of a derivative stencil on a unit ramp (Sobel: (1+2+1)*(1+1) = 8).
SOBEL_GAIN = 8.0


def spatial_gradients(
    prev: jax.Array, normalize: bool = True
) -> tuple[jax.Array, jax.Array]:
    """Sobel Ix, Iy of the previous frame (OptFlowGpu.cu:1930-1933).

    ``normalize`` divides by the Sobel ramp gain (8) so Ix approximates the
    true spatial derivative; the reference keeps the raw gain, biasing flow
    magnitudes (see LKConfig.normalize_gradients).
    """
    scale = 1.0 / SOBEL_GAIN if normalize else 1.0
    ix = conv2d(prev, MASKS["sobel_x"] * scale)
    iy = conv2d(prev, MASKS["sobel_y"] * scale)
    return ix, iy


def temporal_gradient(
    prev: jax.Array, nxt: jax.Array, kernel: str = "dt3", normalize: bool = True
) -> jax.Array:
    """It = K(x)next - K(x)prev (OptFlowGpu.cu:1936-1940).

    Computed as K(x)(next - prev) — the correlation is linear — which halves
    the stencil work.  ``normalize`` scales the smoothing mask to unit sum
    (Dt_3x3 sums to 15; gauss3 already sums to 1).  Float path only (the
    uchar-truncating CPU compat path lives in models/compat.py).
    """
    dtype = _float_dtype(prev)
    mask = MASKS[kernel]
    if normalize:
        mask = mask / mask.sum()
    return conv2d(nxt.astype(dtype) - prev.astype(dtype), mask)
