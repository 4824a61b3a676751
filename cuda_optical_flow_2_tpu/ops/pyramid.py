"""Gaussian pyramid: fused binomial blur + 2x subsample.

Replacement for G9 (g_gauss_pyramid, OptFlowGpu.cu:1193-1271) and its CPU
twin cpu::downscale_gaussian (OptFlowCPU.cpp:112-148).  The reference
evaluates a dense 3x3 loop per output pixel at source coords
(2x-1..2x+1, 2y-1..2y+1) with zero padding; here the same stencil is one
strided separable pass, device-resident, batched over leading dims.

Grid alignment: output (x, y) is centered on source (2x, 2y) — achieved with
stride-2 taps and explicit (1, 1) padding, which reproduces the
reference's zero-padded (2x-1) window start exactly.  Odd source sizes follow
the reference's floor semantics (level k is (h >> k, w >> k); the trailing
odd row/column is never read, matching ``pw = w << 1``).
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

from cuda_optical_flow_2_tpu.constants import BINOMIAL_1D

__all__ = ["pyr_down", "build_pyramid"]


def pyr_down(x: jax.Array, kernel_1d=BINOMIAL_1D) -> jax.Array:
    """Blur + 2x downsample: (..., H, W) -> (..., H//2, W//2).

    ``kernel_1d`` is the separable factor of the smoothing mask (default: the
    binomial {1,2,1}/4, whose outer product is the reference's
    GAUS_KERNEL_3x3, kernels.cpp:61-64).  Output (i, j) is
    sum_ab k[a] k[b] x[2i + a - r, 2j + b - r] with zero padding — G9's
    strided stencil, which XLA fuses into one pass over the image.
    """
    k = np.asarray(kernel_1d).reshape(-1)
    if k.size % 2 != 1:
        raise ValueError("pyramid kernel must have odd length")
    h, w = x.shape[-2:]
    oh, ow = h // 2, w // 2
    dtype = x.dtype if jnp.issubdtype(x.dtype, jnp.floating) else jnp.float32
    r = k.size // 2
    pad = [(0, 0)] * (x.ndim - 2) + [(r, r), (r, r)]
    xp = jnp.pad(x[..., : 2 * oh, : 2 * ow].astype(dtype), pad)
    rows = sum(
        float(c) * xp[..., a : a + 2 * oh : 2, :] for a, c in enumerate(k)
    )
    return sum(
        float(c) * rows[..., :, b : b + 2 * ow : 2] for b, c in enumerate(k)
    )


def build_pyramid(x: jax.Array, levels: int, kernel_1d=BINOMIAL_1D) -> list[jax.Array]:
    """Level-0..levels-1 pyramid; level k shaped (..., h >> k, w >> k).

    Twin of gpu::gauss_pyramid / cpu::gauss_pyramid loops
    (OptFlowGpu.cu:1262-1271, OptFlowCPU.cpp:151-160).
    """
    h, w = x.shape[-2:]
    pyr = [x]
    for k in range(1, levels):
        th, tw = h >> k, w >> k
        pyr.append(pyr_down(pyr[-1][..., : 2 * th, : 2 * tw], kernel_1d))
    return pyr
