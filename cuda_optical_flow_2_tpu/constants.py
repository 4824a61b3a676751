"""Convolution-mask constants and the runtime Gaussian-kernel generator.

Re-design of the reference's mask tables (reference: kernels.cpp:6-64,
kernels.hpp:3-13) and of ``utils::generate_gaussian_kernel``
(reference: OptFlowUtils.cpp:68-114).  Where the reference stores masks in global
C arrays mirrored into CUDA ``__constant__`` memory (OptFlowGpu.cu:190, 1193-1196,
1982), here they are plain NumPy arrays baked into jitted programs as compile-time
constants — XLA materialises them directly in the compiled executable, the
counterpart of constant memory.
"""

from __future__ import annotations

import math

import numpy as np

__all__ = [
    "DX_3X3",
    "DX_3X3_T",
    "DY_3X3",
    "DT_3X3",
    "DT_3X3_N",
    "DELTA_3X3",
    "DX_2X2",
    "DY_2X2",
    "DZ_2X2",
    "DX_DIAGONAL_2X2",
    "DY_DIAGONAL_2X2",
    "DX_5X5",
    "GAUS_KERNEL_3X3",
    "GAUS_KERNEL_5X5",
    "BINOMIAL_1D",
    "MASKS",
    "generate_gaussian_kernel",
]

_f32 = np.float32

# Sobel-x derivative mask (reference: kernels.cpp:6-10).
DX_3X3 = np.array(
    [[-1.0, 0.0, 1.0], [-2.0, 0.0, 2.0], [-1.0, 0.0, 1.0]], dtype=_f32
)

# Transposed/scaled Sobel-x variant (reference: kernels.cpp:11-14; unused live).
DX_3X3_T = np.array(
    [
        [1.0 / 3.0, 0.0, -1.0 / 3.0],
        [2.0 / 3.0, 0.0, -2.0 / 3.0],
        [1.0 / 3.0, 0.0, -1.0 / 3.0],
    ],
    dtype=_f32,
)

# Sobel-y derivative mask (reference: kernels.cpp:15-19).
DY_3X3 = np.array(
    [[-1.0, -2.0, -1.0], [0.0, 0.0, 0.0], [1.0, 2.0, 1.0]], dtype=_f32
)

# Temporal smoothing mask, unnormalized (sum = 15) (reference: kernels.cpp:20-24).
DT_3X3 = np.array([[1.0, 2.0, 1.0], [2.0, 3.0, 2.0], [1.0, 2.0, 1.0]], dtype=_f32)

# Identity "temporal smoothing": It is the direct frame difference (no
# neighborhood blur).  Not in the reference's mask set (kernels.cpp applies
# Dt_3x3 or the Gaussian); used by the DIS-style family, whose
# mean-normalized data term does its own per-window centering and wants the
# raw residual (Kroeger et al. 2016 use the direct patch difference).
DELTA_3X3 = np.array(
    [[0.0, 0.0, 0.0], [0.0, 1.0, 0.0], [0.0, 0.0, 0.0]], dtype=_f32
)

# Normalized temporal mask used by the debug visualizer (reference: kernels.cpp:25-28).
DT_3X3_N = np.array(
    [
        [0.0666, 0.1333, 0.0666],
        [0.1333, 0.2, 0.1333],
        [0.0666, 0.1333, 0.0666],
    ],
    dtype=_f32,
)

# 2x2 derivative schemes zero-padded into 3x3 (reference: kernels.cpp:29-48; unused live).
DY_DIAGONAL_2X2 = np.array(
    [[1.0, 0.0, 0.0], [0.0, -1.0, 0.0], [0.0, 0.0, 0.0]], dtype=_f32
)
DX_DIAGONAL_2X2 = np.array(
    [[0.0, 1.0, 0.0], [-1.0, 0.0, 0.0], [0.0, 0.0, 0.0]], dtype=_f32
)
DX_2X2 = np.array([[-1.0, 1.0, 0.0], [-1.0, 1.0, 0.0], [0.0, 0.0, 0.0]], dtype=_f32)
DY_2X2 = np.array([[-1.0, -1.0, 0.0], [1.0, 1.0, 0.0], [0.0, 0.0, 0.0]], dtype=_f32)
DZ_2X2 = np.array([[1.0, 1.0, 0.0], [1.0, 1.0, 0.0], [0.0, 0.0, 0.0]], dtype=_f32)

# 5x5 derivative mask (reference: kernels.cpp:49-54; unused live).
DX_5X5 = np.array(
    [
        [-1.0, -2.0, 0.0, 1.0, 2.0],
        [-2.0, -3.0, 0.0, 2.0, 3.0],
        [-3.0, -5.0, 0.0, 3.0, 5.0],
        [-2.0, -3.0, 0.0, 3.0, 2.0],
        [-1.0, -2.0, 0.0, 2.0, 1.0],
    ],
    dtype=_f32,
)

# 5x5 Gaussian mask (reference: kernels.cpp:55-60; unused live).
GAUS_KERNEL_5X5 = np.array(
    [
        [0.00366, 0.01465, 0.02564, 0.01465, 0.00366],
        [0.01465, 0.05860, 0.09523, 0.05860, 0.01465],
        [0.02564, 0.09523, 0.15018, 0.09523, 0.02564],
        [0.01465, 0.05860, 0.09523, 0.05860, 0.01465],
        [0.00366, 0.01465, 0.02564, 0.01465, 0.00366],
    ],
    dtype=_f32,
)

# 3x3 binomial Gaussian = {1,2,1}/4 (x) {1,2,1}/4 (reference: kernels.cpp:61-64).
# Live in: pyramid construction (OptFlowGpu.cu:1193-1196) and CPU temporal
# smoothing (OptFlowCPU.cpp:336-338).
GAUS_KERNEL_3X3 = np.array(
    [
        [0.0625, 0.125, 0.0625],
        [0.125, 0.25, 0.125],
        [0.0625, 0.125, 0.0625],
    ],
    dtype=_f32,
)

# Separable factor of GAUS_KERNEL_3X3; the pyramid applies it as two rank-1
# passes instead of the reference's dense 3x3 loop.
BINOMIAL_1D = np.array([0.25, 0.5, 0.25], dtype=_f32)

# Name -> mask registry used by LKConfig string fields.
MASKS = {
    "sobel_x": DX_3X3,
    "sobel_y": DY_3X3,
    "dt3": DT_3X3,
    "dt3_n": DT_3X3_N,
    "delta": DELTA_3X3,
    "gauss3": GAUS_KERNEL_3X3,
    "gauss5": GAUS_KERNEL_5X5,
    "dx5": DX_5X5,
}


def generate_gaussian_kernel(sigma: float, size: int = -1) -> np.ndarray:
    """Generate a normalized 2-D Gaussian mask.

    Matches ``utils::generate_gaussian_kernel`` (reference: OptFlowUtils.cpp:68-114)
    semantics exactly: ``size == -1`` derives the size as ``int(2*pi*sigma)``, even
    sizes are bumped to the next odd, the four symmetric quadrants are filled from
    the same value and the mask is normalized to unit sum.  Returned as float64,
    matching the reference's ``double`` math (the bilateral filter consumes it as
    double, OptFlowGpu.cu:1982-2063).
    """
    if size == -1:
        size = int(2.0 * math.pi * sigma)
    if size % 2 == 0:
        size += 1
    mask = np.zeros((size, size), dtype=np.float64)
    hk = size >> 1
    sigma2 = float(sigma) * float(sigma)
    for i in range(hk + 1):
        for j in range(hk + 1):
            value = 1.0 / (2.0 * math.pi * sigma2) * math.exp(
                -0.5 * (i * i + j * j) / sigma2
            )
            mask[hk + i, hk + j] = value
            mask[hk - i, hk - j] = value
            mask[hk + i, hk - j] = value
            mask[hk - i, hk + j] = value
    mask /= mask.sum()
    return mask
