"""Pure-JAX op library (the XLA reference path).

Re-design of the reference's GPU op library (namespace gpu,
OptFlowGpu.cu — see SURVEY.md section 2.1).  Every op here is a pure function on
device-resident ``jax.Array``s, composable under one ``jit``; none of the
reference's per-op host<->device round trips exist.  The fused kernel in
``cuda_optical_flow_2_tpu.kernels`` replaces the hot composition of these ops
(gradients, window sums, solve) on the GPU.
"""

from cuda_optical_flow_2_tpu.ops.color import grayscale, grayscale_u8
from cuda_optical_flow_2_tpu.ops.conv import conv2d, sep_conv2d, stencil2d
from cuda_optical_flow_2_tpu.ops.pyramid import build_pyramid, pyr_down
from cuda_optical_flow_2_tpu.ops.gradients import spatial_gradients, temporal_gradient
from cuda_optical_flow_2_tpu.ops.window import (
    structure_tensor_sums,
    window_sum,
    window_weight_taps,
)
from cuda_optical_flow_2_tpu.ops.solve import solve_2x2, solve_2x2_unguarded
from cuda_optical_flow_2_tpu.ops.warp import warp_bilinear, warp_nearest
from cuda_optical_flow_2_tpu.ops.resize import upsample_flow, upscale_nn
from cuda_optical_flow_2_tpu.ops.bilateral import bilateral_filter
from cuda_optical_flow_2_tpu.ops.median import median_filter

__all__ = [
    "median_filter",
    "grayscale",
    "grayscale_u8",
    "conv2d",
    "sep_conv2d",
    "stencil2d",
    "build_pyramid",
    "pyr_down",
    "spatial_gradients",
    "temporal_gradient",
    "structure_tensor_sums",
    "window_sum",
    "window_weight_taps",
    "solve_2x2",
    "solve_2x2_unguarded",
    "warp_bilinear",
    "warp_nearest",
    "upsample_flow",
    "upscale_nn",
    "bilateral_filter",
]
