"""Hand-written GPU kernels for the hot stages, and the choice between them
and their XLA twins.

The fused LK residual (kernels/lk_fused.py) replaces the reference's
per-operation CUDA kernels G7 + G13 + G16 (OptFlowGpu.cu:768-1125,
:1541-1625, :1810-1899) and their ~24 PCIe crossings per level (SURVEY.md
section 3.2) with one Pallas-Triton kernel per level that reads the two
frames and writes only the flow.
"""

from __future__ import annotations

import jax.numpy as jnp

from cuda_optical_flow_2_tpu.kernels import lk_fused

__all__ = ["lk_fused", "residual_impl"]


def residual_impl(backend: str, dtype, shape: tuple[int, ...], config) -> str:
    """Which implementation computes the LK residual: "triton" or "xla".

    ``backend`` is ``jax.default_backend()``; ``dtype`` and ``shape`` are the
    frames'; ``config`` is an LKConfig (or a view of one).  The kernel runs
    for float32 frames on the GPU when ``config.use_pallas`` asks for it and
    the window fits its tile (kernels/lk_fused.MAX_WINDOW); everything else
    runs the XLA twin, including every CPU run.
    """
    if not config.use_pallas or backend != "gpu":
        return "xla"
    if jnp.dtype(dtype) != jnp.float32 or config.window > lk_fused.MAX_WINDOW:
        return "xla"
    if min(shape[-2:]) < 1:
        return "xla"
    return "triton"
