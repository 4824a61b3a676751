"""Dense optical flow framework in JAX, running on the GPU.

A from-scratch JAX/XLA/Pallas re-design of the pyramidal Lucas-Kanade pipeline
behind "Speeding up Dense Optical Flow Estimation with CUDA" (Stameski &
Gusev, TELFOR 2024; Kr-Stam/CUDA_Optical_Flow_2).  See
SURVEY.md for the structural analysis of the reference and the layer map this
package implements.

Public API:

    import cuda_optical_flow_2_tpu as of

    flow = of.pyramidal_lk(prev_gray, next_gray, of.LKConfig(levels=4))

    # or model-generic, dispatched on the config type:
    flow = of.pyramidal_flow(prev_gray, next_gray, of.TVL1Config())
"""

from cuda_optical_flow_2_tpu.config import (
    BilateralConfig,
    LKConfig,
    PAPER_1080P,
    REFERENCE_CPU,
    REFERENCE_GPU,
)
from cuda_optical_flow_2_tpu.models import (
    DIS_REALTIME,
    DISConfig,
    FBConfig,
    HSConfig,
    TVL1_REALTIME,
    TVL1Config,
    process_sequence,
    pyramidal_dis,
    pyramidal_farneback,
    pyramidal_flow,
    pyramidal_hs,
    pyramidal_tvl1,
)
from cuda_optical_flow_2_tpu.models.lucas_kanade import (
    compose_flow_pyramid,
    lk_level,
    pyramidal_lk,
    pyramidal_lk_jit,
    pyramidal_lk_pyramid,
)

__version__ = "0.1.0"

__all__ = [
    "BilateralConfig",
    "LKConfig",
    "HSConfig",
    "FBConfig",
    "TVL1Config",
    "TVL1_REALTIME",
    "DISConfig",
    "DIS_REALTIME",
    "REFERENCE_CPU",
    "REFERENCE_GPU",
    "PAPER_1080P",
    "pyramidal_flow",
    "pyramidal_lk",
    "pyramidal_lk_jit",
    "pyramidal_lk_pyramid",
    "pyramidal_hs",
    "pyramidal_farneback",
    "pyramidal_tvl1",
    "pyramidal_dis",
    "process_sequence",
    "lk_level",
    "compose_flow_pyramid",
    "__version__",
]
