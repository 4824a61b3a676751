"""Framework configuration.

The reference hardcodes every parameter as a literal (levels=4 main.cu:192,
window 19x19 OptFlowGpu.cu:1944-1945 / 9x9 OptFlowCPU.cpp:344-345, bilateral
ww=wh=9 sigmaS=2 sigmaB=10 main.cu:236-240, capture 640x480 main.cu:183-184).
Here those become documented defaults of a frozen, hashable dataclass so whole
pipelines can be jitted with the config as a static argument.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

__all__ = ["BilateralConfig", "LKConfig", "REFERENCE_GPU", "REFERENCE_CPU", "PAPER_1080P"]


@dataclasses.dataclass(frozen=True)
class BilateralConfig:
    """Joint-bilateral pre-filter parameters (reference defaults: main.cu:236-240)."""

    window: int = 9
    sigma_spatial: float = 2.0
    sigma_range: float = 10.0


@dataclasses.dataclass(frozen=True)
class LKConfig:
    """Pyramidal Lucas-Kanade configuration.

    Attributes:
      levels: pyramid depth (level k is the base image floor-halved k times).
      window: odd integration-window side for the structure-tensor sums.
      iterations: refinement iterations per level (the reference runs 1).
      temporal_kernel: "dt3" (GPU path, unnormalized Dt_3x3), "gauss3"
        (CPU path, binomial smoothing of both frames), or "delta" (direct
        frame difference, no smoothing — the DIS family's default).
      warp_mode: "bilinear" | "nearest" | "none" — coarse-to-fine backward warp.
        The reference's warp intent is nearest (OptFlowCPU.cpp:241-282);
        production default is bilinear (BASELINE config 3).
      det_eps: |det| threshold below which the 2x2 solve returns (0, 0).  The
        reference divides by the raw determinant with no guard
        (OptFlowGpu.cu:1835); eps=0.0 reproduces that (inf/nan pass through).
      window_method: backend for the windowed sums — "sep_conv" (separable
        ones-vector convolutions), "cumsum" (integral image) or
        "reduce_window" (lax.reduce_window).
      window_weights: weighting of the integration window — "box" (the
        reference's flat 19x19 sum, OptFlowGpu.cu:1944-1945), "tri"
        (trapezoid: two iterated box sums), or "gauss" (truncated Gaussian,
        sigma = window/6).  The box window's Fourier transfer function has
        NEGATIVE sidelobes (min -0.22 at 19 taps), so the iterative
        warp-and-re-solve correction flips sign for flow-error components
        at scales near the window size: iterating diverges (measured EPE
        0.09 -> 0.46 px over 8 iterations on a natural-texture translation)
        and the converged field keeps a smooth ~0.1 px error floor.  "tri"
        (min transfer -0.01) and "gauss" (-0.002) are monotone-stable and
        cut the same case to 0.02 / 0.008 px.  Default "tri" (the accuracy
        win is ~5x); "gauss" is the maximum-accuracy point; "box" is the
        reference's flat sum (REFERENCE_GPU/REFERENCE_CPU pin it).  The
        gauss sigma (window/6) is a measured compromise — narrower (w/8)
        favors pure translation, wider (w/4) favors rotation/shear; no
        single sigma dominates (round-4 sweep).  See
        docs/studies/lk_window_study.py and docs/PERF.md ACCURACY.
      max_displacement: the largest flow, in pixels, that spatial tensor
        parallelism (parallel/spatial.py) provisions halo rows for: a
        shard's warp can reach this far past its band.  Farneback also
        clamps its flow to it before each warp.
      normalize_gradients: scale the derivative stencils to unit gain (Sobel
        has gain 8 on a unit ramp; the reference's Dt_3x3 sums to 15,
        kernels.cpp:20-24).  The reference never normalizes, which biases its
        flow magnitudes by temporal_gain/spatial_gain (15/8 for the GPU path);
        production defaults to True so flow comes out in true pixels.  Set
        False for reference-faithful magnitudes.
      prefilter: optional joint-bilateral pre-smoothing of the input frames.
      use_pallas: compute each level's residual (gradients + window sums +
        solve) in the fused GPU kernel (kernels/lk_fused.py) where
        kernels.residual_impl allows it; the XLA ops run otherwise.
    """

    levels: int = 4
    window: int = 19
    iterations: int = 1
    temporal_kernel: str = "dt3"
    warp_mode: str = "bilinear"
    det_eps: float = 1e-8
    window_method: str = "sep_conv"
    window_weights: str = "tri"
    normalize_gradients: bool = True
    max_displacement: int = 32
    prefilter: Optional[BilateralConfig] = None
    use_pallas: bool = True

    def __post_init__(self) -> None:
        if self.window % 2 != 1:
            raise ValueError(f"window must be odd, got {self.window}")
        if self.levels < 1:
            raise ValueError(f"levels must be >= 1, got {self.levels}")
        if self.warp_mode not in ("bilinear", "nearest", "none"):
            raise ValueError(f"unknown warp_mode {self.warp_mode!r}")
        if self.iterations < 1:
            raise ValueError(f"iterations must be >= 1, got {self.iterations}")
        if self.temporal_kernel not in ("dt3", "gauss3", "delta"):
            raise ValueError(f"unknown temporal_kernel {self.temporal_kernel!r}")
        if self.window_method not in ("sep_conv", "cumsum", "reduce_window"):
            raise ValueError(f"unknown window_method {self.window_method!r}")
        if self.window_weights not in ("box", "tri", "gauss"):
            raise ValueError(f"unknown window_weights {self.window_weights!r}")


# The reference GPU operating point — the full live loop of main.cu:
# bilateral pre-filter (ww=wh=9, sigmaS=2, sigmaB=10, main.cu:236-240), 4
# pyramid levels (main.cu:192), 19x19 window (OptFlowGpu.cu:1944-1945),
# raw (unnormalized) gradient gains.
REFERENCE_GPU = LKConfig(
    levels=4,
    window=19,
    temporal_kernel="dt3",
    normalize_gradients=False,
    window_weights="box",  # the reference's flat srm sums
    prefilter=BilateralConfig(),
)

# The reference CPU twin operating point (OptFlowCPU.cpp:344-345, :336-338).
REFERENCE_CPU = LKConfig(
    levels=4, window=9, temporal_kernel="gauss3", normalize_gradients=False,
    window_weights="box",
)

# BASELINE.json config 4: 5-level pyramidal LK, 15x15 window, 1080p.
PAPER_1080P = LKConfig(levels=5, window=15, temporal_kernel="dt3")
