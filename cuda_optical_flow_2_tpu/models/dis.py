"""DIS-style dense inverse-search optical flow — a fifth model family.

NOT in the reference (Kr-Stam/CUDA_Optical_Flow_2 implements pyramidal
Lucas-Kanade only); provided so the framework covers the modern realtime
method: Kroeger, Timofte, Dai & Van Gool, *Fast Optical Flow using Dense
Inverse Search* (ECCV 2016) — the algorithm behind OpenCV's
``DISOpticalFlow``.  Its three ingredients, re-designed for dense arrays:

* **Inverse search = mean-normalized LK steps.**  The paper's per-patch
  Gauss-Newton descent minimizes the *mean-normalized* SSD between the
  template patch and the warped patch (its central robustness trick:
  additive illumination changes cancel).  The normal equations of that
  residual are the ordinary LK equations with every window sum replaced by
  the *centered* (covariance) sum — ops/window.centered_structure_tensor_sums
  (XLA) and the ``centered=True`` mode of the fused residual kernel
  (kernels/lk_fused.py), which adds four window sums on its tile.
* **Stride-1 patch grid (densification-free).**  The paper computes one
  displacement per ps x ps patch on a stride-s grid and then *densifies* by
  error-weighted blending of the overlapping estimates.  Here the grid runs
  at stride 1 — every pixel is its own patch center — which is the dense-
  array mapping: the window sums are per-pixel stencils computed for every
  pixel anyway, and at stride 1 the densification pass is the identity.
* **Variational refinement = total-flow Horn-Schunck at the warp point.**
  The paper follows the search with a few Brox-style variational iterations.
  Here: Jacobi relaxation of the TOTAL flow with the data term linearized at
  the warped position (``it_warped - ix*u0 - iy*v0``), quadratic penalties
  instead of Charbonnier (a documented substitution), as a ``lax.scan`` of
  Jacobi sweeps with the offset folded into the data term.  Relaxing the
  total flow (not the residual) is what fills textureless regions from
  their neighborhoods.

The temporal term defaults to the smoothed Dt_3x3 difference
(``temporal_kernel="dt3"``), NOT the paper's raw patch difference
(available as ``"delta"``): the pipeline's spatial gradients are
Sobel-smoothed, and an unsmoothed temporal term against smoothed spatial
terms biases the GN step — measured 2.7x worse EPE (0.22 vs 0.08 on the
translating-texture harness, docs/studies/dis_accuracy.py).  The paper's
illumination robustness comes from the mean normalization, which is kept.

All entry points accept leading batch dims and jit with the config static,
like every other family.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from cuda_optical_flow_2_tpu.config import BilateralConfig, LKConfig
from cuda_optical_flow_2_tpu.constants import MASKS
from cuda_optical_flow_2_tpu.models.horn_schunck import (
    _avg3x3,
    _robust_relax_xla,
)
from cuda_optical_flow_2_tpu.kernels import lk_fused, residual_impl
from cuda_optical_flow_2_tpu.models.lucas_kanade import _validate, warp_fn
from cuda_optical_flow_2_tpu.ops.conv import stencil2d
from cuda_optical_flow_2_tpu.ops.gradients import (
    SOBEL_GAIN,
    spatial_gradients,
    temporal_gradient,
)
from cuda_optical_flow_2_tpu.ops.resize import upsample_flow
from cuda_optical_flow_2_tpu.ops.solve import solve_2x2, solve_2x2_unguarded
from cuda_optical_flow_2_tpu.ops.window import (
    centered_structure_tensor_sums,
    structure_tensor_sums,
    window_sum,
)

__all__ = [
    "DISConfig",
    "DIS_REALTIME",
    "dis_level",
    "dis_preprocess",
    "dis_coarse_to_fine",
    "pyramidal_dis",
]


@dataclasses.dataclass(frozen=True)
class DISConfig:
    """DIS-style flow configuration (frozen/hashable; jit with it static).

    Attributes:
      levels: pyramid depth.
      finest_level: stop the solve at this pyramid level and bilinearly
        upsample the rest of the way (0 = solve at full resolution).  The
        paper's ``finest scale`` speed knob: OpenCV's MEDIUM preset stops a
        quarter of the way up; each skipped level saves the most expensive
        steps.
      iterations: inverse-search (Gauss-Newton) steps per level.
      window: odd patch side for the mean-normalized window sums (the
        paper's ps=8 patch, stride-1 dense — see module docstring).
      mean_normalize: subtract per-window intensity means from the data term
        (the DIS residual).  False degrades to plain iterated LK with a
        direct frame difference.
      refine_iterations: variational-refinement Jacobi sweeps per level
        (0 disables refinement).
      refine_alpha: refinement smoothness weight (as HSConfig.alpha).
        Default 20.0 = cv2.VariationalRefinement's alpha default; the
        round-3 default of 10.0 under-smoothed — measured 2-5x worse EPE
        across the whole anchor harness (docs/studies/dis_gap_study.py:
        natural-texture translation 0.059 -> 0.029 at alpha=20, 0.012 at
        40).  Larger alpha keeps improving these smooth-truth cases but
        blurs real motion discontinuities harder under the quadratic
        penalty, so the quadratic default stays at the anchor's value.
        With ``refine_penalty="charbonnier"`` the smoothness weight
        collapses at discontinuities, decoupling that tradeoff — see
        refine_penalty.
      refine_penalty: "quadratic" (HS form) or "charbonnier" (normalized
        Charbonnier data + smoothness penalties via lagged diffusivity:
        per-pixel weights ``wd = ed/sqrt(r^2+ed^2)``,
        ``ws = es/sqrt(|grad w|^2+es^2)`` recomputed once per time-tiled
        chunk — the paper's robust penalties, the documented round-3/4
        substitution removed).  Charbonnier reaches the quadratic
        alpha=40 smooth-texture accuracy WITHOUT its boundary blur
        (docs/studies/charbonnier_study.py): use ``refine_alpha~=40`` with
        it.  eps -> inf recovers the quadratic path exactly.
      refine_eps_data: Charbonnier data scale ed (intensity units; weights
        halve at |residual| ~= ed).
      refine_eps_smooth: Charbonnier smoothness scale es (flow-gradient
        units per pixel; diffusivity halves where |grad w| ~= es — the
        knee between "smooth region" and "motion boundary").
      temporal_kernel: "dt3" (smoothed difference, default — see module
        docstring for the measurement), "delta" (paper-faithful direct
        difference) or "gauss3".
      det_eps: |det| guard for the 2x2 solve (see LKConfig.det_eps).
      window_method: XLA-path windowed-sum backend (see LKConfig).
      prefilter: optional joint-bilateral pre-smoothing, as in LKConfig.
      use_pallas: run the inverse-search step through the fused residual
        kernel where kernels.residual_impl allows it (see LKConfig).
      max_displacement: spatial-TP halo budget, as in LKConfig.
    """

    levels: int = 5
    finest_level: int = 0
    iterations: int = 2
    window: int = 9
    mean_normalize: bool = True
    refine_iterations: int = 5
    refine_alpha: float = 20.0
    refine_penalty: str = "quadratic"
    refine_eps_data: float = 3.0
    refine_eps_smooth: float = 0.1
    temporal_kernel: str = "dt3"
    det_eps: float = 1e-8
    window_method: str = "sep_conv"
    # Window weighting for the mean-normalized sums ("box"/"tri"/"gauss",
    # see LKConfig.window_weights): the flat window's negative transfer
    # sidelobes bias the iterated GN steps exactly as in LK — measured on
    # the anchor harness in docs/studies/dis_gap_study.py.
    window_weights: str = "box"
    prefilter: Optional[BilateralConfig] = None
    use_pallas: bool = True
    max_displacement: int = 32

    def __post_init__(self) -> None:
        if self.levels < 1:
            raise ValueError(f"levels must be >= 1, got {self.levels}")
        if not 0 <= self.finest_level < self.levels:
            raise ValueError(
                f"finest_level must be in [0, levels); got "
                f"{self.finest_level} with levels={self.levels}"
            )
        if self.iterations < 1:
            raise ValueError(f"iterations must be >= 1, got {self.iterations}")
        if self.window % 2 != 1 or self.window < 3:
            raise ValueError(f"window must be odd >= 3, got {self.window}")
        if self.refine_iterations < 0:
            raise ValueError(
                f"refine_iterations must be >= 0, got {self.refine_iterations}"
            )
        if self.refine_alpha <= 0:
            raise ValueError(f"refine_alpha must be > 0, got {self.refine_alpha}")
        if self.refine_penalty not in ("quadratic", "charbonnier"):
            raise ValueError(
                f"unknown refine_penalty {self.refine_penalty!r}"
            )
        if self.refine_eps_data <= 0:
            raise ValueError(
                f"refine_eps_data must be > 0, got {self.refine_eps_data}"
            )
        if self.refine_eps_smooth <= 0:
            raise ValueError(
                f"refine_eps_smooth must be > 0, got {self.refine_eps_smooth}"
            )
        if self.temporal_kernel not in ("delta", "dt3", "gauss3"):
            raise ValueError(f"unknown temporal_kernel {self.temporal_kernel!r}")
        if self.window_weights not in ("box", "tri", "gauss"):
            raise ValueError(f"unknown window_weights {self.window_weights!r}")


def _lk_like(config: DISConfig) -> LKConfig:
    """LKConfig view of a DISConfig for the shared kernels/warp/preprocess.

    Unlike horn_schunck.lk_preproc_config (which only threads the preproc +
    warp knobs), the DIS inverse-search step runs the LK kernels themselves,
    so the solve knobs (window, temporal kernel, det guard) carry over too.
    """
    return LKConfig(
        levels=config.levels,
        window=config.window,
        iterations=1,
        temporal_kernel=config.temporal_kernel,
        warp_mode="bilinear",
        det_eps=config.det_eps,
        window_method=config.window_method,
        window_weights=config.window_weights,
        normalize_gradients=True,
        max_displacement=config.max_displacement,
        prefilter=config.prefilter,
        use_pallas=config.use_pallas,
    )


def _dis_residual_xla(
    prev: jax.Array, warped: jax.Array, config: DISConfig
) -> jax.Array:
    """Mean-normalized GN step between prev and the (already warped) next."""
    ix, iy = spatial_gradients(prev, normalize=True)
    it = temporal_gradient(prev, warped, config.temporal_kernel, normalize=True)
    if config.mean_normalize:
        sums = centered_structure_tensor_sums(
            ix, iy, it, config.window, config.window_method,
            weights=config.window_weights,
        )
    else:
        sums = structure_tensor_sums(
            ix, iy, it, config.window, config.window_method,
            config.window_weights,
        )
    if config.det_eps == 0.0:
        return solve_2x2_unguarded(*sums)
    return solve_2x2(*sums, eps=config.det_eps)


def _dis_residual(
    prev: jax.Array, warped: jax.Array, config: DISConfig
) -> jax.Array:
    lk_like = _lk_like(config)
    if residual_impl(jax.default_backend(), prev.dtype, prev.shape, lk_like) == "triton":
        return lk_fused.lk_residual(
            prev, warped, lk_like, centered=config.mean_normalize
        )
    return _dis_residual_xla(prev, warped, config)


def _refine(
    prev: jax.Array, nxt: jax.Array, flow: jax.Array, config: DISConfig
) -> jax.Array:
    """Variational refinement: relax the TOTAL flow around the warp point.

    Data term linearized at the applied flow w0: ``ix*u + iy*v + it_off``
    with ``it_off = it(prev, warp(nxt, w0)) - ix*u0 - iy*v0`` — at w = w0
    the residual is exactly the warped temporal difference.  Quadratic
    data + smoothness (Horn-Schunck form) instead of the paper's Charbonnier
    penalties; relaxing the total flow is what propagates flow into
    textureless regions, which the guarded inverse-search solve leaves at
    its initialization.

    With ``config.mean_normalize`` the warped temporal difference is
    centered by its per-window mean before linearizing — the refinement
    twin of the search step's mean-normalized data term.  Without it, a
    global additive illumination change puts a constant ``it`` into every
    pixel's data term and the relaxation converges to a uniformly biased
    flow (measured: EPE 0.5 -> 4.2 under a +25 offset) — exactly the
    failure the DIS residual exists to prevent.  The mean is folded into
    the precomputed offset plane of the relaxation's data term.
    """
    # Relax around the flow clamped to the warp budget (max_displacement),
    # which is also what the spatial-TP band form can reach in its halo.
    flow = jnp.clip(flow, -config.max_displacement, config.max_displacement)
    warped = warp_fn(_lk_like(config))(nxt, flow)

    # Shift-form stencils and integral-image window sums: both fuse into
    # plain elementwise loops.
    sscale = 1.0 / SOBEL_GAIN
    ix = stencil2d(prev, MASKS["sobel_x"] * sscale)
    iy = stencil2d(prev, MASKS["sobel_y"] * sscale)
    off = -(ix * flow[..., 0] + iy * flow[..., 1])
    if config.mean_normalize:
        tmask = MASKS[config.temporal_kernel]
        it_w = stencil2d(warped - prev, tmask / tmask.sum())
        counts = window_sum(jnp.ones_like(it_w), config.window, "cumsum")
        off = off - window_sum(it_w, config.window, "cumsum") / (
            jnp.maximum(counts, 1.0)
        )

    robust = _robust_eps(config)
    tmask = MASKS[config.temporal_kernel]
    it = stencil2d(warped - prev, tmask / tmask.sum()) + off
    if robust is not None:
        return _robust_relax_xla(
            flow, ix, iy, it, config.refine_iterations,
            config.refine_alpha, robust,
        )
    denom = config.refine_alpha**2 + ix * ix + iy * iy

    def sweep(uv, _):
        u_bar = _avg3x3(uv[..., 0])
        v_bar = _avg3x3(uv[..., 1])
        rate = (ix * u_bar + iy * v_bar + it) / denom
        return jnp.stack([u_bar - ix * rate, v_bar - iy * rate], axis=-1), None

    uv, _ = lax.scan(sweep, flow, None, length=config.refine_iterations)
    return uv


def _robust_eps(config: DISConfig) -> tuple[float, float] | None:
    """(eps_data, eps_smooth) for the Charbonnier penalty, else None."""
    if config.refine_penalty != "charbonnier":
        return None
    return (config.refine_eps_data, config.refine_eps_smooth)


def dis_level(
    prev: jax.Array,
    nxt: jax.Array,
    flow_init: jax.Array | None,
    config: DISConfig,
) -> jax.Array:
    """One pyramid level: inverse-search GN steps + variational refinement."""
    warp = warp_fn(_lk_like(config))
    flow = flow_init
    for _ in range(config.iterations):
        if flow is None:
            # Coarsest start: zero displacement, so the "warped" frame is
            # the frame itself — one plain centered residual step.
            flow = _dis_residual(prev, nxt, config)
            continue
        flow = flow + _dis_residual(prev, warp(nxt, flow), config)

    if config.refine_iterations > 0:
        flow = _refine(prev, nxt, flow, config)
    return flow


def dis_preprocess(frame: jax.Array, config: DISConfig) -> list[jax.Array]:
    """Frame -> (optionally bilateral-filtered) Gaussian pyramid (shared)."""
    from cuda_optical_flow_2_tpu.models.lucas_kanade import preprocess

    return preprocess(frame, _lk_like(config))


def dis_coarse_to_fine(
    prev_pyr: list[jax.Array],
    next_pyr: list[jax.Array],
    config: DISConfig,
    init_flow: jax.Array | None = None,
) -> jax.Array:
    """Coarse-to-fine DIS over prebuilt pyramids; returns the finest flow.

    Levels below ``config.finest_level`` are never solved — the flow is
    bilinearly upsampled the rest of the way (the paper's finest-scale
    speed knob).
    """
    flow = init_flow
    for k in range(config.levels - 1, config.finest_level - 1, -1):
        if flow is not None:
            flow = upsample_flow(flow, prev_pyr[k].shape[-2:])
        flow = dis_level(prev_pyr[k], next_pyr[k], flow, config)
    if config.finest_level > 0:
        flow = upsample_flow(flow, prev_pyr[0].shape[-2:])
    return flow


def pyramidal_dis(
    prev: jax.Array, nxt: jax.Array, config: DISConfig
) -> jax.Array:
    """Dense DIS-style flow (..., H, W, 2) from a frame pair.

    ``prev``/``nxt`` are planar grayscale float images (any leading batch
    dims).  Jit with ``static_argnames=("config",)``.
    """
    _validate(prev, nxt, config)
    return dis_coarse_to_fine(
        dis_preprocess(prev, config), dis_preprocess(nxt, config), config
    )


pyramidal_dis_jit = jax.jit(pyramidal_dis, static_argnames=("config",))

# Realtime serving preset: skip the full-resolution solve (finest_level=1)
# like OpenCV's fast presets (accuracy measured in
# docs/studies/dis_accuracy.py).
DIS_REALTIME = DISConfig(levels=5, finest_level=1)
