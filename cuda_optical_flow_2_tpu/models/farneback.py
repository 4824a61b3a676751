"""Farnebäck dense optical flow — a third model family (extension).

NOT in the reference (Kr-Stam/CUDA_Optical_Flow_2 implements pyramidal
Lucas-Kanade only); provided because it is the other classic dense method a
flow-framework user expects (cv::calcOpticalFlowFarneback): each frame is
approximated per pixel by a quadratic polynomial (ops/poly_exp.py), and the
displacement follows in closed form from how the polynomial coefficients
move between frames (Farnebäck 2003).  Compared to LK it is derivative-free
(the expansion is a weighted least-squares fit, more robust to noise) and its
data term tolerates larger sub-window motion.

Formulation — every stage reuses the framework's shared primitives:

* polynomial expansion: separable shifted-add correlations;
* per-iteration warp, two formulations (``FBConfig.warp_planes``):
  - "image" (default): backward-warp the next FRAME by the current flow and
    re-expand.  Moves 1 plane instead of 5 through the warp and measured
    equal-or-better accuracy;
  - "coeff": warp the five expansion coefficient planes (the
    cv::calcOpticalFlowFarneback formulation);
* the displacement normal equations: 5 windowed sums (box via separable
  ones-correlations, or a true Gaussian window) + a guarded 2x2 solve —
  structurally the LK solve on different matrices.

Update equations, with our flow convention prev(x) = next(x + d), where B2
is b2 warped ("coeff") or the b-coefficient of the re-expanded warped frame
("image"), likewise A2:

    A(x)  = (A1(x) + A2(x)) / 2
    db(x) = (b1(x) - B2(x)) / 2 + A(x) d0
    d     = (sum_w A^T A)^{-1} (sum_w A^T db)       [total flow, not residual]
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp

from cuda_optical_flow_2_tpu.config import BilateralConfig
from cuda_optical_flow_2_tpu.ops.conv import sep_conv2d
from cuda_optical_flow_2_tpu.ops.poly_exp import gaussian_1d, poly_expansion
from cuda_optical_flow_2_tpu.ops.resize import upsample_flow
from cuda_optical_flow_2_tpu.ops.window import window_sum

__all__ = [
    "FBConfig",
    "fb_level",
    "fb_level_image",
    "fb_coarse_to_fine",
    "fb_preprocess",
    "pyramidal_farneback",
]


@dataclasses.dataclass(frozen=True)
class FBConfig:
    """Farnebäck configuration (frozen/hashable; jit with it static).

    Defaults follow the classic operating point (cv::calcOpticalFlowFarneback
    with poly_n=7): 3 pyramid levels, 3 iterations/level, 15x15 averaging
    window.

    Attributes:
      levels: pyramid depth (2x decimation per level).
      iterations: displacement refinements per level (each re-warps the next
        frame's coefficient planes by the current total flow).
      poly_n / poly_sigma: expansion neighborhood size and applicability
        sigma (classic pairs: 5/1.1, 7/1.5).
      winsize: averaging window for the normal equations.
      gaussian_window: weight the window by a Gaussian (sigma = winsize/4,
        OpenCV's convention) instead of a flat box.
      det_eps: |det| guard for the 2x2 solve (0 flow where singular).
      max_displacement: warp displacement budget (flow is clamped to it
        before each warp) and spatial-TP halo budget, as in LKConfig.
      warp_planes: what the per-iteration warp moves.  "image" (default)
        backward-warps the next FRAME and re-expands it — 1 plane moved
        instead of 5, measured equal-or-better accuracy (docs/PERF.md).
        "coeff" warps the five expansion coefficient planes
        (cv::calcOpticalFlowFarneback's formulation).
      prefilter: optional joint-bilateral pre-smoothing, as in LKConfig.
    """

    levels: int = 3
    iterations: int = 3
    poly_n: int = 7
    poly_sigma: float = 1.5
    winsize: int = 15
    gaussian_window: bool = False
    det_eps: float = 1e-6
    max_displacement: int = 32
    warp_planes: str = "image"
    prefilter: Optional[BilateralConfig] = None

    def __post_init__(self) -> None:
        if self.levels < 1 or self.iterations < 1:
            raise ValueError("levels and iterations must be >= 1")
        if self.poly_n % 2 != 1 or self.poly_n < 3:
            raise ValueError(f"poly_n must be odd >= 3, got {self.poly_n}")
        if self.winsize % 2 != 1:
            raise ValueError(f"winsize must be odd, got {self.winsize}")
        if self.poly_sigma <= 0:
            raise ValueError(f"poly_sigma must be > 0, got {self.poly_sigma}")
        if self.warp_planes not in ("image", "coeff"):
            raise ValueError(
                f"warp_planes must be 'image' or 'coeff', got {self.warp_planes}"
            )


def _lk_like(config: FBConfig):
    from cuda_optical_flow_2_tpu.models.horn_schunck import lk_preproc_config

    return lk_preproc_config(config)


def _expand(frame: jax.Array, config: FBConfig) -> tuple[jax.Array, ...]:
    """Polynomial expansion of one frame (ops/poly_exp.py)."""
    return poly_expansion(frame, config.poly_n, config.poly_sigma)


def _window(x: jax.Array, config: FBConfig) -> jax.Array:
    """Normal-equation averaging window (normalization cancels in the solve)."""
    if config.gaussian_window:
        g = gaussian_1d(config.winsize, config.winsize / 4.0)
        return sep_conv2d(x, g, g)
    return window_sum(x, config.winsize)


def fb_level(
    exp1: tuple[jax.Array, ...],
    exp2: tuple[jax.Array, ...],
    flow: jax.Array | None,
    config: FBConfig,
) -> jax.Array:
    """``config.iterations`` displacement refinements from two expansions.

    ``exp1``/``exp2`` are (bx, by, axx, ayy, axy) tuples from
    :func:`poly_expansion`; ``flow`` is the prior total flow (or None).
    Returns the refined TOTAL flow (..., H, W, 2).
    """
    from cuda_optical_flow_2_tpu.models.lucas_kanade import warp_fn

    bx1, by1, axx1, ayy1, axy1 = exp1
    planes2 = jnp.stack(exp2)  # (5, ..., H, W)
    warp = warp_fn(_lk_like(config))

    for _ in range(config.iterations):
        if flow is None:
            w_bx, w_by, w_axx, w_ayy, w_axy = exp2
            u = v = jnp.zeros_like(bx1)
        else:
            # The budget clamp keeps the 'coeff' and 'image' formulations
            # in agreement beyond float noise.
            flow = jnp.clip(
                flow, -config.max_displacement, config.max_displacement
            )
            fb = jnp.broadcast_to(flow, planes2.shape + (2,))
            w_bx, w_by, w_axx, w_ayy, w_axy = warp(planes2, fb)
            u, v = flow[..., 0], flow[..., 1]

        prods = fb_normal_eq_products(
            (bx1, by1, axx1, ayy1, axy1),
            (w_bx, w_by, w_axx, w_ayy, w_axy),
            u,
            v,
        )
        flow = _window_solve(prods, config)
    return flow


def _window_solve(prods, config: FBConfig) -> jax.Array:
    """Window the normal-equation products and solve for the flow."""
    sums = _window(jnp.stack(prods), config)
    return solve_normal_eqs(sums, config.det_eps)


def fb_normal_eq_products(exp1, warped_exp, u, v):
    """Per-pixel Farnebäck normal-equation products for one iteration.

    ``exp1`` / ``warped_exp`` are the (bx, by, axx, ayy, axy) expansion
    planes of frame 1 and of the warped frame 2; ``u, v`` the flow the warp
    used.  Returns the 5 pre-window products (g11, g12, g22, h1, h2).
    Shared by fb_level (coeff form), fb_level_image, and the sharded band
    form (parallel/spatial_models.py) so the algebra cannot drift between
    the unsharded/TP and image/coeff parity twins.
    """
    bx1, by1, axx1, ayy1, axy1 = exp1
    w_bx, w_by, w_axx, w_ayy, w_axy = warped_exp
    axx = 0.5 * (axx1 + w_axx)
    ayy = 0.5 * (ayy1 + w_ayy)
    axy = 0.5 * (axy1 + w_axy)
    db_x = 0.5 * (bx1 - w_bx) + axx * u + axy * v
    db_y = 0.5 * (by1 - w_by) + axy * u + ayy * v
    return (
        axx * axx + axy * axy,
        axy * (axx + ayy),
        axy * axy + ayy * ayy,
        axx * db_x + axy * db_y,
        axy * db_x + ayy * db_y,
    )


def solve_normal_eqs(sums: jax.Array, det_eps: float) -> jax.Array:
    """Guarded 2x2 solve of the windowed normal equations.

    ``sums`` stacks (g11, g12, g22, h1, h2); |det| < det_eps pixels get
    zero flow.  Shared by the XLA window-solve here and the sharded band
    form (parallel/spatial_models.py), so the guard semantics cannot drift
    between the unsharded and TP paths.
    """
    g11, g12, g22, h1, h2 = (sums[i] for i in range(5))
    det = g11 * g22 - g12 * g12
    safe = jnp.abs(det) >= det_eps
    inv_det = 1.0 / jnp.where(safe, det, jnp.ones_like(det))
    zero = jnp.zeros_like(det)
    u_new = jnp.where(safe, (g22 * h1 - g12 * h2) * inv_det, zero)
    v_new = jnp.where(safe, (g11 * h2 - g12 * h1) * inv_det, zero)
    return jnp.stack([u_new, v_new], axis=-1)


def fb_level_image(
    nxt: jax.Array,
    exp1: tuple[jax.Array, ...],
    flow: jax.Array | None,
    config: FBConfig,
) -> jax.Array:
    """``config.iterations`` refinements, image-warp formulation.

    Each iteration backward-warps the next FRAME by the current total flow,
    re-expands the warped band, and solves the windowed normal equations.
    """
    from cuda_optical_flow_2_tpu.models.lucas_kanade import warp_fn

    bx1, by1, axx1, ayy1, axy1 = exp1
    warp = warp_fn(_lk_like(config))

    for _ in range(config.iterations):
        if flow is None:
            w_bx, w_by, w_axx, w_ayy, w_axy = _expand(nxt, config)
            u = v = jnp.zeros_like(bx1)
        else:
            flow = jnp.clip(
                flow, -config.max_displacement, config.max_displacement
            )
            wimg = warp(nxt, flow)
            w_bx, w_by, w_axx, w_ayy, w_axy = _expand(wimg, config)
            u, v = flow[..., 0], flow[..., 1]

        prods = fb_normal_eq_products(
            (bx1, by1, axx1, ayy1, axy1),
            (w_bx, w_by, w_axx, w_ayy, w_axy),
            u,
            v,
        )
        flow = _window_solve(prods, config)
    return flow


def fb_preprocess(frame: jax.Array, config: FBConfig) -> list[jax.Array]:
    """Frame -> (optionally bilateral-filtered) Gaussian pyramid (shared)."""
    from cuda_optical_flow_2_tpu.models.lucas_kanade import preprocess

    return preprocess(frame, _lk_like(config))


def fb_coarse_to_fine(
    prev_pyr: list[jax.Array],
    next_pyr: list[jax.Array],
    config: FBConfig,
    init_flow: jax.Array | None = None,
) -> jax.Array:
    """Coarse-to-fine Farnebäck over prebuilt pyramids; returns finest flow.

    ``init_flow`` (coarsest-level resolution/units) warm-starts the coarsest
    level (streaming warm start).
    """
    flow = init_flow
    for k in range(config.levels - 1, -1, -1):
        exp1 = _expand(prev_pyr[k], config)
        if flow is not None:
            flow = upsample_flow(flow, prev_pyr[k].shape[-2:])
        if config.warp_planes == "image":
            flow = fb_level_image(next_pyr[k], exp1, flow, config)
        else:
            exp2 = _expand(next_pyr[k], config)
            flow = fb_level(exp1, exp2, flow, config)
    return flow


def pyramidal_farneback(
    prev: jax.Array, nxt: jax.Array, config: FBConfig
) -> jax.Array:
    """Dense Farnebäck flow (..., H, W, 2) from a planar grayscale pair."""
    return fb_coarse_to_fine(
        fb_preprocess(prev, config), fb_preprocess(nxt, config), config
    )


pyramidal_farneback_jit = jax.jit(
    pyramidal_farneback, static_argnames=("config",)
)
