"""TV-L1 dense optical flow — a fourth model family (extension).

NOT in the reference (Kr-Stam/CUDA_Optical_Flow_2 implements pyramidal
Lucas-Kanade only); provided because TV-L1 (Zach, Pock & Bischof 2007,
cv::optflow::DualTVL1OpticalFlow) is the classic ROBUST dense method: an L1
data term (tolerates outliers/illumination jumps where LK/HS's quadratic
terms overweight them) with total-variation regularization (preserves motion
DISCONTINUITIES that HS's quadratic smoothness blurs).

Formulation — everything is elementwise math plus forward/backward-difference
stencils as pad-and-slice shifted adds, which XLA fuses; the inner
primal-dual loop is a ``lax.scan`` (static trip count), the pyramidal driver
reuses the shared scaffolding (Gaussian pyramid, exact-2x flow upsample,
bilinear warp between levels).

Per level, with u0 the warp-point flow (the flow the level started from):

    rho(u)  = It + (u - u0) . grad                    (linearized L1 residual)
    u      <- u + soft-threshold step + theta*div(p_i) per component:
                 step = +lt*grad   if rho < -lt*|g|^2
                        -lt*grad   if rho >  lt*|g|^2
                        -rho*grad/|g|^2 otherwise      (lt = lambda * theta)
    p_i    <- (p_i + tau/theta * grad(u_i)) / (1 + tau/theta * |grad(u_i)|)

with forward-difference gradients and (negative-adjoint) backward-difference
divergence, Neumann boundaries.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp
from jax import lax

from cuda_optical_flow_2_tpu.config import BilateralConfig
from cuda_optical_flow_2_tpu.ops.gradients import spatial_gradients
from cuda_optical_flow_2_tpu.ops.resize import upsample_flow

__all__ = [
    "TVL1Config",
    "tvl1_level",
    "tvl1_coarse_to_fine",
    "tvl1_preprocess",
    "pyramidal_tvl1",
]


@dataclasses.dataclass(frozen=True)
class TVL1Config:
    """TV-L1 configuration (frozen/hashable; jit with it static).

    Defaults follow the classic operating point (Zach et al. / OpenCV):
    lambda_=0.15 data weight, theta=0.3 coupling, tau=0.25 dual step
    (stability requires tau <= 1/4), 5 warps x 30 primal-dual iterations,
    5 pyramid levels.

    Attributes:
      lambda_: data-term weight (larger = trust the data more, less smooth).
      theta: coupling between the data and regularization subproblems.
      tau: dual ascent step (<= 0.25 for stability).
      warps: re-linearizations (warps of the next frame) per level.
      iterations: primal-dual iterations per warp.
      levels: pyramid depth.
      epsilon: |grad|^2 floor in the threshold step's division.
      median_filtering: odd k applies a k x k spatial median to the flow
        after each warp's iterations (the outlier-rejection step of the
        standard TV-L1 pipeline — OpenCV DualTVL1's medianBlur(5), which is
        also the default here: the median is what bounds cross-backend
        divergence, docs/PERF.md TV-L1 caveat); 0/1 disables, giving the
        pure Zach et al. update as the documented opt-out.
      max_displacement: spatial-TP halo budget, as in LKConfig.
      prefilter: optional joint-bilateral pre-smoothing, as in LKConfig.
    """

    lambda_: float = 0.15
    theta: float = 0.3
    tau: float = 0.25
    warps: int = 5
    iterations: int = 30
    levels: int = 5
    epsilon: float = 1e-6
    median_filtering: int = 5
    max_displacement: int = 32
    prefilter: Optional[BilateralConfig] = None

    def __post_init__(self) -> None:
        if self.levels < 1 or self.warps < 1 or self.iterations < 1:
            raise ValueError("levels, warps and iterations must be >= 1")
        if not (0.0 < self.tau <= 0.25):
            raise ValueError(f"tau must be in (0, 0.25], got {self.tau}")
        if self.lambda_ <= 0 or self.theta <= 0:
            raise ValueError("lambda_ and theta must be > 0")
        if self.epsilon <= 0:
            raise ValueError(f"epsilon must be > 0, got {self.epsilon}")
        if self.median_filtering not in (0, 1) and (
            self.median_filtering < 0 or self.median_filtering % 2 == 0
        ):
            raise ValueError(
                f"median_filtering must be 0/1 (off) or odd, "
                f"got {self.median_filtering}"
            )


def _fwd_diff(x: jax.Array, axis: int) -> jax.Array:
    """Forward difference with Neumann (zero at the far edge) boundary."""
    d = lax.slice_in_dim(x, 1, None, axis=axis) - lax.slice_in_dim(
        x, 0, -1, axis=axis
    )
    pad = [(0, 0)] * x.ndim
    pad[axis % x.ndim] = (0, 1)
    return jnp.pad(d, pad)


def _div(px: jax.Array, py: jax.Array) -> jax.Array:
    """Backward-difference divergence, the negative adjoint of _fwd_diff."""

    def bwd(x, axis):
        # div term: x[i] - x[i-1]; first element keeps x[0], last drops its
        # own (Neumann pairing with the forward difference's zero edge).
        d = lax.slice_in_dim(x, 1, -1, axis=axis) - lax.slice_in_dim(
            x, 0, -2, axis=axis
        )
        first = lax.slice_in_dim(x, 0, 1, axis=axis)
        last = -lax.slice_in_dim(x, -2, -1, axis=axis)
        return jnp.concatenate([first, d, last], axis=axis)

    return bwd(px, -1) + bwd(py, -2)


def tvl1_level(
    prev: jax.Array,
    warped: jax.Array,
    u0: jax.Array,
    flow: jax.Array,
    config: TVL1Config,
) -> jax.Array:
    """One linearization's primal-dual iterations (single warp).

    ``warped`` is next warped by ``u0``; ``flow`` is the current estimate
    (== u0 on the first warp).  Returns the refined TOTAL flow.
    """
    gx, gy = spatial_gradients(warped, normalize=True)
    g2 = gx * gx + gy * gy
    g2s = jnp.maximum(g2, config.epsilon)
    it = warped - prev
    lt = config.lambda_ * config.theta
    tt = config.tau / config.theta

    u = flow[..., 0]
    v = flow[..., 1]
    zeros = jnp.zeros_like(u)
    p = (zeros, zeros, zeros, zeros)  # (p1x, p1y, p2x, p2y)

    def body(carry, _):
        u, v, p1x, p1y, p2x, p2y = carry
        # data (threshold) step on the linearized residual
        rho = it + (u - u0[..., 0]) * gx + (v - u0[..., 1]) * gy
        th = lt * g2
        du = jnp.where(
            rho < -th, lt * gx,
            jnp.where(rho > th, -lt * gx, -rho * gx / g2s),
        )
        dv = jnp.where(
            rho < -th, lt * gy,
            jnp.where(rho > th, -lt * gy, -rho * gy / g2s),
        )
        u_d = u + du
        v_d = v + dv
        # primal from duals
        u_n = u_d + config.theta * _div(p1x, p1y)
        v_n = v_d + config.theta * _div(p2x, p2y)
        # dual ascent with pointwise projection
        for_u = (_fwd_diff(u_n, -1), _fwd_diff(u_n, -2))
        for_v = (_fwd_diff(v_n, -1), _fwd_diff(v_n, -2))
        nu = 1.0 + tt * jnp.sqrt(for_u[0] ** 2 + for_u[1] ** 2)
        nv = 1.0 + tt * jnp.sqrt(for_v[0] ** 2 + for_v[1] ** 2)
        p1x = (p1x + tt * for_u[0]) / nu
        p1y = (p1y + tt * for_u[1]) / nu
        p2x = (p2x + tt * for_v[0]) / nv
        p2y = (p2y + tt * for_v[1]) / nv
        return (u_n, v_n, p1x, p1y, p2x, p2y), None

    (u, v, *_), _ = lax.scan(
        body, (u, v, *p), None, length=config.iterations
    )
    return jnp.stack([u, v], axis=-1)


def _lk_like(config: TVL1Config):
    from cuda_optical_flow_2_tpu.models.horn_schunck import lk_preproc_config

    return lk_preproc_config(config)


def tvl1_preprocess(frame: jax.Array, config: TVL1Config) -> list[jax.Array]:
    """Frame -> (optionally bilateral-filtered) Gaussian pyramid (shared)."""
    from cuda_optical_flow_2_tpu.models.lucas_kanade import preprocess

    return preprocess(frame, _lk_like(config))


def tvl1_coarse_to_fine(
    prev_pyr: list[jax.Array],
    next_pyr: list[jax.Array],
    config: TVL1Config,
    init_flow: jax.Array | None = None,
) -> jax.Array:
    """Coarse-to-fine TV-L1 over prebuilt pyramids; returns the finest flow.

    Each warp backward-warps the next frame by the current TOTAL flow (the
    same warp as LK/HS/FB) and runs ``config.iterations`` primal-dual steps
    on the re-linearized residual.
    """
    from cuda_optical_flow_2_tpu.models.lucas_kanade import warp_fn

    warp = warp_fn(_lk_like(config))
    flow = init_flow
    for k in range(config.levels - 1, -1, -1):
        p, n = prev_pyr[k], next_pyr[k]
        if flow is None:
            flow = jnp.zeros(p.shape + (2,), p.dtype)
        else:
            flow = upsample_flow(flow, p.shape[-2:])
        for _ in range(config.warps):
            warped = warp(n, flow)
            flow = tvl1_level(p, warped, flow, flow, config)
            if config.median_filtering > 1:
                from cuda_optical_flow_2_tpu.ops.median import median_filter

                flow = jnp.moveaxis(
                    median_filter(
                        jnp.moveaxis(flow, -1, 0), config.median_filtering
                    ),
                    0,
                    -1,
                )
    return flow


def pyramidal_tvl1(
    prev: jax.Array, nxt: jax.Array, config: TVL1Config
) -> jax.Array:
    """Dense TV-L1 flow (..., H, W, 2) from a planar grayscale pair."""
    return tvl1_coarse_to_fine(
        tvl1_preprocess(prev, config), tvl1_preprocess(nxt, config), config
    )


pyramidal_tvl1_jit = jax.jit(pyramidal_tvl1, static_argnames=("config",))

# Real-time operating point: 4 levels x 4 warps x 14 iterations, about 2.7x
# less relaxation work than the classic default; 4 warps keep the
# rotation-field EPE within ~25% of the 150-iteration default (0.136 vs
# 0.110) and the translation EPE at 0.023.
TVL1_REALTIME = TVL1Config(levels=4, warps=4, iterations=14)
