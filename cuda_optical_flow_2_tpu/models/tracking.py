"""Sparse point tracking over dense flow (the pyramidal-LK point tracker).

The reference samples its dense flow field at sparse grid points to draw the
arrow overlay (``visualizeFlowField``, main.cu:138-147); this module
productizes that sampling into trajectory tracking — the dense-flow
counterpart of the classic sparse pyramidal-LK tracker
(``cv::calcOpticalFlowPyrLK``): query points are advected through each
frame pair's dense flow with bilinear interpolation.

Design note: sampling N sparse points is a gather over N elements —
microscopic next to the dense pipeline for any practical N — so tracking
costs one dense-flow step plus O(N) per frame.

Conventions: points are (N, 2) float ``(x, y)`` pixel coordinates;
``flow[..., 0]`` is the x-displacement, ``flow[..., 1]`` the
y-displacement, and the framework's pair flow maps prev(x) = next(x + d),
so a point at ``p`` in the previous frame is at ``p + flow(p)`` in the next.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from cuda_optical_flow_2_tpu.models.lucas_kanade import _validate
from cuda_optical_flow_2_tpu.models.streaming import (
    _flow,
    _preprocess,
    process_sequence,
)
from cuda_optical_flow_2_tpu.ops.resize import downsample_flow

__all__ = ["sample_flow", "advect_points", "track_points", "track_sequence"]


def sample_flow(flow: jax.Array, points: jax.Array) -> jax.Array:
    """Bilinearly sample a (H, W, 2) flow field at (N, 2) ``(x, y)`` points.

    Sample positions are clamped to the image rectangle (border-clamp, the
    same boundary rule as the dense warp); the reference's arrow overlay
    samples the flow pyramid at sparse grid points the nearest-neighbor way
    (main.cu:138-147) — bilinear is the sub-pixel version.
    """
    h, w = flow.shape[-3:-1]
    x = jnp.clip(points[..., 0], 0.0, w - 1.0)
    y = jnp.clip(points[..., 1], 0.0, h - 1.0)
    x0 = jnp.floor(x)
    y0 = jnp.floor(y)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    x0i = x0.astype(jnp.int32)
    y0i = y0.astype(jnp.int32)
    x1i = jnp.minimum(x0i + 1, w - 1)
    y1i = jnp.minimum(y0i + 1, h - 1)
    f00 = flow[..., y0i, x0i, :]
    f01 = flow[..., y0i, x1i, :]
    f10 = flow[..., y1i, x0i, :]
    f11 = flow[..., y1i, x1i, :]
    return (
        f00 * (1 - fx) * (1 - fy)
        + f01 * fx * (1 - fy)
        + f10 * (1 - fx) * fy
        + f11 * fx * fy
    )


def advect_points(
    flow: jax.Array, points: jax.Array, alive: jax.Array | None = None
) -> tuple[jax.Array, jax.Array]:
    """One tracking step: ``p -> p + flow(p)`` with liveness bookkeeping.

    Returns ``(new_points, new_alive)``.  A point whose advected position
    leaves the image rectangle is marked dead (``alive=False`` — the
    ``status`` output of the classic sparse tracker) on the step it exits,
    with its position clamped to the border; dead points stay frozen
    thereafter.
    """
    if alive is None:
        alive = jnp.ones(points.shape[:-1], bool)
    h, w = flow.shape[-3:-1]
    new = points + sample_flow(flow, points)
    inside = (
        (new[..., 0] >= 0.0)
        & (new[..., 0] <= w - 1.0)
        & (new[..., 1] >= 0.0)
        & (new[..., 1] <= h - 1.0)
    )
    clamped = jnp.stack(
        [
            jnp.clip(new[..., 0], 0.0, w - 1.0),
            jnp.clip(new[..., 1], 0.0, h - 1.0),
        ],
        axis=-1,
    )
    out = jnp.where(alive[..., None], clamped, points)
    return out, alive & inside


# Module-level jit so one tracked stream's trace serves every later stream
# with the same shapes (a per-call jax.jit wrapper would retrace per clip).
_advect_jit = jax.jit(advect_points)


@functools.partial(jax.jit, static_argnames=("config", "warm_start"))
def track_sequence(
    frames: jax.Array,
    points: jax.Array,
    config,
    warm_start: bool = True,
) -> tuple[jax.Array, jax.Array]:
    """Track points through a stacked (T, H, W) frame array, one jitted scan.

    Returns ``(positions, alive)`` of shapes (T-1, N, 2) and (T-1, N):
    entry ``t`` is each point's position after frame pair ``t -> t+1`` (and
    whether it is still inside the image).  ``config`` selects the model
    family (LKConfig / HSConfig / FBConfig / TVL1Config); ``warm_start``
    seeds each pair with the previous pair's flow (the serving mode —
    docs/PERF.md "Warm-start streaming").

    For unbounded / iterable sources use :func:`track_points`.
    """
    frames = frames.astype(jnp.float32)
    _validate(frames[0], frames[0], config)
    pts0 = jnp.asarray(points, jnp.float32)
    if pts0.ndim != 2 or pts0.shape[-1] != 2:
        raise ValueError(f"points must be (N, 2) (x, y); got {pts0.shape}")
    pyr0 = _preprocess(frames[0], config)
    h, w = frames.shape[-2:]

    def body(carry, frame):
        pyr_prev, flow_prev, pts, alive = carry
        pyr = _preprocess(frame, config)
        init = (
            downsample_flow(flow_prev, pyr[-1].shape[-2:])
            if warm_start
            else None
        )
        flow = _flow(list(pyr_prev), pyr, config, init)
        pts, alive = advect_points(flow, pts, alive)
        return (tuple(pyr), flow, pts, alive), (pts, alive)

    init = (
        tuple(pyr0),
        jnp.zeros((h, w, 2), jnp.float32),
        pts0,
        jnp.ones(pts0.shape[:-1], bool),
    )
    _, (positions, alive) = jax.lax.scan(body, init, frames[1:])
    return positions, alive


def track_points(frames, points, config, warm_start: bool = True):
    """Generator twin of :func:`track_sequence` for iterable/unbounded
    sources: yields ``(frame_index, positions, alive)`` per consumed pair.

    Rides :func:`models.streaming.process_sequence`, so it inherits the
    live-capture semantics: works on any (finite or unbounded) iterable of
    (H, W) frames, skips decode failures (``None`` frames) by pairing across
    the gap — the advected trajectory stays continuous through a lost frame.
    """
    pts = jnp.asarray(points, jnp.float32)
    if pts.ndim != 2 or pts.shape[-1] != 2:
        raise ValueError(f"points must be (N, 2) (x, y); got {pts.shape}")
    alive = jnp.ones(pts.shape[:-1], bool)
    for i, flow in process_sequence(frames, config, warm_start=warm_start):
        pts, alive = _advect_jit(flow, pts, alive)
        yield i, pts, alive
