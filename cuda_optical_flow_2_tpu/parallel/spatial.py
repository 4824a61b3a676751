"""Spatial (tensor-parallel) sharding: one frame pair split across chips.

The reference has no multi-GPU story (SURVEY.md section 2.5); its moral
equivalent of cross-worker data movement is the shared-memory halo loads of
the tiled CUDA kernels (OptFlowGpu.cu:504-707).  This module scales that
idea up to a whole device mesh: the image's row axis is sharded over the
mesh, every stencil stage (pyramid downsample, gradients, window sums, warp,
2x flow upsample) exchanges exactly the halo rows it needs with its mesh
neighbors via ``lax.ppermute`` over NVLink, and everything runs under one
``shard_map`` — no host round trips, no all-gathers.  Each shard runs the
XLA forms of the stages.

Use when a single frame exceeds one card's comfortable working set (e.g. 8K
video) or to cut single-pair latency; for throughput over many pairs prefer
batch sharding (parallel/batching.py).

Exactness: away from the mesh's global top/bottom edges the sharded result is
the same computation XLA would run unsharded (same zero-padded convolutions,
same warp fallback semantics, float-for-float up to reduction order).  The one
semantic difference: the sharded path always enforces the
``config.max_displacement`` warp budget (the halo width is derived from it),
where the unsharded XLA gather warp is unbounded.
"""

from __future__ import annotations

import functools
import math

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P

try:  # jax.shard_map on new versions, experimental on older
    from jax import shard_map  # type: ignore[attr-defined]
except ImportError:  # pragma: no cover
    from jax.experimental.shard_map import (  # type: ignore
        shard_map as _legacy_shard_map,
    )

    def shard_map(f, **kwargs):
        # The legacy API spells check_vma as check_rep; every call site here
        # passes check_vma, so the fallback must translate or it is dead on
        # arrival on exactly the versions that need it.
        if "check_vma" in kwargs:
            kwargs["check_rep"] = kwargs.pop("check_vma")
        return _legacy_shard_map(f, **kwargs)

from cuda_optical_flow_2_tpu.config import LKConfig
from cuda_optical_flow_2_tpu.models.lucas_kanade import solve_flow
from cuda_optical_flow_2_tpu.ops.bilateral import bilateral_filter_band
from cuda_optical_flow_2_tpu.ops.gradients import spatial_gradients, temporal_gradient
from cuda_optical_flow_2_tpu.ops.pyramid import pyr_down
from cuda_optical_flow_2_tpu.ops.resize import _up2x_axis
from cuda_optical_flow_2_tpu.ops.warp import warp_bilinear_band
from cuda_optical_flow_2_tpu.ops.window import (
    centered_structure_tensor_sums,
    structure_tensor_sums,
)

__all__ = [
    "halo_exchange",
    "spatial_pyramidal_lk",
    "grid_pyramidal_lk",
    "validate_spatial",
]


def halo_exchange(
    x: jax.Array,
    top: int,
    bottom: int,
    axis_name: str,
    n_shards: int,
    *,
    row_axis: int = -2,
    boundary: str = "zero",
) -> jax.Array:
    """Pad a row-sharded block with ``top``/``bottom`` rows from mesh neighbors.

    Neighbor rows travel over NVLink via ``lax.ppermute``; the mesh-boundary
    shards, which have no neighbor, get zeros (``boundary="zero"``, matching
    the zero-padded convolutions) or their own edge row replicated
    (``boundary="edge"``, matching clamped sampling).  Halo widths must not
    exceed the block height (one neighbor hop).
    """
    h = x.shape[row_axis]
    if top > h or bottom > h:
        raise ValueError(f"halo ({top}, {bottom}) exceeds block height {h}")
    idx = lax.axis_index(axis_name) if boundary == "edge" else None
    parts = []
    if top > 0:
        recv = lax.ppermute(
            lax.slice_in_dim(x, h - top, h, axis=row_axis),
            axis_name,
            [(i, i + 1) for i in range(n_shards - 1)],
        )
        if boundary == "edge":
            edge = _replicate_row(x, 0, top, row_axis)
            recv = jnp.where(idx == 0, edge, recv)
        parts.append(recv)
    parts.append(x)
    if bottom > 0:
        recv = lax.ppermute(
            lax.slice_in_dim(x, 0, bottom, axis=row_axis),
            axis_name,
            [(i + 1, i) for i in range(n_shards - 1)],
        )
        if boundary == "edge":
            edge = _replicate_row(x, h - 1, bottom, row_axis)
            recv = jnp.where(idx == n_shards - 1, edge, recv)
        parts.append(recv)
    return jnp.concatenate(parts, axis=row_axis)


def _replicate_row(x: jax.Array, row: int, count: int, row_axis: int) -> jax.Array:
    r = lax.slice_in_dim(x, row, row + 1, axis=row_axis)
    reps = [1] * x.ndim
    reps[row_axis % x.ndim] = count
    return jnp.tile(r, reps)


def _crop_rows(x: jax.Array, r: int, row_axis: int = -2) -> jax.Array:
    return lax.slice_in_dim(x, r, x.shape[row_axis] - r, axis=row_axis)


def _zero_outside_global(x: jax.Array, row0, h_global: int, row_axis: int = -2):
    """Zero the rows of a padded band that fall outside the global image."""
    h = x.shape[row_axis]
    rows = jnp.arange(h) + row0
    keep = (rows >= 0) & (rows < h_global)
    shape = [1] * x.ndim
    shape[row_axis % x.ndim] = h
    return jnp.where(keep.reshape(shape), x, jnp.zeros((), x.dtype))


def _local_prefilter(
    frame: jax.Array, config, axis_name: str, n: int, h_global: int
) -> jax.Array:
    """Shard-local bilateral prefilter: halo-exchange ``window//2`` rows,
    filter the band with GLOBAL-coordinate tap masking, crop.

    Kept rows see exactly the taps the unsharded filter would (the halo
    supplies real neighbor rows; beyond the global border the mask skips
    taps just as the whole-image filter does), so sharded preprocessing
    matches unsharded float-for-float.
    """
    pf = config.prefilter
    r = pf.window // 2
    row0 = lax.axis_index(axis_name) * frame.shape[-2]
    fp = halo_exchange(frame, r, r, axis_name, n)
    out = bilateral_filter_band(
        fp, row0 - r, h_global, pf.window, pf.sigma_spatial, pf.sigma_range
    )
    return _crop_rows(out, r)


def _local_pyr_down(x: jax.Array, axis_name: str, n: int) -> jax.Array:
    """Shard-local fused blur + 2x subsample, halo-exact.

    pyr_down's output row i reads source rows 2i-1..2i+1 (zero-clipped at the
    global border, ops/pyramid.py).  Padding each block with TWO rows from
    above keeps the even start-row alignment: the padded block starts at
    global row s-2 (still even), its pyr_down output starts at global output
    row s/2 - 1, and dropping that first row leaves exactly this shard's
    output rows.  The top shard's zero-filled halo reproduces the global
    zero-clipping.
    """
    xp = halo_exchange(x, 2, 0, axis_name, n)
    y = pyr_down(xp)
    return lax.slice_in_dim(y, 1, y.shape[-2], axis=-2)


def _local_upsample2x_flow(flow: jax.Array, axis_name: str, n: int) -> jax.Array:
    """Shard-local exact-2x flow upsample (rows sharded, columns whole).

    The row stencil (out[2k] = .75 in[k] + .25 in[k-1], edges clamped —
    ops/resize.py) needs one neighbor row on each side; ``boundary="edge"``
    reproduces the global clamp on the mesh-boundary shards.  The padded
    rows' outputs are cropped.
    """
    fp = halo_exchange(flow, 1, 1, axis_name, n, row_axis=-3, boundary="edge")
    up = _crop_rows(_up2x_axis(fp, -3), 2, -3)
    up = _up2x_axis(up, -2)
    return up * jnp.asarray(2.0, flow.dtype)


def _banded_residual(
    prev_p: jax.Array,
    nxt_p: jax.Array,
    row0_pad,
    h_global: int,
    config: LKConfig,
    centered: bool = False,
) -> jax.Array:
    """LK residual on a padded row band, exact vs the global computation.

    The subtlety vs calling the whole-image residual on the band: near the
    GLOBAL top/bottom edge the band's halo rows are zero image, but a
    convolution over them still produces nonzero "phantom" gradients (its taps
    reach the real edge rows), whereas the unsharded window sums see gradients
    that simply end at the image boundary.  Zeroing the gradients outside the
    global image before the window sums restores exact equivalence.
    """
    ix, iy = spatial_gradients(prev_p, config.normalize_gradients)
    it = temporal_gradient(
        prev_p, nxt_p, config.temporal_kernel, config.normalize_gradients
    )
    ix = _zero_outside_global(ix, row0_pad, h_global)
    iy = _zero_outside_global(iy, row0_pad, h_global)
    it = _zero_outside_global(it, row0_pad, h_global)
    if centered:
        # DIS mean normalization: the count plane must cover in-GLOBAL-image
        # pixels only, exactly like the fused kernels' `inside` mask.
        valid = _zero_outside_global(jnp.ones_like(ix), row0_pad, h_global)
        sums = centered_structure_tensor_sums(
            ix, iy, it, config.window, config.window_method, valid=valid,
            weights=getattr(config, "window_weights", "box"),
        )
    else:
        sums = structure_tensor_sums(
            ix, iy, it, config.window, config.window_method,
            getattr(config, "window_weights", "box"),
        )
    return solve_flow(sums, config)


def _halo_radius(config: LKConfig) -> tuple[int, int]:
    r_grad = config.window // 2 + 2
    d = int(math.ceil(config.max_displacement))
    return r_grad, r_grad + d + 2


def _local_lk_level(
    prev: jax.Array,
    nxt: jax.Array,
    flow,
    config: LKConfig,
    axis_name: str,
    n: int,
    h_global: int,
    centered: bool = False,
):
    """One pyramid level on a row shard, with per-iteration halo exchange.

    Mirrors models.lucas_kanade.lk_level: gradients and window sums need
    ``r_grad = window//2 + 2`` halo rows (zero at the global border, matching
    the convolutions' zero padding); the warp additionally needs the clamped
    displacement budget.  The residual is computed on the padded band and
    cropped, so every kept row sees exactly the taps the unsharded
    computation would.
    """
    r_grad, r_img = _halo_radius(config)
    hloc = prev.shape[-2]
    row0 = lax.axis_index(axis_name) * hloc

    prev_p = halo_exchange(prev, r_grad, r_grad, axis_name, n)
    iterations = config.iterations

    def residual_nowarp():
        nxt_p = halo_exchange(nxt, r_grad, r_grad, axis_name, n)
        return _crop_rows(
            _banded_residual(
                prev_p, nxt_p, row0 - r_grad, h_global, config, centered
            ),
            r_grad,
            -3,
        )

    if flow is None:
        # Coarsest level: residual between the raw frames, no warp
        # (OptFlowGpu.cu:1917-1921 skips the shift at the top level).
        flow = residual_nowarp()
        iterations -= 1
        if config.warp_mode == "none" or iterations <= 0:
            return flow
    if config.warp_mode == "none":
        return flow + residual_nowarp()
    nxt_p = halo_exchange(nxt, r_img, r_img, axis_name, n)
    for _ in range(iterations):
        flow = jnp.clip(flow, -config.max_displacement, config.max_displacement)
        flow_p = halo_exchange(flow, r_grad, r_grad, axis_name, n, row_axis=-3)
        warped = warp_bilinear_band(
            nxt_p, flow_p, row0 - r_img, row0 - r_grad, h_global
        )
        res = _banded_residual(
            prev_p, warped, row0 - r_grad, h_global, config, centered
        )
        flow = flow + _crop_rows(res, r_grad, -3)
    return flow


def validate_prefilter_shards(h: int, n: int, config, w: int | None = None) -> None:
    """Shared check: every family's spatial validator must reject shards too
    short to supply the bilateral prefilter's halo rows (model-generic — only
    ``config.prefilter`` is consulted)."""
    if config.prefilter is not None and h // n < config.prefilter.window // 2:
        raise ValueError(
            f"prefilter window {config.prefilter.window} needs "
            f"{config.prefilter.window // 2} halo rows but each of {n} "
            f"shards holds only {h // n}"
        )


def validate_spatial(h: int, w: int, config: LKConfig, n: int) -> None:
    """Raise with a precise message if (h, w) can't be row-sharded n ways."""
    validate_prefilter_shards(h, n, config, w)
    if config.warp_mode == "nearest":
        raise NotImplementedError("spatial sharding supports bilinear/none warps")
    r_grad, r_img = _halo_radius(config)
    top = config.levels - 1
    if h % (n << top) or (top and w % (1 << top)):
        raise ValueError(
            f"spatial sharding needs H divisible by n_shards * 2^(levels-1) "
            f"= {n << top} and W by {1 << top}; got {h}x{w}"
        )
    for k in range(config.levels):
        # Level k warps (and so needs the image halo r_img) unless it is the
        # coarsest level running a single iteration, which never warps.
        warps = config.warp_mode != "none" and (
            k < top or config.iterations > 1
        )
        hk = (h >> k) // n
        need = max(r_img if warps else r_grad, 2)
        if hk < need:
            raise ValueError(
                f"level {k} holds {hk} rows/shard but its halos need {need}; "
                f"reduce levels, window, max_displacement or shards"
            )


def _local_pipeline(
    prev_blk: jax.Array,
    nxt_blk: jax.Array,
    config: LKConfig,
    axis_name: str,
    n: int,
    h: int,
) -> jax.Array:
    """The full per-shard pipeline on one row block (one frame pair)."""
    if config.prefilter is not None:
        prev_blk = _local_prefilter(prev_blk, config, axis_name, n, h)
        nxt_blk = _local_prefilter(nxt_blk, config, axis_name, n, h)
    prev_pyr = [prev_blk]
    next_pyr = [nxt_blk]
    for _ in range(1, config.levels):
        prev_pyr.append(_local_pyr_down(prev_pyr[-1], axis_name, n))
        next_pyr.append(_local_pyr_down(next_pyr[-1], axis_name, n))
    flow = None
    for k in range(config.levels - 1, -1, -1):
        if flow is not None:
            flow = _local_upsample2x_flow(flow, axis_name, n)
        flow = _local_lk_level(
            prev_pyr[k], next_pyr[k], flow, config, axis_name, n, h >> k
        )
    return flow


def spatial_pyramidal_lk(
    prev: jax.Array,
    nxt: jax.Array,
    config: LKConfig,
    mesh: Mesh,
    axis_name: str = "space",
) -> jax.Array:
    """Dense flow for ONE frame pair row-sharded over ``mesh``.

    Args:
      prev / nxt: (H, W) planar grayscale float32, H divisible by
        n_shards * 2^(levels-1).
    Returns: (H, W, 2) flow with the same row sharding.
    """
    h, w = prev.shape[-2:]
    n = mesh.shape[axis_name]
    validate_spatial(h, w, config, n)
    return _spatial_lk_jit(config, mesh, axis_name, n, h)(prev, nxt)


@functools.lru_cache(maxsize=128)
def _spatial_lk_jit(config: LKConfig, mesh: Mesh, axis_name: str, n: int, h: int):
    # Cached per (config, mesh, shape) so repeated calls —
    # e.g. one per frame pair in a serving loop — reuse the traced/compiled
    # program instead of retracing a fresh shard_map closure every time.
    def local(prev_blk, nxt_blk):
        return _local_pipeline(prev_blk, nxt_blk, config, axis_name, n, h)

    fn = shard_map(
        local,
        mesh=mesh,
        in_specs=(P(axis_name, None), P(axis_name, None)),
        out_specs=P(axis_name, None, None),
    )
    return jax.jit(fn)


def grid_pyramidal_lk(
    prev_batch: jax.Array,
    nxt_batch: jax.Array,
    config: LKConfig,
    mesh: Mesh,
    batch_axis: str = "batch",
    space_axis: str = "space",
) -> jax.Array:
    """Combined DP x TP: a frame-pair batch sharded over a 2-D mesh.

    The batch axis is data-parallel (zero communication) and each pair's rows
    are sharded over the space axis with ppermute halo exchange — the full
    production layout for high-throughput large-frame serving: e.g. four
    cards as (2 batch, 2 space) run 2 concurrent 8K streams.

    Args:
      prev_batch / nxt_batch: (B, H, W), B divisible by the batch axis size,
        H by space-size * 2^(levels-1).
    Returns: (B, H, W, 2) flow, sharded the same way.
    """
    b, h, w = prev_batch.shape[-3:]
    nb = mesh.shape[batch_axis]
    ns = mesh.shape[space_axis]
    if b % nb != 0:
        raise ValueError(f"batch {b} not divisible by {batch_axis} size {nb}")
    validate_spatial(h, w, config, ns)
    return _grid_lk_jit(config, mesh, batch_axis, space_axis, ns, h)(
        prev_batch, nxt_batch
    )


@functools.lru_cache(maxsize=128)
def _grid_lk_jit(
    config: LKConfig,
    mesh: Mesh,
    batch_axis: str,
    space_axis: str,
    ns: int,
    h: int,
):
    def local(pb, nbk):
        f = lambda p, n_: _local_pipeline(p, n_, config, space_axis, ns, h)  # noqa: E731
        return jax.vmap(f)(pb, nbk)

    fn = shard_map(
        local,
        mesh=mesh,
        in_specs=(P(batch_axis, space_axis, None),) * 2,
        out_specs=P(batch_axis, space_axis, None, None),
    )
    return jax.jit(fn)
