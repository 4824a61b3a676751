"""Frame-pair batch sharding over a device mesh.

Replacement for the reference's (absent) scale-out story: the
64-frame 1080p stream of BASELINE config 5 becomes a (B, H, W) batch sharded
over the mesh's "batch" axis.  The pipeline is elementwise in the batch
dimension, so under ``jit`` with sharding annotations XLA partitions every op
with zero communication; host<->device transfer happens once at the video I/O
boundary, not per op like the reference's ~24 PCIe copies per level
(SURVEY.md section 3.1).
"""

from __future__ import annotations

import functools

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from cuda_optical_flow_2_tpu.config import LKConfig
from cuda_optical_flow_2_tpu.models import pyramidal_flow

__all__ = ["make_mesh", "shard_batch", "sharded_flow", "sharded_pyramidal_lk", "chunked_flow"]


def make_mesh(n_devices: int | None = None, axis_name: str = "batch") -> Mesh:
    """A 1-D mesh over the first ``n_devices`` devices (default: all)."""
    devices = jax.devices()
    if n_devices is not None:
        if n_devices > len(devices):
            # Silent truncation would run at a fraction of the intended
            # parallelism with the batch-divisibility check validating
            # against the wrong mesh size.
            raise ValueError(
                f"requested a {n_devices}-device mesh but only "
                f"{len(devices)} devices are available"
            )
        devices = devices[:n_devices]
    return Mesh(np.asarray(devices), (axis_name,))


def shard_batch(x: jax.Array, mesh: Mesh, axis_name: str = "batch") -> jax.Array:
    """Place a (B, ...) array with its leading axis sharded over the mesh."""
    spec = P(axis_name, *([None] * (x.ndim - 1)))
    return jax.device_put(x, NamedSharding(mesh, spec))


def sharded_flow(
    prev_batch: jax.Array,
    next_batch: jax.Array,
    config,
    mesh: Mesh,
    axis_name: str = "batch",
) -> jax.Array:
    """Dense flow for a batch of frame pairs, sharded over ``mesh``.

    Model-generic: the config type picks the model (``LKConfig`` /
    ``HSConfig`` / ``FBConfig``), like the streaming API.

    Args:
      prev_batch / next_batch: (B, H, W) planar grayscale; B must be divisible
        by the mesh axis size.
    Returns: (B, H, W, 2) flow, sharded the same way.
    """
    b = prev_batch.shape[0]
    n = mesh.shape[axis_name]
    if b % n != 0:
        raise ValueError(f"batch {b} not divisible by mesh axis size {n}")
    prev_s = shard_batch(prev_batch, mesh, axis_name)
    next_s = shard_batch(next_batch, mesh, axis_name)
    return _sharded_flow_jit(config, mesh, axis_name)(prev_s, next_s)


@functools.lru_cache(maxsize=128)
def _sharded_flow_jit(config, mesh: Mesh, axis_name: str):
    # Cached per (config, mesh) so one-call-per-pair serving
    # loops reuse the traced/compiled program instead of retracing a fresh
    # partial each call.
    in_spec = NamedSharding(mesh, P(axis_name, None, None))
    out_spec = NamedSharding(mesh, P(axis_name, None, None, None))
    return jax.jit(
        functools.partial(pyramidal_flow, config=config),
        in_shardings=(in_spec, in_spec),
        out_shardings=out_spec,
    )


def sharded_pyramidal_lk(
    prev_batch: jax.Array,
    next_batch: jax.Array,
    config: LKConfig,
    mesh: Mesh,
    axis_name: str = "batch",
) -> jax.Array:
    """LK-typed alias of :func:`sharded_flow` (the original batching entry)."""
    return sharded_flow(prev_batch, next_batch, config, mesh, axis_name)


def chunked_flow(
    prev_batch: jax.Array,
    next_batch: jax.Array,
    config,
    chunk: int = 2,
) -> jax.Array:
    """Large-batch flow with the batch serialized in ``chunk``-pair steps.

    ``lax.map`` over ``chunk``-pair sub-batches bounds the program's working
    set to one chunk; use this when one program must own a large batch
    (e.g. under a DP mesh where each card's shard is still large).  Its
    speed on the GPU against whole-batch programs is not measured yet.
    """
    b = prev_batch.shape[0]
    if b % chunk != 0:
        raise ValueError(f"batch {b} not divisible by chunk {chunk}")
    lead = prev_batch.shape[1:]
    pc = prev_batch.reshape((b // chunk, chunk) + lead)
    nc = next_batch.reshape((b // chunk, chunk) + lead)
    out = _chunked_flow_jit(config)(pc, nc)
    return out.reshape((b,) + lead + (2,))


@functools.lru_cache(maxsize=128)
def _chunked_flow_jit(config):
    # One cached jit wrapper per config; jit's own cache
    # handles shape variation.  Without this every serving-loop call paid a
    # full eager lax.map retrace of the whole pipeline.
    return jax.jit(
        lambda pc, nc: jax.lax.map(
            lambda pn: pyramidal_flow(pn[0], pn[1], config), (pc, nc)
        )
    )
