"""Multi-host scale-out scaffolding.

The reference is strictly single-process (SURVEY.md section 2.5); within one
host this framework scales over NVLink via the mesh APIs in
parallel/batching.py / parallel/spatial.py.  This module adds the multi-host
layer for when the frame stream outgrows one host's cards: standard JAX
multi-process setup (`jax.distributed`) plus a helper that builds the global
mesh and per-host input feeding for batch (DP) sharding — frame pairs are
independent, so DP never communicates across hosts; only compilation-time
coordination and any cross-host reductions the caller adds ride it.

Layout doctrine (jax-ml.github.io/scaling-book): keep the batch axis outer
and aligned to hosts so each host feeds only its local shard
(``host_local_batch``), and keep any spatial (TP) axis INSIDE one host's
devices so halo ppermutes stay on NVLink — `make_global_mesh` orders the axes
accordingly.

Validated in-process (single-host initialize + global mesh over local
devices, tests/test_parallel.py); on a real multi-host cluster pass the
coordinator address per the standard JAX runbook.
"""

from __future__ import annotations

import functools

import numpy as np

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

__all__ = [
    "initialize",
    "make_global_mesh",
    "host_local_batch",
    "sharded_flow_from_local",
]


_initialized = False


def initialize(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> None:
    """Initialize JAX multi-process runtime (no-op if already initialized).

    With no arguments JAX autodetects a cluster from its environment
    variables (SLURM, Open MPI, ...); elsewhere pass all three arguments.
    Single-process callers may simply skip this.
    """
    # Idempotency via runtime state, not error-message matching: a repeated
    # call is a no-op when the distributed client already exists.  The
    # private-attribute probe is belt; the module-level flag is suspenders
    # for JAX versions that move jax._src.distributed.global_state (a second
    # initialize() in THIS process is the case the flag must survive).
    global _initialized
    if _initialized:
        return
    state = getattr(
        getattr(jax._src, "distributed", None), "global_state", None
    )
    if state is not None and getattr(state, "client", None) is not None:
        _initialized = True
        return
    try:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
    except RuntimeError as e:
        # Final fallback for the case the private global_state probe missed
        # (e.g. jax._src.distributed moved AND another library initialized
        # the client first): JAX raises "Distributed initialization should
        # only be called once" / "already initialized" variants.
        if "alread" not in str(e) and "only be called once" not in str(e):
            raise
    _initialized = True


def make_global_mesh(
    batch_axis: str = "batch", space_axis: str | None = None
) -> Mesh:
    """Global mesh over ALL processes' devices.

    The batch axis spans hosts (DP has no collectives); when
    ``space_axis`` is given, the spatial axis is sized to one host's local
    device count so every halo exchange stays on NVLink.
    """
    devices = np.asarray(jax.devices())
    if space_axis is None:
        return Mesh(devices, (batch_axis,))
    local = jax.local_device_count()
    if devices.size % local != 0:
        raise ValueError(
            f"{devices.size} devices not divisible by local count {local}"
        )
    return Mesh(devices.reshape(-1, local), (batch_axis, space_axis))


def host_local_batch(
    global_batch: int, mesh: Mesh, batch_axis: str = "batch"
) -> tuple[int, int]:
    """(host's batch slice size, host's offset) for feeding a global batch.

    Each process materializes only its own frame pairs:
    ``jax.make_array_from_process_local_data`` assembles the global array.
    """
    n = mesh.shape[batch_axis]
    if global_batch % n != 0:
        raise ValueError(f"batch {global_batch} not divisible by {n}")
    per = global_batch // jax.process_count()
    return per, per * jax.process_index()


def sharded_flow_from_local(
    local_prev,
    local_nxt,
    config,
    mesh: Mesh,
    batch_axis: str = "batch",
) -> jax.Array:
    """DP flow over a multi-process mesh from per-host LOCAL batches.

    The multi-host twin of parallel.batching.sharded_flow: each process
    passes only its own (B_local, H, W) frame pairs (B_local = the
    ``host_local_batch`` slice); the global array is assembled with
    ``jax.make_array_from_process_local_data`` — no frame crosses hosts, and
    the DP computation itself has no collectives.  Returns the global
    (B_global, H, W, 2) flow, of which this process can fetch its
    ``addressable_shards``.
    """
    local_prev = np.asarray(local_prev, np.float32)
    local_nxt = np.asarray(local_nxt, np.float32)
    gshape = (local_prev.shape[0] * jax.process_count(),) + local_prev.shape[1:]
    sh = NamedSharding(mesh, P(batch_axis, None, None))
    gp = jax.make_array_from_process_local_data(sh, local_prev, gshape)
    gn = jax.make_array_from_process_local_data(sh, local_nxt, gshape)
    return _global_flow_jit(config, mesh, batch_axis)(gp, gn)


@functools.lru_cache(maxsize=128)
def _global_flow_jit(config, mesh: Mesh, batch_axis: str):
    # Cached per (config, mesh) so per-step multihost calls don't retrace.
    from cuda_optical_flow_2_tpu.models import pyramidal_flow

    sh = NamedSharding(mesh, P(batch_axis, None, None))
    return jax.jit(
        functools.partial(pyramidal_flow, config=config),
        in_shardings=(sh, sh),
        out_shardings=NamedSharding(mesh, P(batch_axis, None, None, None)),
    )
