"""Multi-card scaling: batch (data-parallel) and spatial (tensor-parallel).

The reference is strictly single-GPU/single-process (SURVEY.md section 2.5);
scale-out here runs over a ``jax.sharding.Mesh`` of GPUs:

* batching — frame pairs on a leading axis, sharded over the mesh; zero
  collectives (pairs are independent, BASELINE config 5).
* spatial — ONE frame's rows sharded over the mesh under ``shard_map``, every
  stencil stage exchanging halo rows with its neighbors via ``lax.ppermute``
  over NVLink (for frames too large for one card, or single-pair latency).
"""

from cuda_optical_flow_2_tpu.parallel.batching import (
    make_mesh,
    chunked_flow,
    sharded_flow,
    sharded_pyramidal_lk,
    shard_batch,
)
from cuda_optical_flow_2_tpu.parallel.spatial import (
    grid_pyramidal_lk,
    halo_exchange,
    spatial_pyramidal_lk,
    validate_spatial,
)
from cuda_optical_flow_2_tpu.parallel.multihost import (
    host_local_batch,
    make_global_mesh,
)
from cuda_optical_flow_2_tpu.parallel.spatial_models import (
    grid_pyramidal_flow,
    spatial_pyramidal_flow,
    spatial_pyramidal_dis,
    spatial_pyramidal_fb,
    spatial_pyramidal_hs,
    spatial_pyramidal_tvl1,
)

__all__ = [
    "make_mesh",
    "chunked_flow",
    "sharded_flow",
    "sharded_pyramidal_lk",
    "shard_batch",
    "grid_pyramidal_lk",
    "halo_exchange",
    "spatial_pyramidal_lk",
    "spatial_pyramidal_hs",
    "spatial_pyramidal_fb",
    "spatial_pyramidal_dis",
    "spatial_pyramidal_flow",
    "grid_pyramidal_flow",
    "spatial_pyramidal_tvl1",
    "validate_spatial",
    "make_global_mesh",
    "host_local_batch",
]
