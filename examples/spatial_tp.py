"""Tensor-parallel example: ONE frame's rows sharded across the mesh with
ppermute halo exchange (for frames too large for a single chip).

Run on CPU with a virtual mesh:
    XLA_FLAGS=--xla_force_host_platform_device_count=8 \
        python examples/spatial_tp.py
"""
import numpy as np

import jax
import jax.numpy as jnp

import cuda_optical_flow_2_tpu as of
from cuda_optical_flow_2_tpu import parallel
from cuda_optical_flow_2_tpu.utils import io


def main():
    n = len(jax.devices())
    h = 128 * n  # rows divisible by n_shards * 2^(levels-1)
    frames = io.synthetic_sequence(2, h, 256, velocity=(2.0, 1.0))
    mesh = parallel.make_mesh(axis_name="space")
    config = of.LKConfig(levels=3, window=11, temporal_kernel="gauss3",
                         max_displacement=8, use_pallas=False)
    flow = parallel.spatial_pyramidal_lk(
        jnp.asarray(frames[0].astype(np.float32)),
        jnp.asarray(frames[1].astype(np.float32)),
        config, mesh,
    )
    f = np.asarray(flow)
    print(f"one {h}x256 frame over {n} row shards ->", flow.shape)
    print("median flow:", np.median(f[64:-64, 32:-32], axis=(0, 1)))

    # The other model families shard the same way (model-generic TP):
    from cuda_optical_flow_2_tpu.models import FBConfig

    fb_flow = parallel.spatial_pyramidal_fb(
        jnp.asarray(frames[0].astype(np.float32)),
        jnp.asarray(frames[1].astype(np.float32)),
        FBConfig(levels=2, iterations=2, winsize=11, max_displacement=8),
        mesh,
    )
    print("farneback median:",
          np.median(np.asarray(fb_flow)[64:-64, 32:-32], axis=(0, 1)))


if __name__ == "__main__":
    main()
