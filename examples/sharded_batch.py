"""Data-parallel example: a frame-pair batch sharded over every device.

Run on CPU with a virtual mesh:
    XLA_FLAGS=--xla_force_host_platform_device_count=8 \
        python examples/sharded_batch.py
(on a multi-GPU host it shards over the real cards unchanged).
"""
import numpy as np

import jax

import cuda_optical_flow_2_tpu as of
from cuda_optical_flow_2_tpu import parallel
from cuda_optical_flow_2_tpu.utils import io


def main():
    n = len(jax.devices())
    frames = io.synthetic_sequence(2 * n + 1, 128, 160, velocity=(2.0, 1.0))
    prev = np.stack(frames[:-1]).astype(np.float32)
    nxt = np.stack(frames[1:]).astype(np.float32)

    mesh = parallel.make_mesh()
    config = of.LKConfig(levels=3, window=11, temporal_kernel="gauss3")
    flow = parallel.sharded_pyramidal_lk(
        jax.numpy.asarray(prev[: 2 * n]), jax.numpy.asarray(nxt[: 2 * n]),
        config, mesh,
    )
    print(f"{2 * n} pairs over {n} devices ->", flow.shape, flow.sharding)


if __name__ == "__main__":
    main()
