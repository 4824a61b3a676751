"""Minimal example: dense flow for one frame pair, written as a color PNG.

Run: python examples/basic.py  (CPU or GPU)
"""
import numpy as np

import cuda_optical_flow_2_tpu as of
from cuda_optical_flow_2_tpu.utils import io, viz


def main():
    frames = io.synthetic_sequence(2, 480, 640, velocity=(3.0, 1.0))
    prev, nxt = frames[0].astype(np.float32), frames[1].astype(np.float32)

    config = of.LKConfig(levels=4, window=15, temporal_kernel="gauss3")
    flow = np.asarray(of.pyramidal_lk_jit(prev, nxt, config))

    print("median flow:", np.median(flow[40:-40, 40:-40], axis=(0, 1)))
    viz.write_png("/tmp/flow_basic.png", viz.flow_to_color(flow))
    io.write_flo("/tmp/flow_basic.flo", flow)
    print("wrote /tmp/flow_basic.png and .flo")


if __name__ == "__main__":
    main()
