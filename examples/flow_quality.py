"""Flow with quality signals: Farnebäck flow + occlusion + confidence masks.

Run: python examples/flow_quality.py  (CPU or GPU)
"""
import numpy as np

import jax.numpy as jnp

import cuda_optical_flow_2_tpu as of
from cuda_optical_flow_2_tpu.models import (
    FBConfig,
    confidence_mask,
    consistent_flow,
)
from cuda_optical_flow_2_tpu.utils import io, viz


def main():
    frames = io.synthetic_sequence(2, 240, 320, velocity=(2.0, 1.0))
    prev = jnp.asarray(frames[0].astype(np.float32))
    nxt = jnp.asarray(frames[1].astype(np.float32))

    cfg = FBConfig(levels=3, iterations=2)
    flow, occluded = consistent_flow(prev, nxt, cfg)
    trusted = confidence_mask(prev, of.LKConfig(window=15), threshold=1.0)

    flow_np = np.asarray(flow)
    occ = np.asarray(occluded)
    conf = np.asarray(trusted)
    good = conf & ~occ
    print("median flow:", np.median(flow_np[30:-30, 30:-30], axis=(0, 1)))
    print(f"trusted pixels: {good.mean():.1%} "
          f"(occluded {occ.mean():.1%}, low-texture {(~conf).mean():.1%})")

    viz.write_png("/tmp/flow_quality.png", viz.flow_to_color(flow_np))
    viz.write_png("/tmp/flow_quality_mask.png", (good * 255).astype(np.uint8))
    print("wrote /tmp/flow_quality.png and _mask.png")


if __name__ == "__main__":
    main()
