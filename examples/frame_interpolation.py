"""Flow-based frame interpolation: synthesize the midpoint between two frames.

The classic downstream application of dense flow (slow-motion / frame-rate
upconversion): estimate bidirectional flow, backward-warp each frame halfway
along its flow, and blend — occluded pixels (forward-backward inconsistent)
fall back to the better-exposed side.  Everything jits into ONE device
program: two pyramidal flow estimates, two warps, the occlusion test and the
blend.

Run: python examples/frame_interpolation.py  (CPU or GPU)
"""
import numpy as np

import jax
import jax.numpy as jnp

import cuda_optical_flow_2_tpu as of
from cuda_optical_flow_2_tpu.models import FBConfig, fb_consistency
from cuda_optical_flow_2_tpu.ops.warp import warp_bilinear
from cuda_optical_flow_2_tpu.utils import io, viz


def interpolate_midpoint(prev, nxt, config):
    """Synthesize the frame halfway between ``prev`` and ``nxt``.

    Backward-warp semantics (out(x) = src(x + flow)): the midpoint pixel x
    came from prev at x + 0.5*F_bw(x) and from nxt at x + 0.5*F_fw(x) (the
    flows are sampled at x — the standard splat-free approximation, fine at
    half-step for smooth motion).  Cycle-inconsistent pixels take the side
    whose flow is locally trustworthy — the one with the smaller cycle
    residual — instead of a ghosted blend.
    """
    flow_fw = of.pyramidal_flow(prev, nxt, config)  # prev -> nxt
    flow_bw = of.pyramidal_flow(nxt, prev, config)  # nxt -> prev
    from_prev = warp_bilinear(prev, 0.5 * flow_bw)
    from_next = warp_bilinear(nxt, 0.5 * flow_fw)
    # Cycle residual of each field: res_fw gates from_next (built on F_fw),
    # res_bw gates from_prev (built on F_bw).
    res_fw = fb_consistency(flow_fw, flow_bw)
    res_bw = fb_consistency(flow_bw, flow_fw)
    consistent = jnp.maximum(res_fw, res_bw) < 1.0
    fallback = jnp.where(res_bw <= res_fw, from_prev, from_next)
    mid = jnp.where(consistent, 0.5 * (from_prev + from_next), fallback)
    return mid, flow_fw


def main():
    # three frames of known constant motion: frame 1 IS the ground-truth
    # midpoint of frames 0 and 2
    frames = io.synthetic_sequence(3, 240, 320, velocity=(2.0, 1.0))
    f0, f1, f2 = (jnp.asarray(f.astype(np.float32)) for f in frames)

    cfg = FBConfig(levels=3, iterations=2)
    mid, flow = jax.jit(lambda a, b: interpolate_midpoint(a, b, cfg))(f0, f2)

    inner = (slice(30, -30), slice(30, -30))
    err = np.abs(np.asarray(mid)[inner] - np.asarray(f1)[inner])
    base = np.abs(np.asarray(f0)[inner] - np.asarray(f1)[inner])
    print(f"midpoint synthesis mean error: {err.mean():.2f} gray levels "
          f"(naive frame-hold baseline: {base.mean():.2f})")
    assert err.mean() < 0.25 * base.mean(), "interpolation should beat hold"

    viz.write_png("/tmp/interp_mid.png",
                  np.clip(np.asarray(mid), 0, 255).astype(np.uint8))
    viz.write_png("/tmp/interp_flow.png", viz.flow_to_color(np.asarray(flow)))
    print("wrote /tmp/interp_mid.png and /tmp/interp_flow.png")


if __name__ == "__main__":
    main()
