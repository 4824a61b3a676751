"""Scene-cut recovery threshold robustness (round 5).

The RecoveryConfig defaults (ratio=0.7, seed_floor=0.25) were set from
two synthetic sequences; this study checks the separation the threshold
relies on across a grid of content conditions: texture class x velocity
x sensor noise x cut type.  For each condition it reports the
acquisition-check statistic r_seed/r_zero (models/streaming.step: mean
photometric residual at the deepest carried level under the seed warp vs
under zero flow) in the two states the policy must separate:

* LOCKED: warm tracking on the pre-cut scene (sampled at the 3rd pair,
  after acquisition) — must stay BELOW the threshold or valid seeds get
  dropped (a throughput-only false positive).
* STALE: the first post-cut pair whose frames are both from the new
  scene but whose seed is the old scene's motion — must sit ABOVE the
  threshold or lock is lost (the accuracy-destroying false negative).

Committed-run summary (54 condition rows): **locked max 0.731, harmful
stale min 0.818, threshold 0.7.**  In detail: locked ratios sit at
0.27-0.46 on banded texture, 0.54-0.56 on smooth texture, and climb to
0.67-0.73 on LOW-CONTRAST DIAGONAL content (quarter contrast, (2,2)
motion, noise) — i.e. the 0.7 threshold is EXCEEDED by some locked
samples on the hardest content class.  That is the designed failure
direction: a locked seed dropped is a false positive, and the stream
degrades to the deep (cold-accurate) solve at lower fps — no accuracy is
lost.  Every harmful stale sample stays above 0.818 (smooth texture cuts
reach 1.4-1.6; the tightest are low-contrast 5-px cuts at 0.845-0.87),
so no false negative appears anywhere in the grid; raising the threshold
toward the 0.73/0.818 midpoint would trade the low-contrast throughput
fallback for a thinner lock-loss margin, and lock loss is the
unrecoverable side.  The static-scene ratio is ~1.07 as predicted (seed
~= 0 ~= zero flow explains nothing either way) with seed magnitude
0.003 px << seed_floor 0.25 — seed_floor, not the ratio, is what keeps
static streams off the deep path.

Run: python docs/studies/recovery_threshold_study.py   (CPU, ~3 min)
"""

from __future__ import annotations

import os
import sys

sys.path.insert(
    0,
    os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", ".."),
)

import numpy as np


import jax.numpy as jnp  # noqa: E402

import cuda_optical_flow_2_tpu as of  # noqa: E402
from cuda_optical_flow_2_tpu.models import streaming  # noqa: E402
from cuda_optical_flow_2_tpu.ops.resize import downsample_flow  # noqa: E402
from cuda_optical_flow_2_tpu.ops.warp import warp_bilinear  # noqa: E402

H, W = 96, 128


def banded(rng):
    base = rng.random((H, W)).astype(np.float32)
    t = np.pad(base, 1, mode="wrap")
    t = sum(t[i:i + H, j:j + W] for i in range(3) for j in range(3)) / 9
    return (t - t.min()) / (np.ptp(t) + 1e-6) * 255


def smooth(rng):
    t = banded(rng)
    for _ in range(6):
        tp = np.pad(t, 1, mode="edge")
        t = sum(tp[i:i + H, j:j + W] for i in range(3) for j in range(3)) / 9
    return (t - t.min()) / (np.ptp(t) + 1e-6) * 255


def lowc(rng):
    return banded(rng) * 0.25 + 96.0  # quarter contrast


TEXTURES = {"banded": banded, "smooth": smooth, "lowc": lowc}
CUTS = {
    "reverse": lambda v: (-v[0], v[1]),
    "orthogonal": lambda v: (v[1], -v[0]) if v[1] else (0.0, v[0]),
    "tex-same-motion": lambda v: v,  # content changes, motion does not
}


def ratios(tex_fn, vel, noise, cut, rng):
    """(locked_ratio, stale_ratio) for one condition."""
    tex_a, tex_b = tex_fn(rng), tex_fn(rng)
    vx, vy = vel
    cvx, cvy = CUTS[cut]((vx, vy))

    def frames_of(tex, v, k, start=0):
        out = []
        for t in range(k):
            f = np.roll(
                np.roll(tex, -int(round(v[0] * (start + t))), axis=1),
                -int(round(v[1] * (start + t))), axis=0,
            )
            if noise:
                f = f + rng.normal(0, noise, f.shape)
            out.append(f.astype(np.float32))
        return out

    seq = frames_of(tex_a, (vx, vy), 5) + frames_of(tex_b, (cvx, cvy), 3)
    cfg = of.LKConfig(levels=1, window=11, iterations=2, use_pallas=False)
    rec = streaming.RecoveryConfig(levels=3)
    carry = streaming._carry_config(cfg, rec)
    state = streaming.init_state(jnp.asarray(seq[0]), cfg, rec)
    locked = stale = None
    for i in range(1, len(seq)):
        pyr = streaming._preprocess(jnp.asarray(seq[i]), carry)
        if state.flow is not None:
            pc, nc = state.pyramid[-1], pyr[-1]
            sc = downsample_flow(state.flow, nc.shape[-2:])
            r_seed = float(jnp.mean(jnp.abs(warp_bilinear(nc, sc) - pc)))
            r_zero = float(jnp.mean(jnp.abs(nc - pc)))
            r = r_seed / max(r_zero, 1e-9)
            if i == 3:
                locked = r
            if i == 6:  # first both-new-scene pair (cut pair is i == 5)
                stale = r
        state, _ = streaming.step(state, jnp.asarray(seq[i]), cfg, True, rec)
    return locked, stale


def main() -> None:
    rng = np.random.default_rng(0)
    locked_all, stale_all, stale_harmful = [], [], []
    hdr = (f"{'texture':<8} {'vel':<9} {'noise':>5} {'cut':<16} "
           f"{'locked':>7} {'stale':>7}")
    print(hdr)
    print("-" * len(hdr))
    for tname, tex_fn in TEXTURES.items():
        for vel in ((3.0, 0.0), (5.0, 0.0), (2.0, 2.0)):
            for noise in (0.0, 3.0):
                for cut in CUTS:
                    lr, sr = ratios(tex_fn, vel, noise, cut, rng)
                    locked_all.append(lr)
                    stale_all.append(sr)
                    if cut != "tex-same-motion":
                        stale_harmful.append(sr)
                    print(f"{tname:<8} {str(vel):<9} {noise:>5.1f} "
                          f"{cut:<16} {lr:>7.3f} {sr:>7.3f}")
    # static scene: the ratio test never fires (seed_floor keeps ~0 seeds)
    static = banded(np.random.default_rng(9))
    seq = [static + np.random.default_rng(i).normal(0, 2, static.shape)
           .astype(np.float32) for i in range(4)]
    cfg = of.LKConfig(levels=1, window=11, iterations=2, use_pallas=False)
    rec = streaming.RecoveryConfig(levels=3)
    carry = streaming._carry_config(cfg, rec)
    state = streaming.init_state(jnp.asarray(seq[0]), cfg, rec)
    state, _ = streaming.step(state, jnp.asarray(seq[1]), cfg, True, rec)
    pyr = streaming._preprocess(jnp.asarray(seq[2]), carry)
    sc = downsample_flow(state.flow, pyr[-1].shape[-2:])
    seed_mag = float(jnp.mean(jnp.abs(sc)))
    r = float(jnp.mean(jnp.abs(
        warp_bilinear(pyr[-1], sc) - state.pyramid[-1]
    ))) / float(jnp.mean(jnp.abs(pyr[-1] - state.pyramid[-1])))
    print(f"\nstatic scene: ratio {r:.3f} (~1 as predicted), "
          f"seed magnitude {seed_mag:.3f} px < seed_floor 0.25 -> "
          f"ratio test never consulted")
    print(
        f"\nlocked max {max(locked_all):.3f}  |  stale min "
        f"{min(stale_all):.3f} (harmful cuts only: "
        f"{min(stale_harmful):.3f})  |  threshold 0.7"
    )


if __name__ == "__main__":
    from cuda_optical_flow_2_tpu.utils.profiling import enable_compile_cache

    enable_compile_cache()
    main()
