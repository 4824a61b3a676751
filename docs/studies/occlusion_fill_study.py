"""Occlusion flow fill-in study (round 5).

Flow in occluded regions is unknowable from two frames; every family
extrapolates there (ACCURACY: layered motion — unmatched EPE 1.6-5.7 px
while matched sits at 0.03-0.3).  Downstream consumers (interpolation,
tracking hand-off, compositing) still want best-effort values, so this
study develops ``models.consistency.fill_occluded_flow``.

Findings on the layered benchmark (TV-L1 flow, true masks):

1. **Plain two-sided diffusion barely helps** (disk 2.64 -> 2.51): it
   mixes the occluder's and occludee's flows, and the mix is as wrong as
   the extrapolation it replaces.
2. **The information is all in side selection.**  An oracle fill from the
   background (occludee) side alone reaches 0.46 on the disk case — a
   5.7x gap that no amount of smoothing closes.
3. **The occluder identifies itself: its flow points INTO the band.**
   Weighting each source by exp(-beta * max(0, f . n_inward)) turns the
   diffusion's per-step normalization into a local softmin over the
   inward projection.  At the shipped defaults this yields
   disk 2.64 -> 1.84, bar 4.37 -> 3.15, two-disks 1.76 -> 0.83 —
   a 28-53 % unmatched-EPE reduction on every case, with matched pixels
   bit-identical.
4. **Beta is content-coupled beyond ~1**: larger values trade cases
   non-monotonically (bar swings 2.4 -> 3.8 -> 1.2 across beta 1/4/8 in
   the prototype sweep) because the hard-exclusion regime interacts with
   normal-estimate noise at corners; the default stays in the monotone
   regime.  The oracle gap (1.84 vs 0.46 on disk) is the cost of
   estimating the side from geometry alone — a learned or
   segmentation-based selector is the known next step, out of scope.
5. **Detected masks shrink the gains with mask quality** (disk 2.21 with
   occlusion_mask on TV-L1 flow vs 1.84 with truth in the prototype) —
   run the cycle check on TV-L1 flow (the layered study's detector
   recommendation) before filling.

Run: python docs/studies/occlusion_fill_study.py     (CPU, ~4 min)
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

from cuda_optical_flow_2_tpu.models import consistency, tvl1  # noqa: E402
from cuda_optical_flow_2_tpu.utils.layered import (  # noqa: E402
    Layer,
    layered_scene,
)

H, W = 192, 256
MARGIN = 16


def make_cases():
    return [
        ("disk", layered_scene(
            H, W, bg_flow=(-2.0, 1.0),
            layers=[Layer("disk", (96.0, 128.0), 45.0, (3.0, 1.0))],
            seed=3)),
        ("bar", layered_scene(
            H, W, bg_flow=(-3.0, 0.0),
            layers=[Layer("rect", (96.0, 128.0), (120.0, 22.0), (4.0, 0.0))],
            seed=7)),
        ("two", layered_scene(
            H, W, bg_flow=(0.5, 0.5),
            layers=[
                Layer("disk", (70.0, 80.0), 34.0, (2.5, -1.5)),
                Layer("disk", (120.0, 180.0), 30.0, (-1.5, 2.5)),
            ],
            seed=5)),
    ]


def main() -> None:
    interior = np.zeros((H, W), bool)
    interior[MARGIN:-MARGIN, MARGIN:-MARGIN] = True
    cfg = tvl1.TVL1Config(levels=4, max_displacement=8)

    def run(p, n):
        return tvl1.pyramidal_tvl1(
            jnp.asarray(p, jnp.float32), jnp.asarray(n, jnp.float32), cfg
        )

    print("unmatched (occluded-band) interior EPE, TV-L1 flow:")
    hdr = f"{'case':<6} {'raw':>7} {'fill(true)':>11} {'fill(det)':>10} {'occ%':>5}"
    print(hdr)
    print("-" * len(hdr))
    for name, sc in make_cases():
        fw = run(sc.prev, sc.nxt)
        bw = run(sc.nxt, sc.prev)
        det = np.asarray(
            consistency.occlusion_mask(fw, bw, alpha=0.01, beta=0.5)
        )

        def epe(f):
            d = np.asarray(f) - sc.flow
            return float(
                np.hypot(d[..., 0], d[..., 1])[sc.occ & interior].mean()
            )

        raw = epe(fw)
        filled_true = epe(
            consistency.fill_occluded_flow(fw, jnp.asarray(sc.occ))
        )
        filled_det = epe(
            consistency.fill_occluded_flow(fw, jnp.asarray(det))
        )
        print(
            f"{name:<6} {raw:>7.3f} {filled_true:>11.3f} "
            f"{filled_det:>10.3f} {100 * sc.occ[interior].mean():>5.1f}"
        )


if __name__ == "__main__":
    from cuda_optical_flow_2_tpu.utils.profiling import enable_compile_cache

    enable_compile_cache()
    main()
