"""DIS accuracy-gap isolation (round 4, VERDICT r3 item 5).

Round 3 left DIS trailing its anchor 4.5x on natural texture (ours 0.059 vs
OpenCV DISOpticalFlow 0.013 vs-truth) with no study isolating which
deliberate substitution costs the accuracy.  The candidates named by the
VERDICT: stride-1 grid vs error-weighted patch densification, quadratic vs
Charbonnier refinement, dt3 temporal vs the paper's raw difference.

This study sweeps each knob independently on the opencv_parity cases.
Headline finding: **none of the named substitutions is the driver — the
refinement smoothness weight was.**  The round-3 default
``refine_alpha=10`` under-smoothed the variational refinement; at the
anchor's own default (cv2.VariationalRefinement alpha = 20) every case
improves ~2x (natural 0.059 -> 0.029; smooth 0.026 -> 0.010; rotate
0.042 -> 0.035), and alpha=40 reaches 0.012 on natural — at/below the
anchor's 0.013.  DISConfig.refine_alpha now defaults to 20.0 (the
conservative, anchor-matching value: our quadratic penalty blurs real
motion discontinuities harder than cv2's Charbonnier at large alpha, and
the harness has no discontinuities to show that cost).

Secondary findings: the box window's transfer sidelobes (the flagship's
round-4 mechanism, docs/studies/lk_window_study.py) cost DIS ~20 % on
natural texture (``window_weights="gauss"``: 0.059 -> 0.048) but HURT the
rotation case under mean normalization, so DIS keeps the box default with
the knob exposed; ``temporal_kernel="delta"`` (the paper-faithful raw
difference) remains 4x worse, as measured in round 2; iterations and
pyramid depth are flat.

Run: python docs/studies/dis_gap_study.py          (CPU, ~4 min)
"""

from __future__ import annotations

import dataclasses

import numpy as np


import jax.numpy as jnp  # noqa: E402

import opencv_parity as anchor_study  # noqa: E402

from cuda_optical_flow_2_tpu.models import dis  # noqa: E402


_R3_DEFAULT_ALPHA = 10.0  # the under-smoothing round-3 default
BASE = dis.DISConfig(
    use_pallas=False, max_displacement=8, refine_alpha=_R3_DEFAULT_ALPHA
)


def run(prev, nxt, cfg) -> np.ndarray:
    return np.asarray(
        dis.pyramidal_dis(
            jnp.asarray(prev, jnp.float32), jnp.asarray(nxt, jnp.float32), cfg
        )
    )


def main() -> None:
    cases = anchor_study.make_cases()
    print("baseline (DISConfig defaults, the round-3 numbers):")
    for name, prev, nxt, truth in cases:
        e = anchor_study.interior_epe(run(prev, nxt, BASE), truth)
        print(f"  {name:<26} {e:.4f}")
    print()

    name, prev, nxt, truth = cases[2]  # translate/natural — the 4.5x case
    sweeps = [
        ("refine_alpha", [10.0, 20.0, 40.0, 80.0]),
        ("window_weights", ["box", "tri", "gauss"]),
        ("iterations", [1, 2, 4]),
        ("refine_iterations", [0, 5, 10]),
        ("temporal_kernel", ["dt3", "delta", "gauss3"]),
        ("window", [5, 9, 13]),
    ]
    print(f"single-knob sweeps on {name} (others at defaults):")
    for field, values in sweeps:
        for v in values:
            cfg = dataclasses.replace(BASE, **{field: v})
            e = anchor_study.interior_epe(run(prev, nxt, cfg), truth)
            mark = " *" if getattr(BASE, field) == v else ""
            print(f"  {field}={v!s:<7} {e:.4f}{mark}")
        print()

    print("alpha across all cases (20 = the new default = cv2's):")
    for alpha in (10.0, 20.0, 40.0):
        es = [
            anchor_study.interior_epe(
                run(c[1], c[2], dataclasses.replace(BASE, refine_alpha=alpha)),
                c[3],
            )
            for c in cases
        ]
        mark = "  <- new default" if alpha == 20.0 else ""
        print(
            f"  alpha={alpha:<5} smooth={es[0]:.4f} rotate={es[1]:.4f} "
            f"natural={es[2]:.4f}{mark}"
        )


if __name__ == "__main__":
    from cuda_optical_flow_2_tpu.utils.profiling import enable_compile_cache

    enable_compile_cache()
    import os
    import sys

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    main()
