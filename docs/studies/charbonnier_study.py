"""Charbonnier (robust) DIS variational refinement study (round 5,
VERDICT r4 item 2).

Round 4 left DIS's accuracy capped by a measured substitution: the
quadratic refinement penalty reaches the cv2 anchor on natural texture
only at ``refine_alpha=40`` (0.012 vs anchor 0.013,
docs/studies/dis_gap_study.py), but the quadratic smoothness term blurs
real motion discontinuities harder as alpha grows, so the default stayed
at the anchor's alpha=20 and the smooth-texture accuracy stayed on the
table.  The paper's Charbonnier penalties decouple that tradeoff: the
smoothness weight collapses where |grad w| is large (motion boundaries)
and the data weight collapses where the residual is large (occlusions),
so a big alpha smooths textureless interiors without dragging boundaries.

This study measures the implementation added in round 5
(``DISConfig.refine_penalty="charbonnier"`` — normalized lagged-diffusivity
weights recomputed once per time-tiled chunk, kernels/hs_sweep.py):

1. the smooth-truth anchor case (natural texture translation,
   docs/studies/opencv_parity.py) — does Charbonnier at large alpha reach
   the quadratic alpha=40 / anchor level?
2. the layered-motion benchmark's bar case (true discontinuity +
   occlusion truth, docs/studies/layered_motion_study.py) — what happens
   to the band-6 EPE and the boundary blur width at the same settings?

Headline result (committed run, round 5): at the default 5 sweeps,
``charbonnier a=40 es=0.1 ed=10`` reaches anchor-level natural-texture
EPE (0.0119 <= anchor 0.013, = quadratic a=40's 0.0118) while keeping the
bar boundary as sharp as the quadratic a=20 default (blur 3.99 vs 4.01
px, band-6 EPE 2.129 vs 2.141) — both sides of the round-4 tradeoff at
once.  Deep refinement (20 sweeps) makes the decoupling unambiguous: at
alpha=80 both penalties hit natural EPE 0.0025, but quadratic blurs the
bar step to 4.67 px (band 2.172) while Charbonnier holds 3.95 px (band
1.988) and the best overall bar EPE of the sweep (0.278).  The quadratic
a->boundary-damage trend (4.01 -> 4.16 -> 4.67 px for a=20/40/80) simply
does not appear under Charbonnier at fixed es.

Default decision: a robust sweep does more work per sweep than a
quadratic one (its cost on the GPU is not measured yet).  The default
stays ``quadratic``/alpha=20 for bit-comparable continuity
with three rounds of anchor tables; the RECOMMENDED accuracy operating
point is ``refine_penalty="charbonnier", refine_alpha=40,
refine_eps_data=10`` — strictly better than the default on every
measured accuracy axis.

**Robust HS (same mechanism, second family).**  HSConfig.penalty exposes
the identical kernel mode for Horn-Schunck itself — a fast "TV-lite"
operating point.  Sweep on the layered bar/disk cases (this file's HS
section): the robust penalty DOMINATES the quadratic alpha frontier —
charb a=40 reaches bar matched 0.257 / band 2.17, numbers quadratic HS
never reaches at any alpha (best 0.286 / 2.30 at a=60, worsening beyond)
— and the optimal alpha doubles vs quadratic (the sub-1 weights reduce
effective smoothing).  Beyond a=40 robust HS degrades (the collapsed
data weight under-constrains occluded regions).  Boundary quality sits
between HS and TV-L1 (TV-L1 bar band 1.36 remains the champion); its cost
on the GPU is not measured yet.  Default stays quadratic a=10;
recommended robust point: penalty="charbonnier", alpha=40.

Run: python docs/studies/charbonnier_study.py      (CPU, ~5 min)
"""

from __future__ import annotations

import dataclasses
import os
import sys

sys.path.insert(
    0,
    os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", ".."),
)

import numpy as np


import jax.numpy as jnp  # noqa: E402

import layered_motion_study as layered  # noqa: E402
import opencv_parity as anchor_study  # noqa: E402

from cuda_optical_flow_2_tpu.models import dis  # noqa: E402

BASE = dis.DISConfig(use_pallas=False, max_displacement=8)


def run(prev, nxt, cfg) -> np.ndarray:
    return np.asarray(
        dis.pyramidal_dis(
            jnp.asarray(prev, jnp.float32), jnp.asarray(nxt, jnp.float32), cfg
        )
    )


def variants():
    yield "quadratic a=20 (default)", BASE
    yield "quadratic a=40", dataclasses.replace(BASE, refine_alpha=40.0)
    yield "quadratic a=80", dataclasses.replace(BASE, refine_alpha=80.0)
    for alpha in (20.0, 40.0, 80.0):
        for es in (0.05, 0.1, 0.25):
            yield (
                f"charbonnier a={alpha:g} es={es:g}",
                dataclasses.replace(
                    BASE,
                    refine_penalty="charbonnier",
                    refine_alpha=alpha,
                    refine_eps_smooth=es,
                ),
            )
    # data-eps sensitivity at the recommended point
    for ed in (1.0, 10.0):
        yield (
            f"charbonnier a=40 es=0.1 ed={ed:g}",
            dataclasses.replace(
                BASE,
                refine_penalty="charbonnier",
                refine_alpha=40.0,
                refine_eps_data=ed,
            ),
        )


def bar_metrics(sc, flow):
    """(band-6 EPE, mean boundary blur width) on the layered bar case."""
    row = layered.split_epe(flow, sc)
    rows = slice(layered.MARGIN, layered.H - layered.MARGIN)
    prof = np.nanmean(flow[rows, :, 0], axis=0)
    tprof = sc.flow[rows, :, 0].mean(axis=0)
    widths = []
    for x0 in (128 - 22, 128 + 22):
        sl = slice(x0 - 15, x0 + 16)
        widths.append(np.abs(prof[sl] - tprof[sl]).sum() / 7.0)
    return row[3], float(np.mean(widths)), row[0]


def main() -> None:
    name, prev, nxt, truth = anchor_study.make_cases()[2]  # natural texture
    bar_name, sc = layered.make_cases()[2]  # bar: true discontinuity

    hdr = (
        f"{'variant':<34} {'natural':>8} {'bar epe':>8} {'band6':>7} "
        f"{'blur px':>8}"
    )
    print(f"anchor case: {name}; discontinuity case: {bar_name}")
    print(hdr)
    print("-" * len(hdr))
    for label, cfg in variants():
        e_nat = anchor_study.interior_epe(run(prev, nxt, cfg), truth)
        band6, blur, e_bar = bar_metrics(sc, run(sc.prev, sc.nxt, cfg))
        print(
            f"{label:<34} {e_nat:>8.4f} {e_bar:>8.3f} {band6:>7.3f} "
            f"{blur:>8.2f}"
        )

    # --- deep refinement: where the quadratic/robust split really opens --
    # At the default 5 sweeps the refinement barely moves boundaries (the
    # search stage dominates the bar profile).  At 20 sweeps the quadratic
    # penalty's boundary drag accumulates with alpha while Charbonnier's
    # collapsed smoothness weight protects the step.
    print()
    print("deep refinement (refine_iterations=20):")
    print(hdr)
    print("-" * len(hdr))
    deep = dataclasses.replace(BASE, refine_iterations=20)
    for label, cfg in (
        ("quadratic a=20", deep),
        ("quadratic a=40", dataclasses.replace(deep, refine_alpha=40.0)),
        ("quadratic a=80", dataclasses.replace(deep, refine_alpha=80.0)),
        (
            "charbonnier a=40 es=0.1 ed=10",
            dataclasses.replace(
                deep,
                refine_penalty="charbonnier",
                refine_alpha=40.0,
                refine_eps_data=10.0,
            ),
        ),
        (
            "charbonnier a=80 es=0.1 ed=10",
            dataclasses.replace(
                deep,
                refine_penalty="charbonnier",
                refine_alpha=80.0,
                refine_eps_data=10.0,
            ),
        ),
    ):
        e_nat = anchor_study.interior_epe(run(prev, nxt, cfg), truth)
        band6, blur, e_bar = bar_metrics(sc, run(sc.prev, sc.nxt, cfg))
        print(
            f"{label:<34} {e_nat:>8.4f} {e_bar:>8.3f} {band6:>7.3f} "
            f"{blur:>8.2f}"
        )

    # --- robust HS: the same kernel mode on the second family ------------
    from cuda_optical_flow_2_tpu.models import horn_schunck as hs

    print()
    print("robust HS on the bar case (matched-region / band-6 EPE):")
    hs_base = dict(levels=4, iterations=100, use_pallas=False,
                   max_displacement=8)
    interior = np.zeros((layered.H, layered.W), bool)
    interior[layered.MARGIN:-layered.MARGIN,
             layered.MARGIN:-layered.MARGIN] = True
    from cuda_optical_flow_2_tpu.utils.layered import boundary_band

    band = boundary_band(sc.owner, 6) & interior
    for label, kw in (
        ("HS quad a=10 (default)", {}),
        ("HS quad a=40", dict(alpha=40.0)),
        ("HS quad a=60", dict(alpha=60.0)),
        ("HS charb a=40 (recommended)",
         dict(penalty="charbonnier", alpha=40.0)),
        ("HS charb a=60", dict(penalty="charbonnier", alpha=60.0)),
    ):
        import jax.numpy as jnp

        f = np.asarray(hs.pyramidal_hs(
            jnp.asarray(sc.prev, jnp.float32),
            jnp.asarray(sc.nxt, jnp.float32),
            hs.HSConfig(**hs_base, **kw)))
        epe = np.hypot(*(f - sc.flow).transpose(2, 0, 1))
        print(f"  {label:<30} matched {epe[interior & ~sc.occ].mean():.3f} "
              f"band {epe[band].mean():.3f}")


if __name__ == "__main__":
    from cuda_optical_flow_2_tpu.utils.profiling import enable_compile_cache

    enable_compile_cache()
    main()
