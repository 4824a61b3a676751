"""Layered-motion benchmark: discontinuities + occlusion with exact truth.

Every truth-scored accuracy case before round 5 was a smooth global motion
field (docs/studies/opencv_parity.py: translate/rotate of textures), so the
machinery whose value shows only at motion boundaries — TV-L1's
discontinuity preservation, models/consistency occlusion masks, the Sintel
matched/unmatched EPE split — had never been scored against real occlusion
geometry (VERDICT r4 item 1).  This study scores all of it on
utils.layered scenes (analytic flow + occlusion truth):

1. **All five families vs truth** on three layered cases: overall /
   matched / unmatched EPE and EPE in the 6-px motion-discontinuity band,
   with cv2 anchors (DIS, Farneback, dense status-masked PyrLK) on the same
   frames where an independent implementation exists.
2. **Occlusion detection PR**: models.consistency.occlusion_score from
   bidirectional flow, swept over beta -> precision/recall curve vs the
   true mask; reports the default operating point (alpha=0.01, beta=0.5),
   best F1, and average precision.
3. **Boundary sharpness** on the bar case: effective blur width of the
   estimated flow step (area between estimated and true row-mean u profile
   around each edge, divided by the step height) — the numeric form of
   "TV-L1 preserves discontinuities better than HS".

The measured numbers feed docs/PERF.md (ACCURACY: layered motion) and
tests/test_layered_motion.py's CI bounds.

Run: python docs/studies/layered_motion_study.py     (CPU, ~4 min)
"""

from __future__ import annotations

import numpy as np


import jax.numpy as jnp  # noqa: E402

from cuda_optical_flow_2_tpu.utils.layered import (  # noqa: E402
    Layer,
    boundary_band,
    layered_scene,
)

H, W = 192, 256
MARGIN = 16
BAND = 6


def make_cases():
    """Three layered scenes; motions stay within the harness' warp budget
    (max_displacement=8) and the relative fg/bg motion sets the occlusion
    band width (5-7 px)."""
    cases = []
    cases.append((
        "disk(3,1)/bg(-2,1)",
        layered_scene(
            H, W, bg_flow=(-2.0, 1.0),
            layers=[Layer("disk", (96.0, 128.0), 45.0, (3.0, 1.0))],
            seed=3,
        ),
    ))
    cases.append((
        "two_disks/subpix",
        layered_scene(
            H, W, bg_flow=(0.5, 0.5),
            layers=[
                Layer("disk", (70.0, 80.0), 34.0, (2.5, -1.5)),
                Layer("disk", (120.0, 180.0), 30.0, (-1.5, 2.5)),
            ],
            seed=5,
        ),
    ))
    cases.append((
        "bar(4,0)/bg(-3,0)",
        layered_scene(
            H, W, bg_flow=(-3.0, 0.0),
            layers=[Layer("rect", (96.0, 128.0), (120.0, 22.0), (4.0, 0.0))],
            seed=7,
        ),
    ))
    return cases


# --- model runners (anchor-harness configs, CPU/XLA path) -------------------

def run_lk(prev, nxt):
    import cuda_optical_flow_2_tpu as of

    cfg = of.LKConfig(
        levels=3, window=19, iterations=2, temporal_kernel="gauss3",
        use_pallas=False, max_displacement=8, window_weights="tri",
    )
    return np.asarray(of.pyramidal_lk(
        jnp.asarray(prev, jnp.float32), jnp.asarray(nxt, jnp.float32), cfg))


def run_hs(prev, nxt):
    from cuda_optical_flow_2_tpu.models.horn_schunck import HSConfig, pyramidal_hs

    return np.asarray(pyramidal_hs(
        jnp.asarray(prev, jnp.float32), jnp.asarray(nxt, jnp.float32),
        HSConfig(levels=3, iterations=60)))


def run_fb(prev, nxt):
    from cuda_optical_flow_2_tpu.models import farneback as fb

    cfg = fb.FBConfig(
        levels=3, iterations=3, poly_n=7, poly_sigma=1.5, winsize=15,
        warp_planes="coeff", max_displacement=8,
    )
    return np.asarray(fb.pyramidal_farneback(
        jnp.asarray(prev, jnp.float32), jnp.asarray(nxt, jnp.float32), cfg))


def run_tvl1(prev, nxt):
    from cuda_optical_flow_2_tpu.models.tvl1 import TVL1Config, pyramidal_tvl1

    return np.asarray(pyramidal_tvl1(
        jnp.asarray(prev, jnp.float32), jnp.asarray(nxt, jnp.float32),
        TVL1Config(levels=3)))


def dis_cfg():
    from cuda_optical_flow_2_tpu.models import dis

    return dis.DISConfig(use_pallas=False, max_displacement=8)


def run_dis(prev, nxt):
    from cuda_optical_flow_2_tpu.models import dis

    return np.asarray(dis.pyramidal_dis(
        jnp.asarray(prev, jnp.float32), jnp.asarray(nxt, jnp.float32),
        dis_cfg()))


FAMILIES = [
    ("LK/tri", run_lk), ("HS", run_hs), ("FB", run_fb),
    ("TVL1", run_tvl1), ("DIS", run_dis),
]


def cv_models():
    try:
        import cv2
    except ImportError:
        return {}

    def cv_fb(prev, nxt):
        return cv2.calcOpticalFlowFarneback(
            prev.astype(np.uint8), nxt.astype(np.uint8), None,
            pyr_scale=0.5, levels=3, winsize=15, iterations=3,
            poly_n=7, poly_sigma=1.5, flags=0)

    def cv_dis(prev, nxt):
        d = cv2.DISOpticalFlow_create(cv2.DISOPTICAL_FLOW_PRESET_MEDIUM)
        return d.calc(prev.astype(np.uint8), nxt.astype(np.uint8), None)

    def cv_lk(prev, nxt):
        """Dense status-masked PyrLK grid (NaN where the tracker fails —
        typically in the occluded band, which is itself informative)."""
        stride = 2
        ys, xs = np.mgrid[0:H:stride, 0:W:stride]
        pts = np.stack([xs.ravel(), ys.ravel()], -1).astype(np.float32)
        moved, status, _ = cv2.calcOpticalFlowPyrLK(
            prev.astype(np.uint8), nxt.astype(np.uint8),
            pts.reshape(-1, 1, 2), None, winSize=(19, 19), maxLevel=2)
        d = (moved.reshape(-1, 2) - pts).reshape(ys.shape + (2,))
        ok = status.reshape(ys.shape) == 1
        flow = np.full((H, W, 2), np.nan, np.float32)
        flow[::stride, ::stride] = np.where(ok[..., None], d, np.nan)
        return flow

    return {"FB": cv_fb, "DIS": cv_dis, "LK/tri": cv_lk}


# --- metrics ----------------------------------------------------------------

def split_epe(flow, sc):
    """(overall, matched, unmatched, band) interior mean EPE; NaN-aware so
    the status-masked cv2 LK grid scores on its valid pixels."""
    d = flow - sc.flow
    e = np.hypot(d[..., 0], d[..., 1])
    interior = np.zeros_like(sc.occ)
    interior[MARGIN:-MARGIN, MARGIN:-MARGIN] = True
    fin = np.isfinite(e)
    band = boundary_band(sc.owner, BAND)

    def m(mask):
        mask = mask & interior & fin
        return float(e[mask].mean()) if mask.any() else float("nan")

    return m(np.ones_like(sc.occ)), m(~sc.occ), m(sc.occ), m(band)


def pr_curve(score, truth, interior):
    """Precision/recall over thresholds: returns (betas, P, R)."""
    s, t = score[interior], truth[interior]
    betas = np.concatenate([
        np.linspace(-2.0, 0.0, 21)[:-1], np.geomspace(0.01, 50.0, 60)
    ])
    prec, rec = [], []
    for b in betas:
        pred = s > b
        tp = (pred & t).sum()
        prec.append(tp / max(pred.sum(), 1))
        rec.append(tp / max(t.sum(), 1))
    return betas, np.array(prec), np.array(rec)


def average_precision(prec, rec):
    order = np.argsort(rec)
    r, p = rec[order], prec[order]
    return float(np.trapezoid(p, r))


def main():
    cases = make_cases()
    cvm = cv_models()

    print(f"Layered-motion benchmark ({H}x{W}, margin {MARGIN}, band {BAND})")
    print()
    hdr = (f"{'case':<22} {'model':<8} {'epe':>7} {'matched':>8} "
           f"{'unmatch':>8} {'band6':>7}   {'cv2(matched)':>12}")
    print(hdr)
    print("-" * len(hdr))
    for name, sc in cases:
        for label, fn in FAMILIES:
            ours = fn(sc.prev, sc.nxt)
            row = split_epe(ours, sc)
            cv_note = ""
            if label in cvm:
                cvf = cvm[label](sc.prev, sc.nxt)
                cv_note = f"{split_epe(cvf, sc)[1]:>12.3f}"
            print(f"{name:<22} {label:<8} {row[0]:>7.3f} {row[1]:>8.3f} "
                  f"{row[2]:>8.3f} {row[3]:>7.3f}   {cv_note}")
        print()

    # --- occlusion detection (bidirectional flow + occlusion_score) -------
    # Swept across flow families: detection quality tracks the boundary
    # sharpness of the underlying flow (TV-L1's 2.7-px blur width -> AP
    # ~0.6-0.75; DIS 4.0 px -> ~0.2; LK 5.1 px -> ~0.1), so the detector
    # recommendation is "run the cycle check on TV-L1 flow".
    from cuda_optical_flow_2_tpu.models import consistency

    print("occlusion detection: occlusion_score on bidirectional flow "
          "(alpha=0.01; default operating point beta=0.5)")
    hdr = (f"{'case':<22} {'flow':<6} {'P@def':>6} {'R@def':>6} "
           f"{'bestF1':>7} {'beta*':>6} {'AP':>6} {'occ%':>5}")
    print(hdr)
    print("-" * len(hdr))
    interior = np.zeros((H, W), bool)
    interior[MARGIN:-MARGIN, MARGIN:-MARGIN] = True
    for name, sc in cases:
        for label, fn in (("TVL1", run_tvl1), ("DIS", run_dis),
                          ("LK", run_lk)):
            fw = fn(sc.prev, sc.nxt)
            bw = fn(sc.nxt, sc.prev)
            score = np.asarray(consistency.occlusion_score(
                jnp.asarray(fw), jnp.asarray(bw), alpha=0.01))
            betas, prec, rec = pr_curve(score, sc.occ, interior)
            f1 = 2 * prec * rec / np.maximum(prec + rec, 1e-9)
            bi = int(np.argmax(f1))
            di = int(np.argmin(np.abs(betas - 0.5)))
            print(f"{name:<22} {label:<6} {prec[di]:>6.2f} {rec[di]:>6.2f} "
                  f"{f1[bi]:>7.2f} {betas[bi]:>6.2f} "
                  f"{average_precision(prec, rec):>6.2f} "
                  f"{100 * sc.occ[interior].mean():>5.1f}")

    # --- boundary sharpness on the bar case -------------------------------
    print()
    print("bar-case boundary sharpness: effective blur width of the u-step")
    print("(area between estimated and true row-mean u profile / step height)")
    name, sc = cases[2]
    x_edges = (128 - 22, 128 + 22)
    rows = slice(MARGIN, H - MARGIN)
    for label, fn in FAMILIES:
        ours = fn(sc.prev, sc.nxt)
        prof = np.nanmean(ours[rows, :, 0], axis=0)
        tprof = sc.flow[rows, :, 0].mean(axis=0)
        widths = []
        for x0 in x_edges:
            sl = slice(x0 - 15, x0 + 16)
            widths.append(np.abs(prof[sl] - tprof[sl]).sum() / 7.0)
        print(f"  {label:<8} blur width {np.mean(widths):>6.2f} px "
              f"(edges {widths[0]:.2f} / {widths[1]:.2f})")


if __name__ == "__main__":
    from cuda_optical_flow_2_tpu.utils.profiling import enable_compile_cache

    enable_compile_cache()
    main()
