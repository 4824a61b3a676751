"""1080p-scale anchor spot-check (round 5, VERDICT r4 item 6).

Every anchor-harness accuracy conclusion through round 4 was established
at 192x256 (docs/studies/opencv_parity.py): the window-weights mechanism
(box sidelobes -> tri/gauss fix), the DIS refine_alpha resolution, the
residual-envelope attribution.  The production kernels have
resolution-dependent machinery that small shapes barely exercise —
d_local clamping, per-tile recentering, border margins — so this study
re-scores one full-resolution (1080x1920) case per anchored family ON THE
CHIP (compiled Mosaic, production configs) against analytic truth and the
cv2 anchors, checking that the small-scale conclusions transfer.

Scene: a band-limited analytic sinusoid texture (utils.layered._texture)
evaluated exactly at warped coordinates — truth has NO resampling error,
and both global translation (6-px motion) and rotation (spatially varying
flow across the full 1920-pixel width) are exercised.

Conclusions checked (committed run, round 5, interior EPE, margin 48;
EPE is a property of the algorithm, not of the device it ran on):

1. **Window-weights win transfers.**  The production "tri" default is
   best on BOTH 1080p cases with the same ordering as 192x256:
   translate(6,3) box 0.0488 -> tri 0.0224 (2.2x) with gauss 0.0248
   between; rotate(0.004 rad) box 0.0265 -> tri 0.0180 with gauss 0.0249
   worse (the same gauss-hurts-rotation pattern the small-scale study
   found, which is why tri — not gauss — is the default).  The box
   sidelobe penalty is smaller at production scale (2.2x vs ~5x) but the
   mechanism and the default's optimality transfer.
2. **DIS alpha resolution transfers, to anchor parity at scale.**
   refine_alpha 20 -> 40: 0.0272 -> 0.0109, landing exactly on the cv2
   DIS anchor's 0.0107; the round-5 Charbonnier point (a=40 ed=10)
   matches at 0.0111.
3. **Anchor band holds at scale.**  On rotation, LK tri (0.0180) sits
   inside the cv2 anchor band (FB 0.0162 / PyrLK-grid 0.0161 / DIS
   0.0326).  On pure global translation the parametric/iterative anchors
   saturate (our FB 0.0001, cv2-PyrLK 0.0004 — a global-model case they
   fit exactly); dense fixed-iteration LK's 0.0224 is the expected
   operating-point difference, not a scale regression (same relationship
   as 192x256).

No d_local-clamping or tile-recentering anomaly appears at full
resolution: every family's 1080p EPE is within ~2x of its small-scale
value with the same ordering of variants.

Run: python docs/studies/anchor_1080p_study.py      (on the GPU; cv2
anchors run on the host CPU.  CI-optional by design — the fast tier
covers the same mechanisms at 192x256.)
"""

from __future__ import annotations

import os
import sys

sys.path.insert(
    0,
    os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", ".."),
)

import dataclasses

import numpy as np

import jax.numpy as jnp

import cuda_optical_flow_2_tpu as of
from cuda_optical_flow_2_tpu.models import dis as dis_mod
from cuda_optical_flow_2_tpu.models import farneback as fb_mod
from cuda_optical_flow_2_tpu.utils.layered import _texture

H, W = 1080, 1920
MARGIN = 48


def make_cases():
    """(name, prev, nxt, truth) at 1080p with analytic (resampling-free)
    warping: nxt(x) = tex(x + d(x)), truth = d."""
    # contrast 25 keeps the texture range inside [0, 255] (probed over
    # the shifted sampling domain: [16.8, 240.7]): the uint8 frames the
    # cv2 anchors consume must not clip (clipped flats are textureless for
    # the point tracker and unfairly break the anchor)
    tex = _texture(seed=11, contrast=25.0)
    ys, xs = np.mgrid[0:H, 0:W].astype(np.float64)
    cases = []

    def render(dy, dx, name):
        # framework/cv2 convention: prev(x) = next(x + d) -> next is the
        # texture shifted by -d
        prev = tex(ys, xs).astype(np.float32)
        nxt = tex(ys - dy, xs - dx).astype(np.float32)
        truth = np.stack(
            [np.broadcast_to(dx, (H, W)), np.broadcast_to(dy, (H, W))], -1
        ).astype(np.float32)
        cases.append((name, prev, nxt, truth))

    # translation: 6.0/3.0 px — d_local clamping live at production scale
    render(3.0, 6.0, "translate(6,3)")
    # rotation about the center, 0.004 rad: ~4.3 px at the frame corner,
    # spatially varying across all 15 lane tiles -> tile recentering live
    th = 0.004
    cy, cx = H / 2.0, W / 2.0
    dx = (np.cos(th) - 1) * (xs - cx) - np.sin(th) * (ys - cy)
    dy = np.sin(th) * (xs - cx) + (np.cos(th) - 1) * (ys - cy)
    render(dy, dx, "rotate(0.004rad)")
    return cases


def interior_epe(flow, truth):
    d = flow[MARGIN:-MARGIN, MARGIN:-MARGIN] - truth[
        MARGIN:-MARGIN, MARGIN:-MARGIN
    ]
    return float(np.hypot(d[..., 0], d[..., 1]).mean())


def run_lk(prev, nxt, weights):
    cfg = dataclasses.replace(of.PAPER_1080P, window_weights=weights)
    return np.asarray(of.pyramidal_lk_jit(
        jnp.asarray(prev), jnp.asarray(nxt), cfg))


def run_dis(prev, nxt, **kw):
    cfg = dis_mod.DISConfig(**kw)
    return np.asarray(dis_mod.pyramidal_dis_jit(
        jnp.asarray(prev), jnp.asarray(nxt), cfg))


def run_fb(prev, nxt):
    cfg = fb_mod.FBConfig()
    return np.asarray(fb_mod.pyramidal_farneback_jit(
        jnp.asarray(prev), jnp.asarray(nxt), cfg))


def cv_anchors(prev, nxt):
    try:
        import cv2
    except Exception:
        return {}
    assert prev.min() > 0 and prev.max() < 255, "texture must not clip"
    p8 = np.round(prev).astype(np.uint8)
    n8 = np.round(nxt).astype(np.uint8)
    out = {}
    d = cv2.DISOpticalFlow_create(cv2.DISOPTICAL_FLOW_PRESET_MEDIUM)
    out["cv2-DIS"] = d.calc(p8, n8, None)
    out["cv2-FB"] = cv2.calcOpticalFlowFarneback(
        p8, n8, None, 0.5, 3, 15, 3, 7, 1.5, 0
    )
    # dense-grid PyrLK anchor (stride 4 at this scale), status-masked
    ys, xs = np.mgrid[MARGIN:H - MARGIN:4, MARGIN:W - MARGIN:4]
    pts = np.stack([xs, ys], -1).reshape(-1, 1, 2).astype(np.float32)
    # same anchor parameters as the 192x256 harness (opencv_parity.
    # cv_lk_dense) apart from the deeper pyramid the 1080p motion needs
    nxt_pts, st, _ = cv2.calcOpticalFlowPyrLK(
        p8, n8, pts, None, winSize=(19, 19), maxLevel=3
    )
    d = (nxt_pts - pts).reshape(-1, 2)
    out["cv2-PyrLK-grid"] = (d, st.reshape(-1).astype(bool), pts.reshape(-1, 2))
    return out


def main() -> None:
    import jax

    print(f"device: {jax.devices()[0]}; {H}x{W}, margin {MARGIN}")
    for name, prev, nxt, truth in make_cases():
        print(f"\n=== {name} ===")
        for weights in ("box", "tri", "gauss"):
            e = interior_epe(run_lk(prev, nxt, weights), truth)
            print(f"  LK {weights:<6} (PAPER_1080P)      EPE {e:.4f}")
        if name.startswith("translate"):
            for label, kw in (
                ("DIS quad a=20 (default)", {}),
                ("DIS quad a=40", dict(refine_alpha=40.0)),
                ("DIS charb a=40 ed=10", dict(
                    refine_penalty="charbonnier", refine_alpha=40.0,
                    refine_eps_data=10.0)),
            ):
                e = interior_epe(run_dis(prev, nxt, **kw), truth)
                print(f"  {label:<26} EPE {e:.4f}")
            e = interior_epe(run_fb(prev, nxt), truth)
            print(f"  {'FB (defaults)':<26} EPE {e:.4f}")
        anchors = cv_anchors(prev, nxt)
        for label in ("cv2-DIS", "cv2-FB"):
            if label in anchors:
                e = interior_epe(anchors[label], truth)
                print(f"  {label:<26} EPE {e:.4f}")
        if "cv2-PyrLK-grid" in anchors:
            d, st, pts = anchors["cv2-PyrLK-grid"]
            t = truth[pts[:, 1].astype(int), pts[:, 0].astype(int)]
            err = np.hypot(*(d - t).T)
            print(
                f"  {'cv2-PyrLK-grid':<26} EPE {err[st].mean():.4f} "
                f"(status-ok {st.mean():.2%})"
            )


if __name__ == "__main__":
    from cuda_optical_flow_2_tpu.utils.profiling import enable_compile_cache

    enable_compile_cache()
    main()
