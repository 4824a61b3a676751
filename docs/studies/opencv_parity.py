"""External accuracy anchor: cross-validate against OpenCV (CPU study).

Every accuracy claim in docs/PERF.md before round 3 was self-referential
(oracle twins + kernel-vs-XLA cross-checks on synthetic pairs).
This study anchors four model families plus the corner seeder against an
independent implementation — OpenCV's `calcOpticalFlowFarneback`,
`DISOpticalFlow`, `calcOpticalFlowPyrLK` and `goodFeaturesToTrack` — on
synthetic-truth pairs (translation / rotation on an aperiodic smoothed
texture, plus a multi-octave "natural-like" texture).

For each case it reports ours-vs-truth EPE, OpenCV-vs-truth EPE, and the
flow-vs-flow EPE between the two implementations.  The measured numbers
feed tests/test_opencv_parity.py's bounds and the ACCURACY section of
docs/PERF.md.

Run: python docs/studies/opencv_parity.py          (CPU, ~2 min)
"""

from __future__ import annotations

import numpy as np


import cv2  # noqa: E402
import jax.numpy as jnp  # noqa: E402

H, W = 192, 256
MARGIN = 24


def smooth(img: np.ndarray, reps: int = 12) -> np.ndarray:
    out = img.astype(np.float64)
    for _ in range(reps):
        out = (
            out
            + np.roll(out, 1, 0) + np.roll(out, -1, 0)
            + np.roll(out, 1, 1) + np.roll(out, -1, 1)
        ) / 5.0
    return out


def natural_texture(rng: np.random.Generator) -> np.ndarray:
    """Multi-octave smoothed noise — natural-image-like 1/f-ish spectrum."""
    acc = np.zeros((H, W))
    for octave, weight in ((2, 0.2), (6, 0.35), (18, 0.45)):
        acc += weight * smooth(rng.uniform(0, 255, (H, W)), octave)
    acc -= acc.min()
    return acc * (255.0 / acc.max())


def bilinear(img: np.ndarray, sy: np.ndarray, sx: np.ndarray) -> np.ndarray:
    y0 = np.clip(np.floor(sy).astype(int), 0, H - 2)
    x0 = np.clip(np.floor(sx).astype(int), 0, W - 2)
    fy, fx = np.clip(sy - y0, 0, 1), np.clip(sx - x0, 0, 1)
    return (
        img[y0, x0] * (1 - fy) * (1 - fx)
        + img[y0, x0 + 1] * (1 - fy) * fx
        + img[y0 + 1, x0] * fy * (1 - fx)
        + img[y0 + 1, x0 + 1] * fy * fx
    )


def make_cases() -> list[tuple[str, np.ndarray, np.ndarray, np.ndarray]]:
    rng = np.random.default_rng(7)
    ys, xs = np.mgrid[0:H, 0:W].astype(np.float64)
    base = smooth(rng.uniform(0, 255, (H, W)))
    nat = natural_texture(np.random.default_rng(11))
    cases = []

    def warped(img, u, v):
        # truth flow maps prev(x) = next(x + d): next samples img at x - d
        return bilinear(img, ys - v, xs - u)

    tx, ty = 2.0, 1.0
    tf = np.stack([np.full((H, W), tx), np.full((H, W), ty)], -1)
    cases.append(("translate(2,1)/smooth", base, warped(base, tx, ty), tf))

    th = 0.004
    cy, cx = (H - 1) / 2.0, (W - 1) / 2.0
    u = -th * (ys - cy)
    v = th * (xs - cx)
    rf = np.stack([u, v], -1)
    cases.append(("rotate(0.004rad)/smooth", base, warped(base, u, v), rf))

    cases.append(("translate(2,1)/natural", nat, warped(nat, tx, ty), tf))
    return cases


def interior_epe(a: np.ndarray, b: np.ndarray) -> float:
    d = a[MARGIN:-MARGIN, MARGIN:-MARGIN] - b[MARGIN:-MARGIN, MARGIN:-MARGIN]
    return float(np.hypot(d[..., 0], d[..., 1]).mean())


def run_fb(prev, nxt, warp_planes: str):
    from cuda_optical_flow_2_tpu.models import farneback as fb

    cfg = fb.FBConfig(
        levels=3, iterations=3, poly_n=7, poly_sigma=1.5, winsize=15,
        warp_planes=warp_planes, max_displacement=8,
    )
    return np.asarray(
        fb.pyramidal_farneback(
            jnp.asarray(prev, jnp.float32), jnp.asarray(nxt, jnp.float32), cfg
        )
    )


def cv_fb(prev, nxt):
    return cv2.calcOpticalFlowFarneback(
        prev.astype(np.uint8), nxt.astype(np.uint8), None,
        pyr_scale=0.5, levels=3, winsize=15, iterations=3,
        poly_n=7, poly_sigma=1.5, flags=0,
    )


def run_dis(prev, nxt):
    from cuda_optical_flow_2_tpu.models import dis

    cfg = dis.DISConfig(use_pallas=False, max_displacement=8)
    return np.asarray(
        dis.pyramidal_dis(
            jnp.asarray(prev, jnp.float32), jnp.asarray(nxt, jnp.float32), cfg
        )
    )


def cv_dis(prev, nxt):
    d = cv2.DISOpticalFlow_create(cv2.DISOPTICAL_FLOW_PRESET_MEDIUM)
    return d.calc(prev.astype(np.uint8), nxt.astype(np.uint8), None)


def run_lk(prev, nxt, window_weights: str = "box"):
    import cuda_optical_flow_2_tpu as of

    cfg = of.LKConfig(
        levels=3, window=19, iterations=2, temporal_kernel="gauss3",
        use_pallas=False, max_displacement=8, window_weights=window_weights,
    )
    return np.asarray(
        of.pyramidal_lk(
            jnp.asarray(prev, jnp.float32), jnp.asarray(nxt, jnp.float32), cfg
        )
    )


def cv_lk_dense(prev, nxt, stride: int = 2):
    """Dense-LK anchor: cv2.calcOpticalFlowPyrLK on a dense stride-``stride``
    pixel grid, bilinearly splatted back to a full (H, W, 2) field with NaN
    where the tracker reports failure (status=0) — the independent
    implementation of the same algorithm family (pyramidal LK, 19x19
    window, 3 levels).  Returns (flow, valid_mask).

    TWIN of tests/test_opencv_parity.py::_cv_lk_dense — keep the anchor
    parameters (stride, winSize, maxLevel, status masking) identical in
    both, or the CI bounds stop matching this study's envelopes."""
    ys, xs = np.mgrid[0:H:stride, 0:W:stride]
    pts = np.stack([xs.ravel(), ys.ravel()], -1).astype(np.float32)
    moved, status, _ = cv2.calcOpticalFlowPyrLK(
        prev.astype(np.uint8), nxt.astype(np.uint8),
        pts.reshape(-1, 1, 2), None, winSize=(19, 19), maxLevel=2,
    )
    d = (moved.reshape(-1, 2) - pts).reshape(ys.shape + (2,))
    ok = (status.reshape(ys.shape) == 1)
    flow = np.full((H, W, 2), np.nan, np.float32)
    valid = np.zeros((H, W), bool)
    flow[::stride, ::stride] = np.where(ok[..., None], d, np.nan)
    valid[::stride, ::stride] = ok
    return flow, valid


def masked_epe(a, b, valid):
    m = valid[MARGIN:-MARGIN, MARGIN:-MARGIN]
    d = (a - b)[MARGIN:-MARGIN, MARGIN:-MARGIN][m]
    return float(np.hypot(d[..., 0], d[..., 1]).mean())


def main() -> None:
    print(f"OpenCV {cv2.__version__} parity study  ({H}x{W}, margin {MARGIN})")
    print()
    hdr = f"{'case':<26} {'model':<12} {'ours':>7} {'opencv':>7} {'x-epe':>7}"
    print(hdr)
    print("-" * len(hdr))
    for name, prev, nxt, truth in make_cases():
        for label, ours_fn, cv_fn in (
            ("FB/coeff", lambda p, n: run_fb(p, n, "coeff"), cv_fb),
            ("FB/image", lambda p, n: run_fb(p, n, "image"), cv_fb),
            ("DIS", run_dis, cv_dis),
        ):
            ours = ours_fn(prev, nxt)
            cvf = cv_fn(prev, nxt)
            print(
                f"{name:<26} {label:<12} {interior_epe(ours, truth):>7.3f} "
                f"{interior_epe(cvf, truth):>7.3f} {interior_epe(ours, cvf):>7.3f}"
            )
        # HS and TV-L1: cv2 5.0 ships no implementation of either (the
        # optflow contrib module is gone), so they cannot be cross-anchored
        # directly — they are scored on the SAME truth harness where the
        # other three families are externally validated (indirect anchor).
        from cuda_optical_flow_2_tpu.models.horn_schunck import (
            HSConfig, pyramidal_hs,
        )
        from cuda_optical_flow_2_tpu.models.tvl1 import (
            TVL1Config, pyramidal_tvl1,
        )

        hs = np.asarray(pyramidal_hs(
            jnp.asarray(prev, jnp.float32), jnp.asarray(nxt, jnp.float32),
            HSConfig(levels=3, iterations=60),
        ))
        tv = np.asarray(pyramidal_tvl1(
            jnp.asarray(prev, jnp.float32), jnp.asarray(nxt, jnp.float32),
            TVL1Config(levels=3),
        ))
        for label, f in (("HS", hs), ("TVL1", tv)):
            print(
                f"{name:<26} {label:<12} "
                f"{interior_epe(f, truth):>7.3f} {'n/a':>7} {'n/a':>7}"
            )
        # Dense LK vs cv2's pyramidal LK evaluated on a dense stride-2 grid
        # (status-masked) — the anchor VERDICT r3 asked for: the same
        # algorithm family, independently implemented.
        cvf, valid = cv_lk_dense(prev, nxt)
        for label, ww in (
            ("LK/box", "box"), ("LK/tri", "tri"), ("LK/gauss", "gauss")
        ):
            ours = run_lk(prev, nxt, ww)
            print(
                f"{name:<26} {label:<12} {interior_epe(ours, truth):>7.3f} "
                f"{masked_epe(cvf, truth, valid):>7.3f} "
                f"{masked_epe(ours, cvf, valid):>7.3f}"
            )

    # --- sparse: corners + tracks on the natural translation case ---------
    import cuda_optical_flow_2_tpu as of
    from cuda_optical_flow_2_tpu.models import confidence, tracking

    name, prev, nxt, truth = make_cases()[2]
    cfg = of.LKConfig(levels=3, window=19, iterations=2, use_pallas=False,
                      max_displacement=8)

    # The tightest corner anchor is the SCORE MAP itself: our min-eigenvalue
    # plane vs cv2.cornerMinEigenVal (same 19x19 block, Sobel ksize 3) —
    # equal up to cv2's fixed normalization constant.
    ours_map = np.asarray(
        confidence.min_eigenvalue(jnp.asarray(prev, jnp.float32), cfg)
    )
    cv_map = cv2.cornerMinEigenVal(prev.astype(np.uint8), blockSize=19, ksize=3)
    a = ours_map[MARGIN:-MARGIN, MARGIN:-MARGIN].ravel()
    b = cv_map[MARGIN:-MARGIN, MARGIN:-MARGIN].ravel()
    corr = float(np.corrcoef(a, b)[0, 1])
    print(f"\nmin-eigenvalue map corr vs cornerMinEigenVal: {corr:.5f}")

    # Corner SELECTION: on blobby textures both detectors pick different
    # top-40 subsets of a larger near-tied corner pool (ranking noise), so
    # the meaningful check is containment: our top-40 inside cv2's top-200.
    pts, scores = confidence.good_features(
        jnp.asarray(prev, jnp.float32), cfg, 40, min_distance=9
    )
    pts = np.asarray(pts)[np.asarray(scores) > 1.0]
    cv_pts = cv2.goodFeaturesToTrack(
        prev.astype(np.uint8), maxCorners=200, qualityLevel=0.01,
        minDistance=9, blockSize=19,
    ).reshape(-1, 2)
    dists = np.sqrt(
        ((pts[:, None, :] - cv_pts[None, :, :]) ** 2).sum(-1)
    ).min(1)
    for r in (3.0, 6.0):
        print(
            f"good_features containment r<={r}: {(dists <= r).mean():.2f} "
            f"({len(pts)} ours vs {len(cv_pts)} cv)"
        )

    flow = run_lk(prev, nxt, "tri")  # production default weighting
    moved, alive = tracking.advect_points(
        jnp.asarray(flow), jnp.asarray(pts, jnp.float32)
    )
    moved = np.asarray(moved)
    cv_moved, status, _ = cv2.calcOpticalFlowPyrLK(
        prev.astype(np.uint8), nxt.astype(np.uint8),
        pts.astype(np.float32).reshape(-1, 1, 2), None,
        winSize=(19, 19), maxLevel=2,
    )
    cv_moved = cv_moved.reshape(-1, 2)
    ok = status.reshape(-1) == 1
    d = np.sqrt(((moved[ok] - cv_moved[ok]) ** 2).sum(-1))
    true_moved = pts + np.array([[2.0, 1.0]])
    d_true = np.sqrt(((moved - true_moved) ** 2).sum(-1))
    d_cv_true = np.sqrt(((cv_moved[ok] - true_moved[ok]) ** 2).sum(-1))
    print(
        f"tracks ({ok.sum()} pts): ours-vs-truth {d_true.mean():.3f} px, "
        f"cv-vs-truth {d_cv_true.mean():.3f} px, ours-vs-cv {d.mean():.3f} px"
    )


if __name__ == "__main__":
    from cuda_optical_flow_2_tpu.utils.profiling import enable_compile_cache

    enable_compile_cache()
    main()
