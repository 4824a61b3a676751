"""External accuracy anchors: cross-validation against OpenCV.

Before round 3 every accuracy claim was self-referential (oracle twins,
XLA-vs-Pallas cross-checks, builder-generated synthetics).  These tests
anchor the FB and DIS families, the dense-LK-derived point tracks, and the
Shi-Tomasi corner seeder against OpenCV's independent implementations
(`calcOpticalFlowFarneback`, `DISOpticalFlow`, `calcOpticalFlowPyrLK`,
`cornerMinEigenVal`/`goodFeaturesToTrack`) on synthetic-truth pairs.

Bounds are set from docs/studies/opencv_parity.py's measured agreement
(x-epe <= 0.06 px dense, 0.15 px tracks, 0.99996 score-map correlation)
with ~3x headroom; parameter-semantics differences that keep the bounds
loose are documented inline.  Skips cleanly when cv2 is absent.
"""

import numpy as np
import pytest

import jax.numpy as jnp

cv2 = pytest.importorskip("cv2")

H, W = 160, 224
MARGIN = 20


def _smooth(img, reps=12):
    out = img.astype(np.float64)
    for _ in range(reps):
        out = (
            out
            + np.roll(out, 1, 0) + np.roll(out, -1, 0)
            + np.roll(out, 1, 1) + np.roll(out, -1, 1)
        ) / 5.0
    return out


def _bilinear(img, sy, sx):
    y0 = np.clip(np.floor(sy).astype(int), 0, H - 2)
    x0 = np.clip(np.floor(sx).astype(int), 0, W - 2)
    fy, fx = np.clip(sy - y0, 0, 1), np.clip(sx - x0, 0, 1)
    return (
        img[y0, x0] * (1 - fy) * (1 - fx)
        + img[y0, x0 + 1] * (1 - fy) * fx
        + img[y0 + 1, x0] * fy * (1 - fx)
        + img[y0 + 1, x0 + 1] * fy * fx
    )


def _epe(a, b):
    d = a[MARGIN:-MARGIN, MARGIN:-MARGIN] - b[MARGIN:-MARGIN, MARGIN:-MARGIN]
    return float(np.hypot(d[..., 0], d[..., 1]).mean())


@pytest.fixture(scope="module")
def cases():
    """(name, prev, nxt, truth): translation + rotation on an aperiodic
    smoothed texture, plus a multi-octave natural-like translation pair."""
    rng = np.random.default_rng(7)
    ys, xs = np.mgrid[0:H, 0:W].astype(np.float64)
    base = _smooth(rng.uniform(0, 255, (H, W)))
    nat = np.zeros((H, W))
    nrng = np.random.default_rng(11)
    for octave, weight in ((2, 0.2), (6, 0.35), (18, 0.45)):
        nat += weight * _smooth(nrng.uniform(0, 255, (H, W)), octave)
    nat = (nat - nat.min()) * (255.0 / (nat.max() - nat.min()))

    out = {}
    tx, ty = 2.0, 1.0
    tf = np.stack([np.full((H, W), tx), np.full((H, W), ty)], -1)
    out["translate_smooth"] = (base, _bilinear(base, ys - ty, xs - tx), tf)
    th = 0.004
    cy, cx = (H - 1) / 2.0, (W - 1) / 2.0
    u, v = -th * (ys - cy), th * (xs - cx)
    rf = np.stack([u, v], -1)
    out["rotate_smooth"] = (base, _bilinear(base, ys - v, xs - u), rf)
    out["translate_natural"] = (nat, _bilinear(nat, ys - ty, xs - tx), tf)
    return out


@pytest.mark.parametrize("case", ["translate_smooth", "rotate_smooth",
                                  "translate_natural"])
def test_farneback_vs_opencv(cases, case):
    """FB (coeff formulation = cv::calcOpticalFlowFarneback's) with matched
    poly_n/poly_sigma/winsize/levels/iterations.  Remaining semantics gap:
    OpenCV's pyr_scale=0.5 uses its own 5-tap pyramid vs our 3-tap Gaussian
    decimation — measured x-epe <= 0.06 px (study); bound 0.2."""
    from cuda_optical_flow_2_tpu.models import farneback as fb

    prev, nxt, truth = cases[case]
    cfg = fb.FBConfig(
        levels=3, iterations=3, poly_n=7, poly_sigma=1.5, winsize=15,
        warp_planes="coeff", max_displacement=8,
    )
    ours = np.asarray(
        fb.pyramidal_farneback(
            jnp.asarray(prev, jnp.float32), jnp.asarray(nxt, jnp.float32), cfg
        )
    )
    cvf = cv2.calcOpticalFlowFarneback(
        prev.astype(np.uint8), nxt.astype(np.uint8), None,
        pyr_scale=0.5, levels=3, winsize=15, iterations=3,
        poly_n=7, poly_sigma=1.5, flags=0,
    )
    assert _epe(ours, truth) < 0.15
    assert _epe(cvf, truth) < 0.15   # sanity: the anchor is itself accurate
    assert _epe(ours, cvf) < 0.2


def test_farneback_image_formulation_matches_too(cases):
    """The default warp_planes="image" formulation stays within the same
    cross-implementation envelope (its accuracy parity with "coeff" is a
    PERF.md claim — here anchored externally)."""
    from cuda_optical_flow_2_tpu.models import farneback as fb

    prev, nxt, truth = cases["rotate_smooth"]
    cfg = fb.FBConfig(
        levels=3, iterations=3, poly_n=7, poly_sigma=1.5, winsize=15,
        warp_planes="image", max_displacement=8,
    )
    ours = np.asarray(
        fb.pyramidal_farneback(
            jnp.asarray(prev, jnp.float32), jnp.asarray(nxt, jnp.float32), cfg
        )
    )
    cvf = cv2.calcOpticalFlowFarneback(
        prev.astype(np.uint8), nxt.astype(np.uint8), None,
        pyr_scale=0.5, levels=3, winsize=15, iterations=3,
        poly_n=7, poly_sigma=1.5, flags=0,
    )
    assert _epe(ours, truth) < 0.15
    assert _epe(ours, cvf) < 0.2


@pytest.mark.parametrize("case", ["translate_smooth", "rotate_smooth",
                                  "translate_natural"])
def test_dis_vs_opencv(cases, case):
    """DIS vs cv2.DISOpticalFlow PRESET_MEDIUM.  Parameter semantics differ
    more here (OpenCV's patch-based inverse search + Charbonnier variational
    weights vs our dense formulation with quadratic penalties) — with
    refine_alpha=20 (cv2's own VariationalRefinement default, adopted in
    round 4 after docs/studies/dis_gap_study.py isolated the round-3 gap to
    refinement under-smoothing) the measured envelope is ours-vs-truth
    0.011-0.031, x-epe 0.017-0.036 px.  Bounds ~3x: 0.1 / 0.12 (round 3's
    were 0.2 / 0.25)."""
    from cuda_optical_flow_2_tpu.models import dis

    prev, nxt, truth = cases[case]
    cfg = dis.DISConfig(use_pallas=False, max_displacement=8)
    ours = np.asarray(
        dis.pyramidal_dis(
            jnp.asarray(prev, jnp.float32), jnp.asarray(nxt, jnp.float32), cfg
        )
    )
    d = cv2.DISOpticalFlow_create(cv2.DISOPTICAL_FLOW_PRESET_MEDIUM)
    cvf = d.calc(prev.astype(np.uint8), nxt.astype(np.uint8), None)
    assert _epe(ours, truth) < 0.1
    assert _epe(cvf, truth) < 0.1
    assert _epe(ours, cvf) < 0.12


def _cv_lk_dense(prev, nxt, stride=2):
    """cv2.calcOpticalFlowPyrLK on a dense stride-2 grid, status-masked —
    the dense-LK anchor (same algorithm family, independent implementation).
    Returns (flow, valid) at full resolution with NaN off-grid/failed.

    TWIN of docs/studies/opencv_parity.py::cv_lk_dense (the study is a
    standalone script, so the definition is duplicated rather than
    imported): the anchor parameters — stride 2, winSize (19, 19),
    maxLevel 2, status masking — must stay identical in both, or the
    test bounds stop being verifiable against the study's measured
    envelopes."""
    ys, xs = np.mgrid[0:H:stride, 0:W:stride]
    pts = np.stack([xs.ravel(), ys.ravel()], -1).astype(np.float32)
    moved, status, _ = cv2.calcOpticalFlowPyrLK(
        prev.astype(np.uint8), nxt.astype(np.uint8),
        pts.reshape(-1, 1, 2), None, winSize=(19, 19), maxLevel=2,
    )
    d = (moved.reshape(-1, 2) - pts).reshape(ys.shape + (2,))
    ok = status.reshape(ys.shape) == 1
    flow = np.full((H, W, 2), np.nan, np.float32)
    valid = np.zeros((H, W), bool)
    flow[::stride, ::stride] = np.where(ok[..., None], d, np.nan)
    valid[::stride, ::stride] = ok
    return flow, valid


def _masked_epe(a, b, valid):
    m = valid[MARGIN:-MARGIN, MARGIN:-MARGIN]
    d = (a - b)[MARGIN:-MARGIN, MARGIN:-MARGIN][m]
    return float(np.hypot(d[..., 0], d[..., 1]).mean())


@pytest.mark.parametrize("case", ["translate_smooth", "rotate_smooth",
                                  "translate_natural"])
def test_dense_lk_vs_opencv_pyrlk(cases, case):
    """The flagship: dense pyramidal LK vs cv2.calcOpticalFlowPyrLK on a
    dense status-masked grid (VERDICT r3 item 1).  With the gauss window
    the measured x-epe is 0.008-0.038 px (study); the box window's is up
    to 0.195 px — the box window's negative transfer sidelobes, see
    LKConfig.window_weights and docs/studies/lk_window_study.py.  Bounds:
    gauss x-epe < 0.1, and both implementations beat truth independently."""
    import cuda_optical_flow_2_tpu as of

    prev, nxt, truth = cases[case]
    cfg = of.LKConfig(
        levels=3, window=19, iterations=2, temporal_kernel="gauss3",
        use_pallas=False, max_displacement=8, window_weights="gauss",
    )
    ours = np.asarray(
        of.pyramidal_lk(
            jnp.asarray(prev, jnp.float32), jnp.asarray(nxt, jnp.float32), cfg
        )
    )
    cvf, valid = _cv_lk_dense(prev, nxt)
    # >90% of interior GRID points must be tracked (valid covers only the
    # stride-2 grid, i.e. 1/4 of all pixels)
    grid_ok = valid[MARGIN:-MARGIN:2, MARGIN:-MARGIN:2]
    assert grid_ok.mean() > 0.9
    assert _epe(ours, truth) < 0.12
    assert _masked_epe(cvf, truth, valid) < 0.1   # the anchor itself
    assert _masked_epe(ours, cvf, valid) < 0.12


def test_dense_lk_gauss_window_beats_box(cases):
    """The documented accuracy mechanism, pinned externally: on natural
    texture the gauss window agrees with the cv2 anchor ~10x closer than
    the reference-parity box window."""
    import cuda_optical_flow_2_tpu as of

    prev, nxt, _ = cases["translate_natural"]
    cvf, valid = _cv_lk_dense(prev, nxt)

    def xepe(ww):
        cfg = of.LKConfig(
            levels=3, window=19, iterations=2, temporal_kernel="gauss3",
            use_pallas=False, max_displacement=8, window_weights=ww,
        )
        ours = np.asarray(
            of.pyramidal_lk(
                jnp.asarray(prev, jnp.float32), jnp.asarray(nxt, jnp.float32),
                cfg,
            )
        )
        return _masked_epe(ours, cvf, valid)

    assert xepe("gauss") < xepe("box") / 3


@pytest.mark.parametrize("case", ["translate_smooth", "rotate_smooth",
                                  "translate_natural"])
def test_hs_and_tvl1_on_anchored_harness(cases, case):
    """HS and TV-L1 cannot be cross-anchored against OpenCV (cv2 5.0 ships
    neither — the optflow contrib module is gone), so they are pinned on
    the SAME truth harness where FB/DIS/LK are externally validated.
    Measured: TV-L1 0.000/0.015/0.000 (best in harness, at FB's level);
    HS 0.077/0.045/0.151 (the quadratic-penalty global method's documented
    envelope).  Bounds ~2x measured."""
    from cuda_optical_flow_2_tpu.models.horn_schunck import (
        HSConfig, pyramidal_hs,
    )
    from cuda_optical_flow_2_tpu.models.tvl1 import TVL1Config, pyramidal_tvl1

    prev, nxt, truth = cases[case]
    p, n = jnp.asarray(prev, jnp.float32), jnp.asarray(nxt, jnp.float32)
    tv = np.asarray(
        pyramidal_tvl1(p, n, TVL1Config(levels=3))
    )
    assert _epe(tv, truth) < 0.05
    hs = np.asarray(
        pyramidal_hs(p, n, HSConfig(levels=3, iterations=60))
    )
    assert _epe(hs, truth) < 0.3


def test_min_eigenvalue_map_vs_opencv(cases):
    """Our Shi-Tomasi score plane equals cv2.cornerMinEigenVal (same 19x19
    block, Sobel ksize 3) up to cv2's fixed normalization: measured
    correlation 0.99996 on the interior."""
    import cuda_optical_flow_2_tpu as of
    from cuda_optical_flow_2_tpu.models import confidence

    prev = cases["translate_natural"][0]
    cfg = of.LKConfig(levels=3, window=19, use_pallas=False)
    ours = np.asarray(
        confidence.min_eigenvalue(jnp.asarray(prev, jnp.float32), cfg)
    )
    cvm = cv2.cornerMinEigenVal(prev.astype(np.uint8), blockSize=19, ksize=3)
    a = ours[MARGIN:-MARGIN, MARGIN:-MARGIN].ravel()
    b = cvm[MARGIN:-MARGIN, MARGIN:-MARGIN].ravel()
    assert np.corrcoef(a, b)[0, 1] > 0.999


def test_good_features_contained_in_opencv_corners(cases):
    """Corner SELECTION: top-40 rankings differ on near-tied corner pools
    (NMS footprint: our Chebyshev square vs cv2's Euclidean radius), so the
    anchor is containment — our top corners must lie inside cv2's top-200
    (measured 0.85 within 3 px / 0.95 within 6 px)."""
    import cuda_optical_flow_2_tpu as of
    from cuda_optical_flow_2_tpu.models import confidence

    prev = cases["translate_natural"][0]
    cfg = of.LKConfig(levels=3, window=19, use_pallas=False)
    pts, scores = confidence.good_features(
        jnp.asarray(prev, jnp.float32), cfg, 40, min_distance=9
    )
    pts = np.asarray(pts)[np.asarray(scores) > 1.0]
    assert len(pts) >= 20
    cv_pts = cv2.goodFeaturesToTrack(
        prev.astype(np.uint8), maxCorners=200, qualityLevel=0.01,
        minDistance=9, blockSize=19,
    ).reshape(-1, 2)
    dists = np.sqrt(((pts[:, None, :] - cv_pts[None, :, :]) ** 2).sum(-1)).min(1)
    assert (dists <= 3.0).mean() >= 0.7
    assert (dists <= 6.0).mean() >= 0.85


def test_tracks_vs_opencv_pyrlk(cases):
    """Dense-flow-derived tracks vs the classic sparse pyramidal-LK tracker
    on the same corners: measured mean disagreement 0.038 px at the
    production (tri) window default (round 3's box window measured 0.15);
    bound 0.2 px (~5x measured)."""
    import cuda_optical_flow_2_tpu as of
    from cuda_optical_flow_2_tpu.models import confidence, tracking

    prev, nxt, _ = cases["translate_natural"]
    cfg = of.LKConfig(
        levels=3, window=19, iterations=2, temporal_kernel="gauss3",
        use_pallas=False, max_displacement=8,
    )
    pts, scores = confidence.good_features(
        jnp.asarray(prev, jnp.float32), cfg, 40, min_distance=9
    )
    pts = np.asarray(pts)[np.asarray(scores) > 1.0]
    flow = np.asarray(
        of.pyramidal_lk(
            jnp.asarray(prev, jnp.float32), jnp.asarray(nxt, jnp.float32), cfg
        )
    )
    moved, alive = tracking.advect_points(
        jnp.asarray(flow), jnp.asarray(pts, jnp.float32)
    )
    moved = np.asarray(moved)
    cv_moved, status, _ = cv2.calcOpticalFlowPyrLK(
        prev.astype(np.uint8), nxt.astype(np.uint8),
        pts.astype(np.float32).reshape(-1, 1, 2), None,
        winSize=(19, 19), maxLevel=2,
    )
    cv_moved, ok = cv_moved.reshape(-1, 2), status.reshape(-1) == 1
    assert ok.mean() > 0.9
    true_moved = pts + np.array([[2.0, 1.0]])
    assert np.hypot(*(moved - true_moved).T).mean() < 0.2
    assert np.hypot(*(cv_moved[ok] - true_moved[ok]).T).mean() < 0.2
    assert np.hypot(*(moved[ok] - cv_moved[ok]).T).mean() < 0.2
