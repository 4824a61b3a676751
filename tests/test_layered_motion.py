"""Layered-motion benchmark: discontinuity + occlusion truth in CI.

Twin of docs/studies/layered_motion_study.py (VERDICT r4 item 1): the study
measures, these tests pin the measured numbers with safety margins.  Keep
the scene parameters and model configs identical in both, or the bounds
stop matching the study's envelopes.

Measured provenance (study run, round 5, CPU/XLA path, 192x256, margin 16):

* matched-EPE disk case: LK/tri 0.153, HS 0.263, FB 0.161, TVL1 0.026,
  DIS 0.152 (cv2 anchors 0.130 / 0.163 / 0.116 — same scenes).
* bar case: TVL1 band6 EPE 1.36 vs HS 3.01; u-step blur width TVL1 2.72 px
  vs HS 4.45 px.
* occlusion detection (occlusion_score on bidirectional TV-L1, alpha=0.01,
  beta=0.5): disk P 0.66 / R 0.71 / AP 0.66; bar AP 0.75.  On DIS flow AP
  drops to ~0.2 and on LK to ~0.1 (boundary blur drives detection quality),
  so the detector tests run on TV-L1.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from cuda_optical_flow_2_tpu.utils.layered import (
    Layer,
    boundary_band,
    layered_scene,
)

H, W = 192, 256
MARGIN = 16
BAND = 6


@pytest.fixture(scope="module")
def disk_scene():
    return layered_scene(
        H, W, bg_flow=(-2.0, 1.0),
        layers=[Layer("disk", (96.0, 128.0), 45.0, (3.0, 1.0))],
        seed=3,
    )


@pytest.fixture(scope="module")
def bar_scene():
    return layered_scene(
        H, W, bg_flow=(-3.0, 0.0),
        layers=[Layer("rect", (96.0, 128.0), (120.0, 22.0), (4.0, 0.0))],
        seed=7,
    )


def _run(family, prev, nxt):
    prev = jnp.asarray(prev, jnp.float32)
    nxt = jnp.asarray(nxt, jnp.float32)
    if family == "lk":
        import cuda_optical_flow_2_tpu as of

        cfg = of.LKConfig(
            levels=3, window=19, iterations=2, temporal_kernel="gauss3",
            use_pallas=False, max_displacement=8, window_weights="tri",
        )
        return np.asarray(of.pyramidal_lk(prev, nxt, cfg))
    if family == "hs":
        from cuda_optical_flow_2_tpu.models.horn_schunck import (
            HSConfig, pyramidal_hs,
        )

        return np.asarray(pyramidal_hs(
            prev, nxt, HSConfig(levels=3, iterations=60)))
    if family == "fb":
        from cuda_optical_flow_2_tpu.models import farneback as fb

        cfg = fb.FBConfig(
            levels=3, iterations=3, poly_n=7, poly_sigma=1.5, winsize=15,
            warp_planes="coeff", max_displacement=8,
        )
        return np.asarray(fb.pyramidal_farneback(prev, nxt, cfg))
    if family == "tvl1":
        from cuda_optical_flow_2_tpu.models.tvl1 import (
            TVL1Config, pyramidal_tvl1,
        )

        return np.asarray(pyramidal_tvl1(
            prev, nxt, TVL1Config(levels=3)))
    from cuda_optical_flow_2_tpu.models import dis

    return np.asarray(dis.pyramidal_dis(
        prev, nxt, dis.DISConfig(use_pallas=False, max_displacement=8)))


def _epe_masked(flow, sc, mask):
    d = flow - sc.flow
    e = np.hypot(d[..., 0], d[..., 1])
    interior = np.zeros_like(sc.occ)
    interior[MARGIN:-MARGIN, MARGIN:-MARGIN] = True
    return float(e[mask & interior].mean())


# --- generator self-checks --------------------------------------------------

def test_generator_truth_exact(disk_scene):
    """Warping nxt by the truth flow reproduces prev on visible pixels and
    fails at occluded ones — the scene's truth is self-consistent."""
    sc = disk_scene
    ys, xs = np.mgrid[0:H, 0:W].astype(np.float64)
    sy, sx = ys + sc.flow[..., 1], xs + sc.flow[..., 0]
    y0 = np.clip(np.floor(sy).astype(int), 0, H - 2)
    x0 = np.clip(np.floor(sx).astype(int), 0, W - 2)
    fy, fx = np.clip(sy - y0, 0, 1), np.clip(sx - x0, 0, 1)
    n = sc.nxt.astype(np.float64)
    samp = (
        n[y0, x0] * (1 - fy) * (1 - fx)
        + n[y0, x0 + 1] * (1 - fy) * fx
        + n[y0 + 1, x0] * fy * (1 - fx)
        + n[y0 + 1, x0 + 1] * fy * fx
    )
    resid = np.abs(samp - sc.prev)
    band = boundary_band(sc.owner, 3)
    visible = ~sc.occ & ~band
    visible[:8] = visible[-8:] = False
    visible[:, :8] = visible[:, -8:] = False
    assert resid[visible].mean() < 0.5          # measured 0.021
    assert resid[sc.occ & ~band].mean() > 5.0   # measured 19.7
    # occlusion exists and is a minority
    assert 0.005 < sc.occ.mean() < 0.2
    # ownership matches the flow field
    assert np.all(sc.flow[sc.owner == 0] == np.float32((3.0, 1.0)))
    assert np.all(sc.flow[sc.owner == -1] == np.float32((-2.0, 1.0)))


def test_boundary_band_grows_monotonically(disk_scene):
    b2 = boundary_band(disk_scene.owner, 2)
    b6 = boundary_band(disk_scene.owner, 6)
    assert b2.sum() > 0
    assert np.all(b6 | ~b2)  # b2 subset of b6
    assert b6.sum() > b2.sum()


def test_occlusion_mask_is_thresholded_score(rng):
    """occlusion_mask == occlusion_score > beta (API contract the PR-curve
    machinery relies on)."""
    from cuda_optical_flow_2_tpu.models import consistency

    fw = jnp.asarray(rng.normal(0, 2, (32, 48, 2)), jnp.float32)
    bw = jnp.asarray(rng.normal(0, 2, (32, 48, 2)), jnp.float32)
    mask = np.asarray(consistency.occlusion_mask(fw, bw, 0.01, 0.5))
    score = np.asarray(consistency.occlusion_score(fw, bw, 0.01))
    np.testing.assert_array_equal(mask, score > 0.5)


# --- per-family accuracy on discontinuous motion ----------------------------

@pytest.mark.parametrize(
    "family,bound",
    [("lk", 0.3), ("hs", 0.5), ("fb", 0.32), ("tvl1", 0.10), ("dis", 0.3)],
)
def test_matched_epe_disk(disk_scene, family, bound):
    """Matched (non-occluded) EPE on the disk-over-background scene stays at
    the anchor-harness level despite the discontinuity (measured: 0.153 /
    0.263 / 0.161 / 0.026 / 0.152; cv2 anchors at 0.116-0.163)."""
    flow = _run(family, disk_scene.prev, disk_scene.nxt)
    assert _epe_masked(flow, disk_scene, ~disk_scene.occ) < bound


def test_unmatched_epe_worse_than_matched(disk_scene):
    """Occluded pixels really are the hard ones: unmatched EPE is an order
    of magnitude above matched for the flagship (sanity of the split)."""
    flow = _run("lk", disk_scene.prev, disk_scene.nxt)
    matched = _epe_masked(flow, disk_scene, ~disk_scene.occ)
    unmatched = _epe_masked(flow, disk_scene, disk_scene.occ)
    assert unmatched > 4 * matched


def test_tvl1_discontinuity_sharper_than_hs(bar_scene):
    """The numeric form of TV-L1's marquee property (previously pinned only
    qualitatively): band-6 EPE and u-step blur width both beat HS by a wide
    measured margin (1.36 vs 3.01; 2.72 px vs 4.45 px)."""
    sc = bar_scene
    tv = _run("tvl1", sc.prev, sc.nxt)
    hs = _run("hs", sc.prev, sc.nxt)
    band = boundary_band(sc.owner, BAND)
    tv_band = _epe_masked(tv, sc, band)
    hs_band = _epe_masked(hs, sc, band)
    assert tv_band < 0.65 * hs_band
    assert tv_band < 2.0  # absolute: measured 1.36

    def blur_width(flow):
        rows = slice(MARGIN, H - MARGIN)
        prof = flow[rows, :, 0].mean(axis=0)
        tprof = sc.flow[rows, :, 0].mean(axis=0)
        widths = [
            np.abs(prof[x0 - 15:x0 + 16] - tprof[x0 - 15:x0 + 16]).sum() / 7.0
            for x0 in (128 - 22, 128 + 22)
        ]
        return float(np.mean(widths))

    assert blur_width(tv) < 0.8 * blur_width(hs)
    assert blur_width(tv) < 3.5  # measured 2.72


# --- occlusion detection ----------------------------------------------------

def _detection(sc, family="tvl1"):
    from cuda_optical_flow_2_tpu.models import consistency

    fw = _run(family, sc.prev, sc.nxt)
    bw = _run(family, sc.nxt, sc.prev)
    return np.asarray(consistency.occlusion_score(
        jnp.asarray(fw), jnp.asarray(bw), alpha=0.01))


def test_occlusion_detection_tvl1_disk(disk_scene):
    """occlusion_mask as a detector against true occlusion geometry
    (measured at the default beta=0.5: P 0.66, R 0.71)."""
    sc = disk_scene
    score = _detection(sc)
    interior = np.zeros((H, W), bool)
    interior[MARGIN:-MARGIN, MARGIN:-MARGIN] = True
    pred = (score > 0.5)[interior]
    truth = sc.occ[interior]
    tp = (pred & truth).sum()
    precision = tp / max(pred.sum(), 1)
    recall = tp / max(truth.sum(), 1)
    assert precision > 0.45
    assert recall > 0.50


def test_occlusion_detection_ap_bar(bar_scene):
    """Average precision of the swept detector on the bar scene (measured
    0.75; the same sweep on DIS flow gives ~0.26 — boundary sharpness of
    the underlying flow is what detection quality tracks)."""
    sc = bar_scene
    score = _detection(sc)
    interior = np.zeros((H, W), bool)
    interior[MARGIN:-MARGIN, MARGIN:-MARGIN] = True
    s, t = score[interior], sc.occ[interior]
    prec, rec = [], []
    for b in np.concatenate([np.linspace(-2, 0, 20), np.geomspace(0.01, 50, 50)]):
        pred = s > b
        tp = (pred & t).sum()
        prec.append(tp / max(pred.sum(), 1))
        rec.append(tp / max(t.sum(), 1))
    order = np.argsort(rec)
    ap = float(np.trapezoid(np.array(prec)[order], np.array(rec)[order]))
    assert ap > 0.55
