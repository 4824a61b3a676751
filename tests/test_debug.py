"""Per-stage A/B debug tool (utils/debug.py) — the comment-swap workflow."""

import numpy as np

import cuda_optical_flow_2_tpu as of
from cuda_optical_flow_2_tpu.utils import io
from cuda_optical_flow_2_tpu.utils.debug import stage_report


def _pair(h, w, v=(2.0, 1.0)):
    seq = io.synthetic_sequence(2, h, w, velocity=v, noise=0.0)
    return seq[0].astype(np.float32), seq[1].astype(np.float32)


def _by_key(report):
    return {(r.level, r.stage, r.backend): r for r in report}


def test_lk_stage_report_backends_agree():
    prev, nxt = _pair(128, 64)
    # iterations=1: the stage runners take one canonical flow_in.
    # window_weights="box": the oracle backend is the reference's flat srm
    # twin, which only exists for the box window (weighted configs skip the
    # oracle window_sums row — pinned below).
    cfg = of.LKConfig(
        levels=2, window=9, iterations=1, max_displacement=8.0,
        window_weights="box",
    )
    rep = _by_key(
        stage_report(
            prev, nxt, cfg, backends=("pallas", "banded", "oracle"), n_bands=4
        )
    )
    # banded == sharded-math emulation must be exact on every stencil stage
    for (lvl, stage, backend), r in rep.items():
        if backend == "banded":
            assert r.max_abs == 0.0, r
    # the fused residual kernel (interpret mode here) agrees to float noise;
    # the whole-level row takes the kernel only on the GPU
    assert rep[(0, "residual", "pallas")].max_abs < 1e-5
    assert (0, "level", "pallas") not in rep
    # oracle float twins: gradients/solve tight, window sums are the
    # accumulation-order-sensitive stage (documented)
    assert rep[(0, "gradients", "oracle")].max_abs < 1e-4
    assert rep[(0, "solve", "oracle")].max_abs < 1e-5
    assert rep[(0, "window_sums", "oracle")].max_abs < 0.1


def test_lk_stage_report_weighted_window():
    """Weighted-window configs: the window_sums/solve stages use the
    configured weighting (ADVICE r4 — they previously always ran box), and
    the oracle window_sums row is SKIPPED (the reference's flat srm sums
    have no weighted twin)."""
    prev, nxt = _pair(128, 64)
    cfg = of.LKConfig(
        levels=1, window=9, iterations=1, max_displacement=8.0,
        window_weights="tri",
    )
    rep = _by_key(
        stage_report(prev, nxt, cfg, backends=("banded", "oracle"), n_bands=4)
    )
    assert (0, "window_sums", "banded") in rep
    assert rep[(0, "window_sums", "banded")].max_abs == 0.0
    assert (0, "window_sums", "oracle") not in rep
    # solve still has an oracle twin (it consumes the configured sums)
    assert rep[(0, "solve", "oracle")].max_abs < 1e-5


def test_fb_tolerance_decomposes_per_stage():
    """VERDICT r1 item 6 done-criterion: the spatial-FB ~1e-2 end-to-end
    tolerance (tests/test_parallel.py::test_spatial_fb_matches_unsharded)
    decomposes into per-stage banded bounds of <= 2e-5 — the divergence is
    accumulation ACROSS stages/levels, not any single stage."""
    from cuda_optical_flow_2_tpu.models.farneback import FBConfig

    prev, nxt = _pair(512, 64)
    cfg = FBConfig(levels=3, iterations=2, winsize=11, max_displacement=4)
    rep = stage_report(prev, nxt, cfg, backends=("banded",), n_bands=4)
    assert len(rep) >= 9  # 3 stages x 3 levels
    for r in rep:
        assert r.max_abs <= 2e-5, r


def test_cli_diff_smoke(capsys):
    from cuda_optical_flow_2_tpu.cli import diff

    diff.main(
        ["--model", "lk", "--size", "64x64", "--backends", "banded",
         "--levels", "1", "--iterations", "1"]
    )
    out = capsys.readouterr().out
    assert "window_sums" in out and "banded vs xla" in out


def test_flow_stage_with_real_mesh():
    """The end-to-end 'flow' stage diffs unsharded vs the 8-device spatial
    TP pipeline — the full sharding-drift number next to its per-stage
    decomposition."""
    prev, nxt = _pair(256, 48)
    cfg = of.LKConfig(levels=2, window=9, iterations=1, max_displacement=4.0)
    rep = stage_report(
        prev, nxt, cfg, backends=("sharded",), stages=("flow",)
    )
    assert len(rep) == 1 and rep[0].stage == "flow" and rep[0].level == -1
    assert rep[0].max_abs < 1e-3, rep[0]
    assert "E2E" in str(rep[0])


def test_flow_stage_oracle_baseline_skips_not_crashes():
    """A baseline the flow runner can't produce (the LK 'oracle' stages have
    no end-to-end runner) skips the flow row instead of raising on
    np.asarray(None)."""
    prev, nxt = _pair(64, 48)
    cfg = of.LKConfig(levels=2, window=9, iterations=1, max_displacement=4.0)
    rep = stage_report(
        prev, nxt, cfg, backends=("pallas",), baseline="oracle",
        stages=("flow",),
    )
    assert rep == []


def test_stage_report_rejects_unknown_backend():
    """Unknown backend names must error, not yield a silently empty report
    (e.g. a comma-joined `--backends xla,pallas` token)."""
    import numpy as np
    import pytest

    import cuda_optical_flow_2_tpu as of
    from cuda_optical_flow_2_tpu.utils.debug import format_report, stage_report

    prev = np.zeros((32, 32), np.float32)
    with pytest.raises(ValueError, match="unknown backend"):
        stage_report(
            prev, prev, of.LKConfig(levels=1, window=5),
            backends=("xla,pallas",),
        )
    assert "no stages matched" in format_report([])
