"""Production pyramidal-LK pipeline tests (accuracy + API invariants)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import cuda_optical_flow_2_tpu as of
from conftest import make_translating_pair


def _gray(u8_rgb: np.ndarray) -> jnp.ndarray:
    return jnp.asarray(u8_rgb[..., 0].astype(np.float32))


def _epe(flow: np.ndarray, dx: float, dy: float, margin: int = 12) -> float:
    inner = flow[margin:-margin, margin:-margin]
    return float(np.hypot(inner[..., 0] - dx, inner[..., 1] - dy).mean())


def test_single_level_small_shift():
    prev, nxt = make_translating_pair(64, 64, dx=1, dy=0)
    cfg = of.LKConfig(levels=1, window=9, temporal_kernel="gauss3", use_pallas=False)
    flow = np.asarray(of.pyramidal_lk(_gray(prev), _gray(nxt), cfg))
    assert np.isfinite(flow).all()
    assert _epe(flow, 1.0, 0.0) < 0.35


def test_iterations_refine():
    prev, nxt = make_translating_pair(96, 96, dx=1, dy=1, period=12)
    base = of.LKConfig(levels=1, window=11, temporal_kernel="gauss3", use_pallas=False)
    e1 = _epe(
        np.asarray(of.pyramidal_lk(_gray(prev), _gray(nxt), base)), 1.0, 1.0
    )
    e3 = _epe(
        np.asarray(
            of.pyramidal_lk(
                _gray(prev), _gray(nxt),
                of.LKConfig(levels=1, window=11, temporal_kernel="gauss3",
                            iterations=3, use_pallas=False),
            )
        ),
        1.0,
        1.0,
    )
    assert e3 <= e1 + 1e-4, (e1, e3)
    assert e3 < 0.3


def test_weighted_window_stable_under_iteration():
    """The box window's negative transfer sidelobes make re-warping DIVERGE
    (error grows with iterations); "tri"/"gauss" weightings are
    monotone-stable and strictly more accurate at every iteration count
    (LKConfig.window_weights, docs/studies/lk_window_study.py)."""
    prev, nxt = make_translating_pair(128, 160, dx=2, dy=1, period=14)

    def run(ww, iters):
        cfg = of.LKConfig(
            levels=2, window=19, temporal_kernel="gauss3", iterations=iters,
            use_pallas=False, window_weights=ww,
        )
        return _epe(
            np.asarray(of.pyramidal_lk(_gray(prev), _gray(nxt), cfg)), 2.0, 1.0
        )

    box2, box6 = run("box", 2), run("box", 6)
    for ww in ("tri", "gauss"):
        w2, w6 = run(ww, 2), run(ww, 6)
        assert w2 < box2, (ww, w2, box2)
        # iterating must not blow up (box does: error grows with iterations)
        assert w6 < w2 * 1.5 + 0.01, (ww, w2, w6)
        assert w6 < box6, (ww, w6, box6)


def test_pyramid_recovers_large_shift():
    # 6-pixel shift is far outside a single-level 11x11 window's pull-in
    # range; the pyramid (coarse-to-fine warp) must recover it.
    prev, nxt = make_translating_pair(128, 128, dx=6, dy=0, period=24)
    cfg = of.LKConfig(
        levels=3, window=11, temporal_kernel="gauss3", iterations=1, use_pallas=False
    )
    flow = np.asarray(of.pyramidal_lk(_gray(prev), _gray(nxt), cfg))
    single = np.asarray(
        of.pyramidal_lk(
            _gray(prev), _gray(nxt),
            of.LKConfig(levels=1, window=11, temporal_kernel="gauss3",
                        iterations=1, use_pallas=False),
        )
    )
    e_pyr = _epe(flow, 6.0, 0.0, margin=24)
    e_single = _epe(single, 6.0, 0.0, margin=24)
    assert e_pyr < 0.5, f"pyramidal EPE {e_pyr}"
    assert e_pyr < e_single / 4, (e_pyr, e_single)


def test_batched_matches_single():
    prev, nxt = make_translating_pair(64, 64, dx=1, dy=0)
    cfg = of.LKConfig(levels=2, window=9, use_pallas=False)
    p, n = _gray(prev), _gray(nxt)
    single = of.pyramidal_lk(p, n, cfg)
    batched = of.pyramidal_lk(jnp.stack([p, p]), jnp.stack([n, n]), cfg)
    assert batched.shape == (2,) + single.shape
    np.testing.assert_allclose(np.asarray(batched[0]), np.asarray(single), atol=1e-5)
    np.testing.assert_allclose(np.asarray(batched[1]), np.asarray(single), atol=1e-5)


def test_jit_and_config_presets():
    prev, nxt = make_translating_pair(64, 64, dx=1, dy=0)
    p, n = _gray(prev), _gray(nxt)
    for cfg in (of.REFERENCE_GPU, of.REFERENCE_CPU):
        cfg_cpu = of.LKConfig(**{**cfg.__dict__, "use_pallas": False})
        flow = of.pyramidal_lk_jit(p, n, cfg_cpu)
        assert flow.shape == (64, 64, 2)


def test_flow_pyramid_and_composition():
    prev, nxt = make_translating_pair(64, 64, dx=2, dy=0)
    cfg = of.LKConfig(levels=3, window=9, use_pallas=False)
    flows = of.pyramidal_lk_pyramid(_gray(prev), _gray(nxt), cfg)
    assert [f.shape for f in flows] == [(64, 64, 2), (32, 32, 2), (16, 16, 2)]
    # production pipeline already accumulates coarse flow into each level;
    # compose_flow_pyramid is for reference-style per-level *residual*
    # pyramids, so here just check it runs and has the right shape.
    total = of.compose_flow_pyramid([jnp.zeros_like(f) for f in flows])
    assert total.shape == (64, 64, 2)


def test_prefilter_path_runs():
    prev, nxt = make_translating_pair(64, 64, dx=1, dy=0)
    cfg = of.LKConfig(
        levels=2, window=9, use_pallas=False, prefilter=of.BilateralConfig()
    )
    flow = np.asarray(of.pyramidal_lk(_gray(prev), _gray(nxt), cfg))
    assert np.isfinite(flow).all()


def test_compose_flow_pyramid_reference_semantics():
    # hand-check the A3 accumulation (main.cu:138-147) on a 2-level pyramid
    f0 = np.zeros((4, 4, 2), np.float32)
    f1 = np.ones((2, 2, 2), np.float32)
    total = np.asarray(of.compose_flow_pyramid([jnp.asarray(f0), jnp.asarray(f1)]))
    np.testing.assert_allclose(total, 2.0)  # 2^1 * flow[1][i>>1, j>>1]


def test_degenerate_shapes_raise_cleanly():
    tiny = jnp.zeros((4, 4), jnp.float32)
    with pytest.raises(ValueError, match="pyramid levels"):
        of.pyramidal_lk(tiny, tiny, of.LKConfig(levels=4, window=9, use_pallas=False))
    with pytest.raises(ValueError, match="shapes differ"):
        of.pyramidal_lk(
            jnp.zeros((8, 8)), jnp.zeros((8, 9)),
            of.LKConfig(levels=1, use_pallas=False),
        )


def test_odd_sizes_recover_translation():
    """Floor-halved odd dims through the full pyramid (reference semantics,
    main.cu:98-102) must not degrade accuracy.  Uses the aperiodic synthetic
    texture — the checkerboard helper aliases at coarse levels and measures
    the texture, not the code (see docs/PERF.md)."""
    from cuda_optical_flow_2_tpu.utils import io

    for h, w in [(135, 241), (97, 123)]:
        fr = io.synthetic_sequence(2, h, w, velocity=(2.0, 1.0), period=24)
        p = jnp.asarray(fr[0].astype(np.float32))
        n = jnp.asarray(fr[1].astype(np.float32))
        cfg = of.LKConfig(
            levels=3, window=11, temporal_kernel="gauss3", use_pallas=False
        )
        flow = np.asarray(of.pyramidal_lk(p, n, cfg))
        inner = flow[24:-24, 24:-24]
        epe = np.hypot(inner[..., 0] - 2.0, inner[..., 1] - 1.0)
        assert epe.mean() < 0.2, (h, w, epe.mean())
