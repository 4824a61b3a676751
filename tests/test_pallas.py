"""Fused Pallas-Triton LK residual kernel vs the XLA ops path (interpret mode
on CPU), its lowering for the GPU, and the choice between the two."""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import cuda_optical_flow_2_tpu as of
from cuda_optical_flow_2_tpu.kernels import lk_fused, residual_impl
from cuda_optical_flow_2_tpu.models.lucas_kanade import _lk_residual_xla


def _pair(rng, h, w):
    prev = jnp.asarray(rng.integers(0, 256, (h, w)).astype(np.float32))
    nxt = jnp.asarray(rng.integers(0, 256, (h, w)).astype(np.float32))
    return prev, nxt


@pytest.mark.parametrize(
    "shape,window,tk,norm",
    [
        ((64, 80), 9, "gauss3", True),
        ((61, 77), 19, "dt3", False),
        ((128, 200), 15, "dt3", True),
        ((40, 640), 31, "dt3", True),
    ],
)
def test_fused_matches_xla(rng, shape, window, tk, norm):
    prev, nxt = _pair(rng, *shape)
    cfg = of.LKConfig(
        levels=1, window=window, temporal_kernel=tk,
        normalize_gradients=norm, use_pallas=False,
    )
    want = np.asarray(_lk_residual_xla(prev, nxt, cfg))
    got = np.asarray(lk_fused.lk_residual(prev, nxt, cfg, interpret=True))
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("weights", ["tri", "gauss"])
def test_fused_weighted_window_matches_xla(rng, weights):
    """Weighted integration windows (LKConfig.window_weights) in the fused
    residual kernel vs the XLA sep-conv taps path."""
    prev, nxt = _pair(rng, 61, 77)
    cfg = of.LKConfig(
        levels=1, window=19, window_weights=weights, use_pallas=False
    )
    want = np.asarray(_lk_residual_xla(prev, nxt, cfg))
    got = np.asarray(lk_fused.lk_residual(prev, nxt, cfg, interpret=True))
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("window", [9, 15, 19, 33])
@pytest.mark.parametrize("weights", ["box", "tri", "gauss"])
def test_triton_kernel_matches_twin(rng, weights, window):
    """Every window weighting x window side (both product-grid tiles, up to
    MAX_WINDOW) on an odd, non-power-of-two shape."""
    prev, nxt = _pair(rng, 45, 71)
    cfg = of.LKConfig(levels=1, window=window, window_weights=weights)
    want = np.asarray(_lk_residual_xla(prev, nxt, cfg))
    got = np.asarray(lk_fused.lk_residual(prev, nxt, cfg, interpret=True))
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize(
    "shape", [(1, 5), (8, 8), (33, 129), (64, 64), (3, 40, 56), (2, 1, 17, 30)]
)
def test_triton_kernel_shapes(rng, shape):
    """Shapes smaller than one tile, exactly one tile, several tiles, and
    leading batch axes: output shape and values match the twin."""
    prev = jnp.asarray(rng.integers(0, 256, shape).astype(np.float32))
    nxt = jnp.asarray(rng.integers(0, 256, shape).astype(np.float32))
    cfg = of.LKConfig(levels=1, window=11)
    want = np.asarray(_lk_residual_xla(prev, nxt, cfg))
    got = np.asarray(lk_fused.lk_residual(prev, nxt, cfg, interpret=True))
    assert got.shape == shape + (2,)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


def test_fused_batched(rng):
    prev, nxt = _pair(rng, 48, 64)
    prev2, nxt2 = _pair(rng, 48, 64)
    cfg = of.LKConfig(levels=1, window=9, use_pallas=False)
    single0 = np.asarray(lk_fused.lk_residual(prev, nxt, cfg, interpret=True))
    single1 = np.asarray(lk_fused.lk_residual(prev2, nxt2, cfg, interpret=True))
    batched = np.asarray(
        lk_fused.lk_residual(
            jnp.stack([prev, prev2]), jnp.stack([nxt, nxt2]), cfg, interpret=True
        )
    )
    np.testing.assert_allclose(batched[0], single0, rtol=1e-6)
    np.testing.assert_allclose(batched[1], single1, rtol=1e-6)


def test_fused_unguarded_solve(rng):
    # det_eps=0 reproduces the reference's raw 1/det (inf/nan pass through)
    prev = jnp.zeros((32, 40), jnp.float32)  # flat image -> det == 0
    nxt = jnp.zeros((32, 40), jnp.float32)
    cfg = of.LKConfig(levels=1, window=9, det_eps=0.0, use_pallas=False)
    got = np.asarray(lk_fused.lk_residual(prev, nxt, cfg, interpret=True))
    assert not np.isfinite(got).all()
    cfg_g = of.LKConfig(levels=1, window=9, det_eps=1e-8, use_pallas=False)
    got_g = np.asarray(lk_fused.lk_residual(prev, nxt, cfg_g, interpret=True))
    assert np.all(got_g == 0.0)


def test_triton_kernel_unguarded_matches_twin(rng):
    """det_eps=0 on textured input: the raw-1/det solve agrees with the
    twin's (ops/solve.solve_2x2_unguarded) wherever both are finite."""
    prev, nxt = _pair(rng, 40, 52)
    cfg = of.LKConfig(levels=1, window=9, det_eps=0.0, window_weights="box")
    want = np.asarray(_lk_residual_xla(prev, nxt, cfg))
    got = np.asarray(lk_fused.lk_residual(prev, nxt, cfg, interpret=True))
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


def test_supported_gates_backend(rng):
    prev, _ = _pair(rng, 32, 32)
    # tests run on the CPU backend, so the models must take the XLA twin
    cfg = of.LKConfig(levels=1, window=9)
    assert residual_impl(jax.default_backend(), prev.dtype, prev.shape, cfg) == "xla"


@pytest.mark.parametrize(
    "backend,dtype,window,use_pallas,want",
    [
        ("gpu", jnp.float32, 15, True, "triton"),
        ("gpu", jnp.float32, lk_fused.MAX_WINDOW, True, "triton"),
        ("gpu", jnp.float32, 15, False, "xla"),
        ("gpu", jnp.float32, lk_fused.MAX_WINDOW + 2, True, "xla"),
        ("gpu", jnp.bfloat16, 15, True, "xla"),
        ("gpu", jnp.float64, 15, True, "xla"),
        ("cpu", jnp.float32, 15, True, "xla"),
        ("tpu", jnp.float32, 15, True, "xla"),
    ],
)
def test_residual_impl_choices(backend, dtype, window, use_pallas, want):
    cfg = of.LKConfig(levels=1, window=window, use_pallas=use_pallas)
    assert residual_impl(backend, dtype, (1080, 1920), cfg) == want


def test_full_pipeline_dispatches_pallas(rng, kernel_interpret):
    # levels=1: no warp, so the fused dispatch must match XLA to float noise
    prev, nxt = _pair(rng, 64, 96)
    cfg_pallas = of.LKConfig(levels=1, window=9, use_pallas=True)
    cfg_xla = of.LKConfig(levels=1, window=9, use_pallas=False)
    got = np.asarray(of.pyramidal_lk(prev, nxt, cfg_pallas))
    assert kernel_interpret.calls == 1
    want = np.asarray(of.pyramidal_lk(prev, nxt, cfg_xla))
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-3)


def test_pipeline_with_pallas_warp_matches_xla(kernel_interpret):
    """Multi-level, multi-iteration pipeline through the kernel (XLA's
    gather warp between levels) == the all-XLA pipeline."""
    from conftest import make_translating_pair

    prev, nxt = make_translating_pair(96, 96, dx=2, dy=1, period=16)
    p = jnp.asarray(prev[..., 0].astype(np.float32))
    n = jnp.asarray(nxt[..., 0].astype(np.float32))
    cfg_pallas = of.LKConfig(levels=3, window=9, iterations=2, use_pallas=True)
    cfg_xla = of.LKConfig(levels=3, window=9, iterations=2, use_pallas=False)
    got = np.asarray(of.pyramidal_lk(p, n, cfg_pallas))
    assert kernel_interpret.calls == 6
    want = np.asarray(of.pyramidal_lk(p, n, cfg_xla))
    np.testing.assert_allclose(got, want, atol=1e-3)


def test_random_config_parity_sweep(kernel_interpret):
    """Seeded sweep over the LK config space: kernel (interpret) vs XLA on
    random shapes (incl. odd), windows, weights, temporal kernels,
    iteration counts and normalization — insurance against
    dispatch/config-space regressions a fixed-config test can't see."""
    from cuda_optical_flow_2_tpu.utils import io

    rng_ = np.random.default_rng(7)
    for case in range(4):
        h = int(rng_.integers(48, 96))
        w = int(rng_.integers(56, 112))
        v = (float(rng_.uniform(-2, 2)), float(rng_.uniform(-1.5, 1.5)))
        seq = io.synthetic_sequence(2, h, w, velocity=v, noise=0.0)
        p, n = (jnp.asarray(s, jnp.float32) for s in seq)
        kw = dict(
            levels=int(rng_.integers(1, 3)),
            window=int(rng_.choice([5, 9, 11, 15])),
            window_weights=str(rng_.choice(["box", "tri", "gauss"])),
            iterations=int(rng_.integers(1, 3)),
            temporal_kernel=str(rng_.choice(["dt3", "gauss3"])),
            normalize_gradients=bool(rng_.integers(0, 2)),
        )
        got = np.asarray(of.pyramidal_lk(p, n, of.LKConfig(use_pallas=True, **kw)))
        want = np.asarray(of.pyramidal_lk(p, n, of.LKConfig(use_pallas=False, **kw)))
        err = np.abs(got - want)
        assert np.median(err) < 2e-3, (case, kw, np.median(err))
        assert np.percentile(err, 99) < 0.1, (case, kw, np.percentile(err, 99))
    assert kernel_interpret.calls > 0


def _cuda_text(fn, *args) -> str:
    return jax.jit(fn).trace(*args).lower(lowering_platforms=("cuda",)).as_text()


@pytest.mark.parametrize("window", [5, 15, 33])
def test_triton_kernel_lowers_for_cuda(window):
    """The compiled route: the kernel lowers to one Triton call for the GPU
    (cross-lowered here, so Pallas-Triton rejections show up on the CPU)."""
    x = jnp.zeros((70, 130), jnp.float32)
    cfg = of.LKConfig(levels=1, window=window)
    text = _cuda_text(lambda a, b: lk_fused.lk_residual(a, b, cfg), x, x)
    assert text.count("__gpu$xla.gpu.triton") == 1


@pytest.mark.parametrize("model", ["lk", "dis"])
def test_gpu_pipeline_lowers_one_kernel_per_solve(monkeypatch, model):
    """With the GPU backend, PAPER_1080P-style LK and DIS pipelines call the
    kernel once per level and iteration (DIS in its centered mode)."""
    from cuda_optical_flow_2_tpu.models import dis

    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    x = jnp.zeros((96, 160), jnp.float32)
    if model == "lk":
        cfg = dataclasses.replace(of.PAPER_1080P, levels=3, iterations=2)
        fn = lambda a, b: of.pyramidal_lk(a, b, cfg)  # noqa: E731
    else:
        cfg = dis.DISConfig(levels=3, iterations=2, refine_iterations=1)
        fn = lambda a, b: dis.pyramidal_dis(a, b, cfg)  # noqa: E731
    want = cfg.levels * cfg.iterations
    assert _cuda_text(fn, x, x).count("__gpu$xla.gpu.triton") == want
