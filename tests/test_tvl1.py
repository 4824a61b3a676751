"""TV-L1 model family tests."""

import dataclasses  # noqa: F401  (parity with other model test modules)

import numpy as np

import jax.numpy as jnp

from cuda_optical_flow_2_tpu.models import tvl1
from cuda_optical_flow_2_tpu.utils import io


def _pair(h, w, dx, dy, period=24):
    fr = io.synthetic_sequence(2, h, w, velocity=(dx, dy), period=period)
    return (jnp.asarray(fr[0].astype(np.float32)),
            jnp.asarray(fr[1].astype(np.float32)))


def test_translation_accuracy():
    p, n = _pair(128, 160, 2.0, 1.0)
    cfg = tvl1.TVL1Config(levels=3, warps=3, iterations=20)
    f = np.asarray(tvl1.pyramidal_tvl1(p, n, cfg))
    c = f[24:-24, 24:-24]
    epe = float(np.hypot(c[..., 0] - 2, c[..., 1] - 1).mean())
    assert epe < 0.1, epe


def test_config_validation():
    import pytest

    with pytest.raises(ValueError):
        tvl1.TVL1Config(tau=0.5)
    with pytest.raises(ValueError):
        tvl1.TVL1Config(lambda_=0.0)
    with pytest.raises(ValueError):
        tvl1.TVL1Config(warps=0)


def test_divergence_is_negative_adjoint():
    """<div p, u> == -<p, grad u> (the discrete identity the updates need)."""
    rng = np.random.default_rng(0)
    u = jnp.asarray(rng.standard_normal((17, 23)).astype(np.float32))
    px = jnp.asarray(rng.standard_normal((17, 23)).astype(np.float32))
    py = jnp.asarray(rng.standard_normal((17, 23)).astype(np.float32))
    lhs = float(jnp.sum(tvl1._div(px, py) * u))
    rhs = -float(
        jnp.sum(px * tvl1._fwd_diff(u, -1)) + jnp.sum(py * tvl1._fwd_diff(u, -2))
    )
    np.testing.assert_allclose(lhs, rhs, rtol=1e-4)


def test_preserves_motion_discontinuity_vs_hs():
    """TV regularization keeps a two-region motion boundary sharper than
    HS's quadratic smoothness (the reason TV-L1 exists)."""
    from cuda_optical_flow_2_tpu.models import horn_schunck as hs
    from cuda_optical_flow_2_tpu.ops.warp import warp_bilinear

    rng = np.random.default_rng(1)
    h, w = 96, 128
    base = rng.random((h, w)).astype(np.float32)
    tex = np.pad(base, 1, mode="wrap")
    tex = sum(tex[i:i + h, j:j + w] for i in range(3) for j in range(3)) / 9
    tex = (tex - tex.min()) / (np.ptp(tex) + 1e-6) * 255
    # ground truth: left half static, right half moves (3, 0)
    gt = np.zeros((h, w, 2), np.float32)
    gt[:, w // 2:, 0] = 3.0
    nxt = jnp.asarray(tex)
    prev = warp_bilinear(nxt, jnp.asarray(gt))

    f_tv = np.asarray(tvl1.pyramidal_tvl1(
        prev, nxt, tvl1.TVL1Config(levels=3, warps=4, iterations=30)))
    f_hs = np.asarray(hs.pyramidal_hs(
        prev, nxt, hs.HSConfig(levels=3, iterations=80, alpha=8.0)))

    def boundary_width(f):
        # columns (inside rows) where u is in the ambiguous middle band
        prof = np.median(f[16:-16, :, 0], axis=0)
        return int(np.sum((prof > 0.5) & (prof < 2.5)))

    wtv, whs = boundary_width(f_tv), boundary_width(f_hs)
    assert wtv <= whs, (wtv, whs)
    # and both models track the two regions
    assert abs(np.median(f_tv[16:-16, 8:w // 2 - 12, 0])) < 0.4
    assert abs(np.median(f_tv[16:-16, w // 2 + 12:-8, 0]) - 3.0) < 0.4


def test_streaming_tvl1_matches_pairwise():
    from cuda_optical_flow_2_tpu.models import streaming

    frames = io.synthetic_sequence(3, 96, 128, velocity=(1.0, 0.5))
    cfg = tvl1.TVL1Config(levels=2, warps=2, iterations=10)
    flows = {i: np.asarray(f) for i, f in streaming.process_sequence(frames, cfg)}
    assert sorted(flows) == [1, 2]
    for i in (1, 2):
        pair = np.asarray(tvl1.pyramidal_tvl1(
            jnp.asarray(frames[i - 1].astype(np.float32)),
            jnp.asarray(frames[i].astype(np.float32)), cfg))
        np.testing.assert_allclose(flows[i], pair, atol=1e-5)


def test_tvl1_realtime_preset():
    """The documented >=60 fps operating point exists and tracks motion."""
    import dataclasses

    from cuda_optical_flow_2_tpu.models import TVL1_REALTIME
    from cuda_optical_flow_2_tpu.models.tvl1 import pyramidal_tvl1
    from cuda_optical_flow_2_tpu.utils import io

    assert (TVL1_REALTIME.levels, TVL1_REALTIME.warps,
            TVL1_REALTIME.iterations) == (4, 4, 14)
    frames = io.synthetic_sequence(2, 128, 96, velocity=(2.0, 1.0), noise=0.0)
    cfg = dataclasses.replace(TVL1_REALTIME, levels=2)
    flow = np.asarray(pyramidal_tvl1(
        jnp.asarray(frames[0], jnp.float32), jnp.asarray(frames[1], jnp.float32), cfg
    ))
    m = np.median(flow[24:-24, 24:-24], axis=(0, 1))
    assert abs(m[0] - 2) < 0.3 and abs(m[1] - 1) < 0.3, m
