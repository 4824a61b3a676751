"""Sharded batching tests on the virtual 8-device CPU mesh (BASELINE config 5)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import cuda_optical_flow_2_tpu as of
from cuda_optical_flow_2_tpu import parallel
from conftest import make_translating_pair


def test_mesh_has_8_virtual_devices():
    assert len(jax.devices()) == 8


def test_sharded_matches_unsharded():
    prev, nxt = make_translating_pair(64, 64, dx=1, dy=0)
    p = jnp.asarray(prev[..., 0].astype(np.float32))
    n = jnp.asarray(nxt[..., 0].astype(np.float32))
    pb = jnp.stack([p] * 8)
    nb = jnp.stack([n] * 8)
    cfg = of.LKConfig(levels=2, window=9, use_pallas=False)
    mesh = parallel.make_mesh()
    flow = parallel.sharded_pyramidal_lk(pb, nb, cfg, mesh)
    assert flow.shape == (8, 64, 64, 2)
    # output really is sharded over the batch axis
    assert len(flow.sharding.device_set) == 8
    single = of.pyramidal_lk(p, n, cfg)
    for i in range(8):
        np.testing.assert_allclose(
            np.asarray(flow[i]), np.asarray(single), atol=1e-5
        )


def test_batch_not_divisible_raises():
    mesh = parallel.make_mesh()
    x = jnp.zeros((3, 16, 16))
    try:
        parallel.sharded_pyramidal_lk(x, x, of.LKConfig(levels=1, use_pallas=False), mesh)
        raised = False
    except ValueError:
        raised = True
    assert raised


# ---------------------------------------------------------------------------
# Spatial (tensor-parallel) sharding: rows of ONE pair over the mesh
# ---------------------------------------------------------------------------


def _smooth_pair(h, w, dx, dy):
    prev, nxt = make_translating_pair(h, w, dx=dx, dy=dy)
    return (
        jnp.asarray(prev[..., 0].astype(np.float32)),
        jnp.asarray(nxt[..., 0].astype(np.float32)),
    )


def test_halo_exchange_matches_numpy():
    from functools import partial
    from jax.sharding import PartitionSpec as P
    from cuda_optical_flow_2_tpu.parallel.spatial import halo_exchange, shard_map

    mesh = parallel.make_mesh(axis_name="space")
    x = jnp.arange(8 * 4 * 6, dtype=jnp.float32).reshape(8 * 4, 6)

    def local(blk):
        return halo_exchange(blk, 2, 1, "space", 8)

    out = shard_map(
        local, mesh=mesh, in_specs=(P("space", None),), out_specs=P("space", None)
    )(x)
    out = np.asarray(out).reshape(8, 7, 6)
    xn = np.asarray(x).reshape(8, 4, 6)
    padded = np.concatenate(
        [np.zeros((1, 4, 6), np.float32), xn, np.zeros((1, 4, 6), np.float32)]
    )
    for i in range(8):
        np.testing.assert_array_equal(out[i, :2], padded[i, -2:])
        np.testing.assert_array_equal(out[i, 2:6], xn[i])
        np.testing.assert_array_equal(out[i, 6:], padded[i + 2, :1])


def test_spatial_matches_unsharded():
    """Row-sharded pipeline == unsharded pipeline, float-for-float tolerance.

    Flow magnitudes stay under max_displacement so the sharded path's clamp
    (its one documented semantic difference) never binds.  Pinned to the
    box window: this aliasing-heavy checkerboard pair produces a chaotic
    flow field (EPE ~2.8 px against the true translation in BOTH paths),
    and the tapered windows shrink the effective support enough that a few
    hundred near-tied warp floor()/guard decisions flip between the band
    and whole-image reduction orders — see
    test_spatial_matches_unsharded_weighted for the robust-statistic pin
    of the default ("tri") weighting.
    """
    p, n = _smooth_pair(1024, 64, dx=2, dy=1)
    cfg = of.LKConfig(
        levels=3, window=9, iterations=2, temporal_kernel="gauss3",
        use_pallas=False, max_displacement=16.0, window_weights="box",
    )
    mesh = parallel.make_mesh(axis_name="space")
    flow = parallel.spatial_pyramidal_lk(p, n, cfg, mesh)
    assert flow.shape == (1024, 64, 2)
    assert len(flow.sharding.device_set) == 8
    single = of.pyramidal_lk(p, n, cfg)
    # Tolerance note: the coarse-to-fine warp amplifies float reduction-order
    # noise (each level's flow feeds the next warp's sample coordinates), so
    # deep pyramids drift ~1e-3; single-level exactness is pinned at 1e-4 by
    # test_spatial_single_level_exact.
    np.testing.assert_allclose(np.asarray(flow), np.asarray(single), atol=5e-3)


def test_spatial_matches_unsharded_weighted():
    """The default ("tri") weighting under spatial TP: robust-statistic
    equivalence.  On the chaotic checkerboard field isolated near-tied
    decisions legitimately flip between reduction orders (max |delta| can
    reach px scale at ~0.3% of pixels), so the pin is mean + p99.9 + equal
    EPE, not max."""
    p, n = _smooth_pair(1024, 64, dx=2, dy=1)
    cfg = of.LKConfig(
        levels=3, window=9, iterations=2, temporal_kernel="gauss3",
        use_pallas=False, max_displacement=16.0, window_weights="tri",
    )
    mesh = parallel.make_mesh(axis_name="space")
    flow = np.asarray(parallel.spatial_pyramidal_lk(p, n, cfg, mesh))
    single = np.asarray(of.pyramidal_lk(p, n, cfg))
    d = np.abs(flow - single)
    assert d.mean() < 5e-3, d.mean()
    assert np.percentile(d, 99.9) < 0.25, np.percentile(d, 99.9)

    def epe(x):
        return float(
            np.hypot(x[12:-12, 12:-12, 0] - 2, x[12:-12, 12:-12, 1] - 1).mean()
        )

    assert abs(epe(flow) - epe(single)) < 5e-3, (epe(flow), epe(single))


def test_spatial_single_level_exact():
    p, n = _smooth_pair(64, 48, dx=1, dy=0)
    cfg = of.LKConfig(levels=1, window=11, use_pallas=False)
    mesh = parallel.make_mesh(axis_name="space")
    flow = parallel.spatial_pyramidal_lk(p, n, cfg, mesh)
    single = of.pyramidal_lk(p, n, cfg)
    np.testing.assert_allclose(np.asarray(flow), np.asarray(single), atol=1e-4)


def test_spatial_validation_errors():
    mesh = parallel.make_mesh(axis_name="space")
    p = jnp.zeros((100, 64), jnp.float32)  # 100 not divisible by 8*4
    cfg = of.LKConfig(levels=3, window=9, use_pallas=False)
    with pytest.raises(ValueError):
        parallel.spatial_pyramidal_lk(p, p, cfg, mesh)
    # coarsest level too short for the halos
    q = jnp.zeros((128, 64), jnp.float32)
    big = of.LKConfig(levels=3, window=31, use_pallas=False)
    with pytest.raises(ValueError):
        parallel.spatial_pyramidal_lk(q, q, big, mesh)


def test_spatial_coarsest_level_needs_no_warp_halo():
    """iterations=1 => the coarsest level never warps, so it only needs the
    gradient halo; this config was wrongly rejected before the per-level
    validation (level-2 has 32 rows/shard < r_img=40 but never warps)."""
    p, n = _smooth_pair(1024, 64, dx=1, dy=0)
    cfg = of.LKConfig(levels=3, window=9, iterations=1, use_pallas=False,
                      temporal_kernel="gauss3", max_displacement=32)
    mesh = parallel.make_mesh(axis_name="space")
    flow = parallel.spatial_pyramidal_lk(p, n, cfg, mesh)
    single = of.pyramidal_lk(p, n, cfg)
    np.testing.assert_allclose(np.asarray(flow), np.asarray(single), atol=5e-3)


def test_grid_dp_x_tp_matches_unsharded():
    """2-D mesh: batch data-parallel x rows tensor-parallel (2x4 of 8 CPUs)."""
    from jax.sharding import Mesh

    p0, n0 = _smooth_pair(256, 48, dx=1, dy=0)
    p1, n1 = _smooth_pair(256, 48, dx=2, dy=1)
    pb = jnp.stack([p0, p1, p0, p1])
    nb = jnp.stack([n0, n1, n0, n1])
    cfg = of.LKConfig(levels=2, window=9, iterations=1, use_pallas=False,
                      temporal_kernel="gauss3", max_displacement=4.0)
    devices = np.asarray(jax.devices()).reshape(2, 4)
    mesh = Mesh(devices, ("batch", "space"))
    flow = parallel.grid_pyramidal_lk(pb, nb, cfg, mesh)
    assert flow.shape == (4, 256, 48, 2)
    assert len(flow.sharding.device_set) == 8
    for i, (p, n) in enumerate([(p0, n0), (p1, n1)] * 2):
        single = of.pyramidal_lk(p, n, cfg)
        np.testing.assert_allclose(
            np.asarray(flow[i]), np.asarray(single), atol=5e-4
        )


def test_sharded_flow_model_generic():
    """sharded_flow dispatches on config type: HS and FB batches shard too."""
    from cuda_optical_flow_2_tpu.models import farneback as fb
    from cuda_optical_flow_2_tpu.models import horn_schunck as hs
    from cuda_optical_flow_2_tpu.models import pyramidal_flow

    prev, nxt = make_translating_pair(64, 64, dx=1, dy=0)
    p = jnp.asarray(prev[..., 0].astype(np.float32))
    n = jnp.asarray(nxt[..., 0].astype(np.float32))
    pb, nb = jnp.stack([p] * 8), jnp.stack([n] * 8)
    mesh = parallel.make_mesh()
    from cuda_optical_flow_2_tpu.models import dis

    for cfg in (
        hs.HSConfig(levels=2, iterations=20),
        fb.FBConfig(levels=2, iterations=2),
        dis.DISConfig(levels=2, iterations=1, refine_iterations=2,
                      use_pallas=False),
    ):
        flow = parallel.sharded_flow(pb, nb, cfg, mesh)
        assert flow.shape == (8, 64, 64, 2)
        assert len(flow.sharding.device_set) == 8
        single = pyramidal_flow(p, n, cfg)
        np.testing.assert_allclose(
            np.asarray(flow[0]), np.asarray(single), atol=1e-5
        )


def test_spatial_hs_matches_unsharded():
    from cuda_optical_flow_2_tpu.models import horn_schunck as hs

    p, n = _smooth_pair(512, 64, dx=2, dy=1)
    cfg = hs.HSConfig(alpha=8.0, iterations=20, levels=3, max_displacement=16)
    mesh = parallel.make_mesh(axis_name="space")
    flow = parallel.spatial_pyramidal_hs(p, n, cfg, mesh, sweep_tile=6)
    assert flow.shape == (512, 64, 2)
    assert len(flow.sharding.device_set) == 8
    want = hs.pyramidal_hs(p, n, cfg)
    np.testing.assert_allclose(
        np.asarray(flow), np.asarray(want), atol=5e-4
    )


def test_spatial_fb_matches_unsharded():
    from cuda_optical_flow_2_tpu.models import farneback as fb

    p, n = _smooth_pair(512, 64, dx=2, dy=1)
    cfg = fb.FBConfig(levels=3, iterations=2, winsize=11, max_displacement=4)
    mesh = parallel.make_mesh(axis_name="space")
    flow = parallel.spatial_pyramidal_fb(p, n, cfg, mesh)
    assert flow.shape == (512, 64, 2)
    assert len(flow.sharding.device_set) == 8
    want = fb.pyramidal_farneback(p, n, cfg)
    # Parity is structural, not bitwise: FB's normal-equation chain
    # amplifies XLA fusion/reassociation ulps (products -> 121-tap window
    # sums -> det division) to ~1e-2 worst-case on 8-bit inputs; stage-by-
    # stage diffs are <=2e-5 before the sums (see spatial_models docstring).
    np.testing.assert_allclose(
        np.asarray(flow), np.asarray(want), atol=2e-2
    )
    inner = np.asarray(flow)[32:-32, 16:-16]
    med = np.median(inner, axis=(0, 1))
    assert abs(med[0] - 2) < 0.1 and abs(med[1] - 1) < 0.1, med


def test_spatial_hs_single_scale_exact():
    """levels=1 HS: pure relaxation, no warp — sharded == unsharded tightly."""
    from cuda_optical_flow_2_tpu.models import horn_schunck as hs

    p, n = _smooth_pair(256, 48, dx=1, dy=0)
    cfg = hs.HSConfig(alpha=10.0, iterations=25, levels=1)
    mesh = parallel.make_mesh(axis_name="space")
    flow = parallel.spatial_pyramidal_hs(p, n, cfg, mesh, sweep_tile=7)
    want = hs.pyramidal_hs(p, n, cfg)
    np.testing.assert_allclose(
        np.asarray(flow), np.asarray(want), atol=1e-5
    )


def test_multihost_scaffolding_single_process():
    """Global-mesh helpers work in-process (1 host, 8 local devices)."""
    from cuda_optical_flow_2_tpu.parallel import multihost

    mesh = multihost.make_global_mesh()
    assert mesh.shape["batch"] == 8
    mesh2 = multihost.make_global_mesh(space_axis="space")
    assert mesh2.shape["batch"] == 1 and mesh2.shape["space"] == 8
    per, off = multihost.host_local_batch(16, mesh)
    assert (per, off) == (16, 0)
    # DP over the global mesh end-to-end
    prev, nxt = make_translating_pair(32, 48, dx=1, dy=0)
    p = jnp.stack([jnp.asarray(prev[..., 0].astype(np.float32))] * 8)
    n = jnp.stack([jnp.asarray(nxt[..., 0].astype(np.float32))] * 8)
    flow = parallel.sharded_flow(
        p, n, of.LKConfig(levels=1, window=9, use_pallas=False), mesh
    )
    assert flow.shape == (8, 32, 48, 2)


def test_spatial_tvl1_matches_unsharded():
    from cuda_optical_flow_2_tpu.models import tvl1

    p, n = _smooth_pair(512, 64, dx=2, dy=1)
    # max_displacement=16 keeps the sharded path's always-on budget clamp
    # non-binding (this texture's TV-L1 has outlier pixels up to ~6 px —
    # the one documented semantic difference, as in the LK spatial test)
    cfg = tvl1.TVL1Config(levels=2, warps=2, iterations=10, max_displacement=16)
    mesh = parallel.make_mesh(axis_name="space")
    flow = parallel.spatial_pyramidal_tvl1(p, n, cfg, mesh, iter_tile=5)
    assert flow.shape == (512, 64, 2)
    assert len(flow.sharding.device_set) == 8
    want = tvl1.pyramidal_tvl1(p, n, cfg)
    np.testing.assert_allclose(np.asarray(flow), np.asarray(want), atol=5e-4)


def test_spatial_dis_matches_unsharded():
    """Spatial-TP DIS (centered band search + banded refinement) ==
    unsharded, with and without mean normalization and with the
    finest_level knob.

    Parity is structural, not bitwise: at 3 levels this texture's coarsest
    level (256x16) has near-singular windows whose guarded solves amplify
    band-vs-whole-image conv reassociation ulps (verified: the same
    comparison in float64 agrees to 3.5e-13, so the banded logic is exactly
    the unsharded logic) — the FB-precedent tolerance applies, plus a tight
    median check on the well-conditioned interior.
    """
    from cuda_optical_flow_2_tpu.models import dis

    p, n = _smooth_pair(1024, 64, dx=1, dy=2)
    mesh = parallel.make_mesh(axis_name="space")
    for kw in (
        dict(mean_normalize=True),
        dict(mean_normalize=False),
        dict(finest_level=1, iterations=1, refine_iterations=3),
    ):
        cfg = dis.DISConfig(levels=3, iterations=kw.pop("iterations", 2),
                            refine_iterations=kw.pop("refine_iterations", 5),
                            window=9, use_pallas=False, max_displacement=8,
                            **kw)
        flow = parallel.spatial_pyramidal_dis(p, n, cfg, mesh)
        assert flow.shape == (1024, 64, 2)
        assert len(flow.sharding.device_set) == 8
        want = dis.pyramidal_dis(p, n, cfg)
        np.testing.assert_allclose(
            np.asarray(flow), np.asarray(want), atol=2e-2
        )
        inner = np.asarray(flow)[64:-64, 16:-16]
        med = np.median(inner, axis=(0, 1))
        assert abs(med[0] - 1) < 0.1 and abs(med[1] - 2) < 0.1, med


def test_spatial_hs_charbonnier_matches_unsharded():
    """Robust HS under spatial TP == unsharded.  iterations
    <= sweep_tile so the band IRLS cadence equals the unsharded chunking
    (see spatial_pyramidal_dis docstring — same rule for HS)."""
    from cuda_optical_flow_2_tpu.models import horn_schunck as hs

    p, n = _smooth_pair(1024, 64, dx=1, dy=2)
    mesh = parallel.make_mesh(axis_name="space")
    base = dict(levels=2, iterations=8, alpha=20.0, penalty="charbonnier",
                max_displacement=8)
    cfg = hs.HSConfig(**base)
    flow = parallel.spatial_pyramidal_hs(p, n, cfg, mesh, sweep_tile=8)
    assert len(flow.sharding.device_set) == 8
    want = hs.pyramidal_hs(p, n, cfg)
    np.testing.assert_allclose(np.asarray(flow), np.asarray(want), atol=1e-4)


def test_spatial_dis_charbonnier_matches_unsharded():
    """Charbonnier (robust) banded refinement == unsharded.

    The lagged-diffusivity weights are recomputed per chunk from band-local
    flow with a k+1 halo (the weights' central-difference ring); parity at
    refine_iterations <= sweep_tile, where the band chunk cadence equals
    the unsharded one (see spatial_pyramidal_dis docstring)."""
    from cuda_optical_flow_2_tpu.models import dis

    p, n = _smooth_pair(1024, 64, dx=1, dy=2)
    mesh = parallel.make_mesh(axis_name="space")
    base = dict(levels=3, iterations=2, refine_iterations=5, window=9,
                max_displacement=8, refine_penalty="charbonnier",
                refine_alpha=40.0, refine_eps_data=10.0)
    cfg = dis.DISConfig(**base, use_pallas=False)
    flow = parallel.spatial_pyramidal_dis(p, n, cfg, mesh)
    assert len(flow.sharding.device_set) == 8
    want = dis.pyramidal_dis(p, n, cfg)
    np.testing.assert_allclose(np.asarray(flow), np.asarray(want), atol=2e-2)
    inner = np.asarray(flow)[64:-64, 16:-16]
    med = np.median(inner, axis=(0, 1))
    assert abs(med[0] - 1) < 0.1 and abs(med[1] - 2) < 0.1, med


def test_grid_flow_model_generic():
    """grid_pyramidal_flow (DP x TP on a 2-D mesh) == unsharded batch for
    every model family, via the one model-generic entry."""
    from jax.sharding import Mesh
    from cuda_optical_flow_2_tpu.models import dis, pyramidal_flow, tvl1
    from cuda_optical_flow_2_tpu.models import farneback as fb
    from cuda_optical_flow_2_tpu.models import horn_schunck as hs

    p, n = _smooth_pair(256, 48, dx=2, dy=1)
    pb, nb = jnp.stack([p, p * 0.5]), jnp.stack([n, n * 0.5])
    gmesh = Mesh(np.asarray(jax.devices()).reshape(2, 4), ("batch", "space"))
    cfgs_tols = [
        (of.LKConfig(levels=2, window=9, iterations=1, max_displacement=4.0,
                     use_pallas=False), 1e-4),
        (hs.HSConfig(alpha=8.0, iterations=8, levels=2, max_displacement=8), 1e-4),
        # FB's documented reassociation-amplification tolerance (see
        # test_spatial_fb_matches_unsharded)
        (fb.FBConfig(levels=2, iterations=1, winsize=11, max_displacement=4), 2e-2),
        (tvl1.TVL1Config(levels=2, warps=1, iterations=8, max_displacement=8), 1e-4),
        (dis.DISConfig(levels=2, iterations=1, refine_iterations=3, window=9,
                       use_pallas=False, max_displacement=8), 1e-4),
    ]
    for cfg, tol in cfgs_tols:
        flow = parallel.grid_pyramidal_flow(
            pb, nb, cfg, gmesh, sweep_tile=4, iter_tile=4
        )
        assert flow.shape == (2, 256, 48, 2)
        assert len(flow.sharding.device_set) == 8
        want = pyramidal_flow(pb, nb, cfg)
        np.testing.assert_allclose(
            np.asarray(flow), np.asarray(want), atol=tol
        )


def test_spatial_flow_model_generic_dispatch():
    """spatial_pyramidal_flow routes each config type to its family entry
    (spot-checked against the direct entries) and rejects unknown configs."""
    from cuda_optical_flow_2_tpu.models import horn_schunck as hs

    p, n = _smooth_pair(256, 48, dx=2, dy=1)
    mesh = parallel.make_mesh(axis_name="space")
    cfg = hs.HSConfig(alpha=8.0, iterations=8, levels=2, max_displacement=8)
    a = parallel.spatial_pyramidal_flow(p, n, cfg, mesh, sweep_tile=4)
    b = parallel.spatial_pyramidal_hs(p, n, cfg, mesh, sweep_tile=4)
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    with pytest.raises(TypeError, match="config must be"):
        from cuda_optical_flow_2_tpu.parallel.spatial_models import (
            _family_local,
        )
        _family_local(object(), "space", 8, 256, 4, 4)


def test_spatial_dis_validator_messages():
    from cuda_optical_flow_2_tpu.models import dis
    from cuda_optical_flow_2_tpu.parallel.spatial_models import (
        validate_spatial_dis,
    )

    cfg = dis.DISConfig(levels=3, window=9, max_displacement=8)
    with pytest.raises(ValueError, match="divisible"):
        validate_spatial_dis(500, 64, cfg, 8)
    with pytest.raises(ValueError, match="halos"):
        validate_spatial_dis(512, 64, cfg, 8)  # 16 rows/shard at level 2


def test_spatial_prefilter_all_families():
    """Sharded bilateral prefilter (halo exchange + global-coordinate band
    filter) matches unsharded preprocessing for every model family
    (VERDICT r1 item 4: TP no longer rejects prefilter configs)."""
    from cuda_optical_flow_2_tpu.config import BilateralConfig
    from cuda_optical_flow_2_tpu.models import farneback as fb
    from cuda_optical_flow_2_tpu.models import horn_schunck as hs
    from cuda_optical_flow_2_tpu.models import tvl1

    pf = BilateralConfig()
    mesh = parallel.make_mesh(axis_name="space")
    p, n = _smooth_pair(256, 48, dx=2, dy=1)

    # Iteration counts are minimal: the prefilter exchange happens once per
    # pyramid build, so extra solver iterations only grow these six programs'
    # compile time without adding prefilter coverage.
    cfg = of.LKConfig(levels=2, window=9, iterations=1,
                      max_displacement=4.0, prefilter=pf)
    flow = parallel.spatial_pyramidal_lk(p, n, cfg, mesh)
    want = of.pyramidal_lk(p, n, cfg)
    np.testing.assert_allclose(np.asarray(flow), np.asarray(want), atol=1e-4)

    cfg_h = hs.HSConfig(alpha=8.0, iterations=8, levels=2, max_displacement=8, prefilter=pf)
    flow = parallel.spatial_pyramidal_hs(p, n, cfg_h, mesh, sweep_tile=6)
    np.testing.assert_allclose(
        np.asarray(flow), np.asarray(hs.pyramidal_hs(p, n, cfg_h)), atol=5e-4
    )

    cfg_f = fb.FBConfig(levels=2, iterations=1, winsize=11, max_displacement=4, prefilter=pf)
    flow = parallel.spatial_pyramidal_fb(p, n, cfg_f, mesh)
    np.testing.assert_allclose(
        np.asarray(flow), np.asarray(fb.pyramidal_farneback(p, n, cfg_f)),
        atol=2e-2,
    )

    # max_displacement must exceed TV-L1's transient overshoot on this
    # high-contrast texture: the sharded path always enforces the budget
    # (documented semantic difference) while the unsharded warp does not.
    cfg_t = tvl1.TVL1Config(levels=2, warps=1, iterations=8,
                            max_displacement=8,
                            prefilter=pf)
    flow = parallel.spatial_pyramidal_tvl1(p, n, cfg_t, mesh, iter_tile=4)
    np.testing.assert_allclose(
        np.asarray(flow), np.asarray(tvl1.pyramidal_tvl1(p, n, cfg_t)),
        atol=5e-4,
    )


def test_chunked_flow_matches_whole_batch():
    """lax.map chunked batch (the recommended large-batch serving form,
    docs/PERF.md config-5 mechanism) == whole-batch flow."""
    prev, nxt = _smooth_pair(64, 48, dx=2, dy=1)
    pb = jnp.stack([prev + i * 0.5 for i in range(4)])
    nb = jnp.stack([nxt + i * 0.5 for i in range(4)])
    cfg = of.LKConfig(levels=2, window=9, use_pallas=False)
    got = parallel.chunked_flow(pb, nb, cfg, chunk=2)
    want = of.pyramidal_lk(pb, nb, cfg)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=1e-5)
    with np.testing.assert_raises(ValueError):
        parallel.chunked_flow(pb, nb, cfg, chunk=3)


def test_spatial_validators_reject_unsupported_configs():
    """Precise early errors instead of silent divergence / opaque trace
    failures: coeff-formulation FB and median halos taller than a shard."""
    from cuda_optical_flow_2_tpu.models import farneback as fb
    from cuda_optical_flow_2_tpu.models import tvl1
    from cuda_optical_flow_2_tpu.parallel.spatial_models import (
        validate_spatial_fb,
        validate_spatial_tvl1,
    )

    # spatial FB implements only the image-warp formulation
    with pytest.raises(NotImplementedError, match="image-warp"):
        validate_spatial_fb(
            256, 64, fb.FBConfig(levels=2, warp_planes="coeff"), 8
        )
    # a narrow coarsest level (w >> 1 = 6) is fine for the XLA band forms
    validate_spatial_tvl1(
        512, 12, tvl1.TVL1Config(levels=2, max_displacement=2), 8
    )
    # median halo must fit the shard
    with pytest.raises(ValueError, match="median_filtering"):
        validate_spatial_tvl1(
            64, 64,
            tvl1.TVL1Config(levels=2, iterations=1,
                            max_displacement=0, median_filtering=13),
            8, iter_tile=1,
        )


def test_halo_exchange_counts_hoisted():
    """Loop-invariant frame bands are exchanged ONCE per level, not per
    iteration/warp: the collective-permute count of the lowered sharded
    program matches the hoisted formula exactly (one exchange = 2 permutes,
    up + down).  On a real mesh every exchange is an NVLink neighbor
    transfer, so this pins the communication volume per level:
      LK coarsest level: prev + next at the gradient halo, then (if it
                       iterates) next once at the warp halo + 1 flow
                       exchange per further iteration
      FB coarsest level: prev + next once, 1 flow exchange per iteration
                       after the first
      TV-L1 level:     2 frame exchanges + (1 flow exchange +
                       ceil(iterations / iter_tile) sweep-chunk exchanges +
                       1 median-filter exchange if median_filtering is on)
                       per warp
    """
    from cuda_optical_flow_2_tpu.models import tvl1

    mesh = parallel.make_mesh(8, axis_name="space")
    p = jnp.zeros((768, 128), jnp.float32)
    n = jnp.zeros_like(p)

    def permutes(fn):
        return jax.jit(fn).lower(p, n).as_text().count("collective_permute")

    for it in (1, 3):
        cfg = of.LKConfig(
            levels=1, window=9, iterations=it, max_displacement=8.0
        )
        got = permutes(
            lambda a, b, c=cfg: parallel.spatial_pyramidal_lk(a, b, c, mesh)
        )
        assert got == 2 * (2 + (it > 1) + (it - 1)), (it, got)

    for warps in (1, 3):
        for median in (0, 5):
            cfg = tvl1.TVL1Config(
                levels=1, warps=warps, iterations=8, max_displacement=8,
                median_filtering=median,
            )
            got = permutes(
                lambda a, b, c=cfg: parallel.spatial_pyramidal_tvl1(
                    a, b, c, mesh, iter_tile=4
                )
            )
            per_warp = (1 + 2) + (1 if median else 0)
            assert got == 2 * (2 + warps * per_warp), (warps, median, got)

    # FB level: prev expansion band + next band once, flow per iteration
    # after the first (the first starts from zero flow).
    from cuda_optical_flow_2_tpu.models import farneback as fb

    for it in (1, 3):
        cfg = fb.FBConfig(
            levels=1, iterations=it, winsize=11, max_displacement=4
        )
        got = permutes(
            lambda a, b, c=cfg: parallel.spatial_pyramidal_fb(a, b, c, mesh)
        )
        assert got == 2 * (2 + it - 1), (it, got)


def test_parallel_entry_points_cache_their_jit():
    """Every parallel entry point must reuse one traced/compiled program per
    (config, mesh, shape) — a per-frame serving loop would otherwise retrace
    the whole multi-level pipeline on every call (measured ~20s/call on CPU
    for sharded_flow before the cached factories)."""
    from cuda_optical_flow_2_tpu.models import HSConfig
    from cuda_optical_flow_2_tpu.parallel import batching, multihost, spatial
    from cuda_optical_flow_2_tpu.parallel import spatial_models as sm

    mesh = batching.make_mesh(2)
    smesh = batching.make_mesh(2, axis_name="space")
    cfg = of.LKConfig(
        levels=2, window=9, max_displacement=2.0, use_pallas=False
    )
    hs = HSConfig(levels=2, iterations=4, max_displacement=2)

    assert batching._sharded_flow_jit(cfg, mesh, "batch") is (
        batching._sharded_flow_jit(cfg, mesh, "batch")
    )
    assert multihost._global_flow_jit(cfg, mesh, "batch") is (
        multihost._global_flow_jit(cfg, mesh, "batch")
    )
    assert spatial._spatial_lk_jit(cfg, smesh, "space", 2, 32) is (
        spatial._spatial_lk_jit(cfg, smesh, "space", 2, 32)
    )
    assert sm._spatial_hs_jit(hs, smesh, "space", 2, 32, 4) is (
        sm._spatial_hs_jit(hs, smesh, "space", 2, 32, 4)
    )
    # a different config is a different program
    cfg2 = of.LKConfig(
        levels=1, window=9, max_displacement=2.0, use_pallas=False
    )
    assert batching._sharded_flow_jit(cfg2, mesh, "batch") is not (
        batching._sharded_flow_jit(cfg, mesh, "batch")
    )


def test_make_mesh_rejects_overrequest():
    """Requesting more devices than exist must error, not silently truncate
    (the batch-divisibility check would validate against the wrong n)."""
    with pytest.raises(ValueError, match="devices"):
        parallel.make_mesh(n_devices=len(jax.devices()) + 1)


def test_chunked_flow_reuses_jit():
    """chunked_flow caches its jitted program per config
    instead of paying a full eager lax.map retrace every call."""
    from cuda_optical_flow_2_tpu.parallel import batching

    prev, nxt = _smooth_pair(64, 48, dx=2, dy=1)
    pb = jnp.stack([prev, prev])
    nb = jnp.stack([nxt, nxt])
    cfg = of.LKConfig(levels=2, window=9, use_pallas=False)
    batching._chunked_flow_jit.cache_clear()
    parallel.chunked_flow(pb, nb, cfg, chunk=1)
    info1 = batching._chunked_flow_jit.cache_info()
    parallel.chunked_flow(pb, nb, cfg, chunk=1)
    info2 = batching._chunked_flow_jit.cache_info()
    assert info2.hits == info1.hits + 1 and info2.currsize == info1.currsize

def test_spatial_fb_gaussian_window_matches_unsharded():
    """gaussian_window=True under TP (round 3): the separable Gaussian
    window is band-local with the same r_win halo as the box window, so the
    sharded path reuses the unsharded window dispatch verbatim."""
    from cuda_optical_flow_2_tpu.models import farneback as fb

    p, n = _smooth_pair(512, 64, dx=2, dy=1)
    cfg = fb.FBConfig(levels=3, iterations=2, winsize=11, gaussian_window=True, max_displacement=4)
    mesh = parallel.make_mesh(axis_name="space")
    flow = parallel.spatial_pyramidal_fb(p, n, cfg, mesh)
    assert flow.shape == (512, 64, 2)
    assert len(flow.sharding.device_set) == 8
    want = fb.pyramidal_farneback(p, n, cfg)
    np.testing.assert_allclose(
        np.asarray(flow), np.asarray(want), atol=2e-2
    )
    inner = np.asarray(flow)[32:-32, 16:-16]
    med = np.median(inner, axis=(0, 1))
    assert abs(med[0] - 2) < 0.1 and abs(med[1] - 1) < 0.1, med
