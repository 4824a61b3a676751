"""End-to-end differentiability of the XLA pipelines.

A capability the CUDA reference cannot offer: every model family is a pure
jittable function, so jax.grad flows through the whole coarse-to-fine
pipeline (the XLA path; the fused GPU kernel carries no AD rule).  This makes the flow usable as a differentiable module
(e.g. self-supervised photometric training, or tuning the prefilter by
gradient descent)."""

import numpy as np

import jax
import jax.numpy as jnp

import cuda_optical_flow_2_tpu as of
from cuda_optical_flow_2_tpu.utils import io


def _pair():
    frames = io.synthetic_sequence(2, 48, 64, velocity=(1.0, 0.5), noise=0.0)
    return (jnp.asarray(frames[0], jnp.float32),
            jnp.asarray(frames[1], jnp.float32))


def test_all_families_differentiable():
    from cuda_optical_flow_2_tpu.models import farneback as fb
    from cuda_optical_flow_2_tpu.models import horn_schunck as hs
    from cuda_optical_flow_2_tpu.models import pyramidal_flow
    from cuda_optical_flow_2_tpu.models import tvl1

    p, n = _pair()
    for cfg in (
        of.LKConfig(levels=2, window=9, iterations=2, use_pallas=False),
        hs.HSConfig(levels=2, iterations=10),
        fb.FBConfig(levels=2, iterations=2),
        tvl1.TVL1Config(levels=2, warps=1, iterations=5),
    ):
        g = jax.grad(
            lambda x, c=cfg: jnp.mean(pyramidal_flow(p, x, c)[..., 0])
        )(n)
        ga = np.asarray(g)
        assert np.isfinite(ga).all(), type(cfg)
        assert np.abs(ga).max() > 0, type(cfg)


def test_lk_gradient_matches_finite_differences(rng):
    """jax.grad through the full pyramidal LK == central differences."""
    p, n = _pair()
    cfg = of.LKConfig(levels=2, window=9, iterations=1, use_pallas=False)

    def loss(nxt):
        f = of.pyramidal_lk(p, nxt, cfg)
        return jnp.sum(f[10:-10, 10:-10, 0] ** 2)

    g = np.asarray(jax.grad(loss)(n))
    loss_j = jax.jit(loss)
    eps = 0.05
    for _ in range(4):
        y, x = int(rng.integers(8, 40)), int(rng.integers(8, 56))
        e = jnp.zeros_like(n).at[y, x].set(eps)
        fd = (float(loss_j(n + e)) - float(loss_j(n - e))) / (2 * eps)
        np.testing.assert_allclose(g[y, x], fd, rtol=0.05, atol=5e-4)
