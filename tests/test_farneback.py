"""Farnebäck model family (extension): polynomial expansion + displacement."""

import numpy as np
import pytest

import jax.numpy as jnp

from cuda_optical_flow_2_tpu.models import farneback as fb
from cuda_optical_flow_2_tpu.ops import poly_exp
from cuda_optical_flow_2_tpu.utils import io


def _pair(h, w, vx, vy, n_frames=2):
    fr = io.synthetic_sequence(n_frames, h, w, velocity=(vx, vy), period=24)
    return (
        jnp.asarray(fr[0].astype(np.float32)),
        jnp.asarray(fr[1].astype(np.float32)),
    )


def _poly_exp_oracle(f: np.ndarray, n: int, sigma: float):
    """Direct per-pixel weighted least squares on the zero-padded image."""
    g = poly_exp.gaussian_1d(n, sigma)
    r = n // 2
    o = np.arange(n) - r
    yy, xx = np.meshgrid(o, o, indexing="ij")
    w = np.outer(g, g)
    basis = np.stack(
        [np.ones_like(xx), xx, yy, xx * xx, yy * yy, xx * yy], axis=-1
    ).astype(np.float64)
    G = np.einsum("yx,yxk,yxl->kl", w, basis, basis)
    Ginv = np.linalg.inv(G)
    h_, w_ = f.shape
    fp = np.zeros((h_ + 2 * r, w_ + 2 * r), np.float64)
    fp[r : r + h_, r : r + w_] = f
    out = np.zeros((h_, w_, 5), np.float64)
    for i in range(h_):
        for j in range(w_):
            patch = fp[i : i + n, j : j + n]
            v = np.einsum("yx,yxk->k", w * patch, basis)
            rcoef = Ginv @ v
            out[i, j] = [rcoef[1], rcoef[2], rcoef[3], rcoef[4], rcoef[5] / 2]
    return out


def test_poly_expansion_matches_direct_lsq(rng):
    f = rng.integers(0, 256, (20, 24)).astype(np.float32)
    want = _poly_exp_oracle(f, 5, 1.1)
    got = np.stack(
        [np.asarray(p) for p in poly_exp.poly_expansion(jnp.asarray(f), 5, 1.1)],
        axis=-1,
    )
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_poly_expansion_recovers_exact_quadratic():
    """On an exact quadratic surface the interior fit is the surface itself."""
    h, w = 32, 40
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float64)
    f = 0.03 * xs * xs + 0.02 * ys * ys - 0.04 * xs * ys + 1.5 * xs - 0.7 * ys
    bx, by, axx, ayy, axy = (
        np.asarray(p) for p in poly_exp.poly_expansion(jnp.asarray(f), 7, 1.5)
    )
    # Interior pixel (away from the zero-pad boundary): the local expansion
    # of a global quadratic q(X + o) has A = global A,
    # b = grad q(X) = (2*0.03*X - 0.04*Y + 1.5, 2*0.02*Y - 0.04*X - 0.7).
    i, j = 16, 20
    assert abs(axx[i, j] - 0.03) < 1e-3
    assert abs(ayy[i, j] - 0.02) < 1e-3
    assert abs(axy[i, j] - (-0.02)) < 1e-3
    assert abs(bx[i, j] - (0.06 * j - 0.04 * i + 1.5)) < 1e-2
    assert abs(by[i, j] - (0.04 * i - 0.04 * j - 0.7)) < 1e-2


def test_single_level_recovers_subpixel_translation():
    p, n = _pair(96, 128, 0.7, 0.4)
    cfg = fb.FBConfig(levels=1, iterations=3, winsize=15)
    flow = np.asarray(fb.pyramidal_farneback(p, n, cfg))
    inner = flow[16:-16, 16:-16]
    assert abs(np.median(inner[..., 0]) - 0.7) < 0.1
    assert abs(np.median(inner[..., 1]) - 0.4) < 0.1


def test_pyramidal_recovers_large_translation():
    p, n = _pair(128, 160, 5.0, 3.0)
    cfg = fb.FBConfig(levels=3, iterations=3, winsize=15)
    flow = np.asarray(fb.pyramidal_farneback_jit(p, n, cfg))
    inner = flow[24:-24, 24:-24]
    epe = np.hypot(inner[..., 0] - 5.0, inner[..., 1] - 3.0)
    assert epe.mean() < 0.35, epe.mean()


def test_gaussian_window_and_poly5():
    p, n = _pair(96, 128, 1.5, -1.0)
    cfg = fb.FBConfig(
        levels=2, iterations=2, poly_n=5, poly_sigma=1.1,
        winsize=13, gaussian_window=True,
    )
    flow = np.asarray(fb.pyramidal_farneback(p, n, cfg))
    inner = flow[20:-20, 20:-20]
    assert abs(np.median(inner[..., 0]) - 1.5) < 0.15
    assert abs(np.median(inner[..., 1]) + 1.0) < 0.15


def test_batched_and_validation():
    p, n = _pair(64, 64, 1.0, 0.0)
    cfg = fb.FBConfig(levels=2, iterations=2)
    flow = fb.pyramidal_farneback(jnp.stack([p, p]), jnp.stack([n, n]), cfg)
    assert flow.shape == (2, 64, 64, 2)
    np.testing.assert_allclose(
        np.asarray(flow[0]), np.asarray(flow[1]), atol=1e-6
    )
    with pytest.raises(ValueError):
        fb.FBConfig(poly_n=4)
    with pytest.raises(ValueError):
        fb.FBConfig(winsize=10)
    with pytest.raises(ValueError):
        fb.FBConfig(poly_sigma=0.0)


def test_fb_image_formulation_matches_accuracy():
    """warp_planes='image' and 'coeff' agree to sub-pixel on translation."""
    p, n = _pair(64, 96, 2.0, 1.0)
    fi = np.asarray(fb.pyramidal_farneback(
        p, n, fb.FBConfig(levels=2, iterations=2, warp_planes="image")))
    fc = np.asarray(fb.pyramidal_farneback(
        p, n, fb.FBConfig(levels=2, iterations=2, warp_planes="coeff")))
    c = (slice(20, -20), slice(20, -20))
    assert np.abs(fi[c] - fc[c]).mean() < 0.05

