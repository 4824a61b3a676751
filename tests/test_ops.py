"""Unit tests for the pure-JAX op library against NumPy brute force / oracle."""

import numpy as np
import pytest

import jax.numpy as jnp

from cuda_optical_flow_2_tpu import ops
from cuda_optical_flow_2_tpu.constants import DX_3X3, GAUS_KERNEL_3X3
from cuda_optical_flow_2_tpu.oracle import cpu_reference as cpu_oracle


def naive_conv2d(x, mask):
    h, w = x.shape
    mh, mw = mask.shape
    out = np.zeros_like(x, dtype=np.float64)
    for y in range(h):
        for xx in range(w):
            acc = 0.0
            for i in range(mh):
                for j in range(mw):
                    ty, tx = y - mh // 2 + i, xx - mw // 2 + j
                    if 0 <= ty < h and 0 <= tx < w:
                        acc += float(x[ty, tx]) * float(mask[i, j])
            out[y, xx] = acc
    return out


@pytest.fixture
def img(rng):
    return rng.normal(0, 1, (13, 17)).astype(np.float32)


def test_conv2d_matches_naive(img):
    got = np.asarray(ops.conv2d(jnp.asarray(img), DX_3X3))
    want = naive_conv2d(img, DX_3X3)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_stencil2d_matches_conv2d(img, rng):
    """Shift-form correlation (layout-safe twin, PERF finding 2) == conv2d,
    including even mask sides (asymmetric pad) and batched inputs."""
    for mask in (DX_3X3, GAUS_KERNEL_3X3, rng.normal(0, 1, (2, 4)).astype(np.float32)):
        got = np.asarray(ops.stencil2d(jnp.asarray(img), mask))
        want = np.asarray(ops.conv2d(jnp.asarray(img), mask))
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    batch = np.stack([img, img * -3.0])
    got = np.asarray(ops.stencil2d(jnp.asarray(batch), DX_3X3))
    want = np.asarray(ops.conv2d(jnp.asarray(batch), DX_3X3))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_conv2d_batched(img):
    batch = np.stack([img, img * 2.0])
    got = np.asarray(ops.conv2d(jnp.asarray(batch), GAUS_KERNEL_3X3))
    single = np.asarray(ops.conv2d(jnp.asarray(img), GAUS_KERNEL_3X3))
    np.testing.assert_allclose(got[0], single, rtol=1e-6)
    np.testing.assert_allclose(got[1], 2.0 * single, rtol=1e-6)


def test_sep_conv_equals_dense(img):
    k1 = np.array([0.25, 0.5, 0.25], np.float32)
    dense = np.outer(k1, k1)
    got = np.asarray(ops.sep_conv2d(jnp.asarray(img), k1, k1))
    want = np.asarray(ops.conv2d(jnp.asarray(img), dense))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("method", ["sep_conv", "cumsum", "reduce_window"])
@pytest.mark.parametrize("window", [3, 9])
def test_window_sum_methods_match_naive(rng, method, window):
    x = rng.normal(0, 1, (14, 18)).astype(np.float32)
    got = np.asarray(ops.window_sum(jnp.asarray(x), window, method))
    want = naive_conv2d(x, np.ones((window, window)))
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=1e-4)


@pytest.mark.parametrize("weights", ["tri", "gauss"])
@pytest.mark.parametrize("window", [9, 19])
def test_window_sum_weighted_matches_naive(rng, weights, window):
    x = rng.normal(0, 1, (24, 28)).astype(np.float32)
    taps = ops.window_weight_taps(window, weights)
    got = np.asarray(ops.window_sum(jnp.asarray(x), window, weights=weights))
    want = naive_conv2d(x, np.outer(taps, taps))
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=1e-4)


@pytest.mark.parametrize("window", [9, 19, 31])
def test_window_weight_taps_scale_and_transfer(window):
    """Each axis's taps sum to ``window`` (total 2-D weight = window**2,
    the box scale), and the non-box weightings have no significant negative
    transfer sidelobes — the property that makes the iterative LK update
    monotone-stable (LKConfig.window_weights docstring; the box window's
    transfer dips below -0.2)."""
    for weights in ("box", "tri", "gauss"):
        taps = ops.window_weight_taps(window, weights)
        assert taps.shape == (window,)
        np.testing.assert_allclose(taps.sum(), window, rtol=1e-6)
        n = 512
        k = taps / taps.sum()
        tf = np.fft.rfft(np.pad(k, (0, n - window)))
        tf = (tf * np.exp(1j * 2 * np.pi * np.fft.rfftfreq(n) * (window - 1) / 2)).real
        if weights == "box":
            assert tf.min() < -0.15
        else:
            assert tf.min() > -0.03


def test_window_sum_cumsum_exact_int(rng):
    x = rng.integers(0, 255, (12, 16)).astype(np.int32)
    got = np.asarray(ops.window_sum(jnp.asarray(x), 9, "cumsum"))
    want = naive_conv2d(x, np.ones((9, 9))).astype(np.int64)
    assert np.array_equal(got.astype(np.int64), want)


def test_pyr_down_matches_oracle_float(rng):
    """pyr_down == reference downscale grid/padding, minus the uchar trunc."""
    src = rng.integers(0, 256, (16, 20, 3), dtype=np.uint8)
    # float version of the oracle: same taps, no truncation
    got = np.asarray(ops.pyr_down(jnp.asarray(src[..., 0].astype(np.float32))))
    sh, sw = src.shape[:2]
    h, w = sh >> 1, sw >> 1
    want = np.zeros((h, w), np.float64)
    for y in range(h):
        for x in range(w):
            acc = 0.0
            for p in range(3):
                for q in range(3):
                    cy, cx = 2 * y - 1 + p, 2 * x - 1 + q
                    if 0 <= cy < 2 * h and 0 <= cx < 2 * w:
                        acc += float(GAUS_KERNEL_3X3[p, q]) * float(src[cy, cx, 0])
            want[y, x] = acc
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


def test_build_pyramid_shapes(rng):
    x = jnp.asarray(rng.normal(0, 1, (2, 61, 47)).astype(np.float32))
    pyr = ops.build_pyramid(x, 3)
    assert [p.shape for p in pyr] == [(2, 61, 47), (2, 30, 23), (2, 15, 11)]


def test_solve_2x2_inverts_known_system():
    a = jnp.full((4, 4), 5.0)
    d = jnp.full((4, 4), 3.0)
    b = jnp.full((4, 4), 1.0)
    # pick bx, by so that the solution is (u, v) = (2, -1)
    # A @ [2, -1] = [5*2 + 1*(-1), 1*2 + 3*(-1)] = [9, -1] = -[bx, by]
    bx = jnp.full((4, 4), -9.0)
    by = jnp.full((4, 4), 1.0)
    flow = np.asarray(ops.solve_2x2(a, d, b, bx, by))
    np.testing.assert_allclose(flow[..., 0], 2.0, rtol=1e-6)
    np.testing.assert_allclose(flow[..., 1], -1.0, rtol=1e-6)


def test_solve_2x2_guard_zeroes_singular():
    z = jnp.zeros((3, 3))
    flow = np.asarray(ops.solve_2x2(z, z, z, z + 1.0, z + 1.0))
    assert np.all(flow == 0.0)
    unguarded = np.asarray(ops.solve_2x2_unguarded(z, z, z, z + 1.0, z + 1.0))
    assert not np.isfinite(unguarded).all()


def test_warp_bilinear_integer_shift(rng):
    img = rng.normal(0, 1, (10, 12)).astype(np.float32)
    flow = np.zeros((10, 12, 2), np.float32)
    flow[..., 0] = 2.0  # sample at x+2
    got = np.asarray(ops.warp_bilinear(jnp.asarray(img), jnp.asarray(flow)))
    np.testing.assert_allclose(got[:, :-2], img[:, 2:], rtol=1e-6)
    np.testing.assert_allclose(got[:, -2:], img[:, -2:], rtol=1e-6)  # oob keeps


def test_warp_bilinear_fractional_shift():
    img = np.arange(20, dtype=np.float32).reshape(4, 5)
    flow = np.full((4, 5, 2), 0.0, np.float32)
    flow[..., 0] = 0.5
    got = np.asarray(ops.warp_bilinear(jnp.asarray(img), jnp.asarray(flow)))
    want = 0.5 * (img[:, :-1] + img[:, 1:])
    np.testing.assert_allclose(got[:, :-1], want, rtol=1e-6)


def test_warp_nearest_trunc_semantics():
    img = np.arange(16, dtype=np.float32).reshape(4, 4)
    flow = np.full((4, 4, 2), 0.0, np.float32)
    flow[..., 0] = 1.7  # C trunc -> shift by +1
    got = np.asarray(ops.warp_nearest(jnp.asarray(img), jnp.asarray(flow)))
    np.testing.assert_allclose(got[:, :2], img[:, 1:3], rtol=1e-6)


def test_upsample_flow_doubles_and_scales():
    flow = np.zeros((4, 6, 2), np.float32)
    flow[..., 0] = 1.0
    flow[..., 1] = -2.0
    up = np.asarray(ops.upsample_flow(jnp.asarray(flow), (8, 12)))
    assert up.shape == (8, 12, 2)
    np.testing.assert_allclose(up[..., 0], 2.0, rtol=1e-6)
    np.testing.assert_allclose(up[..., 1], -4.0, rtol=1e-6)


def test_upscale_nn_matches_oracle(rng):
    img = rng.integers(0, 256, (4, 5), dtype=np.uint8)
    got = np.asarray(ops.upscale_nn(jnp.asarray(img), 2))
    assert got.shape == (16, 20)
    assert np.array_equal(got[::4, ::4], img)
    assert np.array_equal(got[3::4, 3::4], img)


def test_grayscale_u8_exact(rng):
    img = rng.integers(0, 256, (6, 7, 3), dtype=np.uint8)
    got = np.asarray(ops.grayscale_u8(jnp.asarray(img)))
    want = cpu_oracle.grayscale_avg(img)[..., 0]
    assert np.array_equal(got, want)


def test_bilateral_matches_oracle_float(rng):
    img = rng.integers(0, 256, (12, 14, 3), dtype=np.uint8)
    got = np.asarray(
        ops.bilateral_filter(jnp.asarray(img[..., 0].astype(np.float32)), None, 9, 2.0, 10.0)
    )
    want = cpu_oracle.bilateral_filter_3ch(img, img, 9, 9, 2.0, 10.0)
    # oracle output is truncated to uchar; compare within 1 intensity step
    assert np.max(np.abs(got - want[..., 0].astype(np.float32))) <= 1.0


def test_flo_roundtrip(tmp_path, rng):
    from cuda_optical_flow_2_tpu.utils import io

    flow = rng.normal(0, 3, (17, 23, 2)).astype(np.float32)
    p = str(tmp_path / "f.flo")
    io.write_flo(p, flow)
    back = io.read_flo(p)
    np.testing.assert_array_equal(back, flow)
    import pytest

    with pytest.raises(ValueError):
        io.write_flo(p, flow[..., :1])


def _banded_pyr_down(x: np.ndarray, k: np.ndarray) -> np.ndarray:
    """Blur + 2x subsample as banded matrix products, D_h @ x @ D_w^T with
    D[i, 2i + j - r] = k[j] (zero-clipped at the border): the form the
    strided stencil replaced."""
    r = k.size // 2

    def band(n_out):
        d = np.zeros((n_out, 2 * n_out))
        for j, c in enumerate(k):
            for i in range(n_out):
                if 0 <= 2 * i + j - r < 2 * n_out:
                    d[i, 2 * i + j - r] = c
        return d

    oh, ow = x.shape[-2] // 2, x.shape[-1] // 2
    xb = x[..., : 2 * oh, : 2 * ow].astype(np.float64)
    return np.einsum("hi,...iw,jw->...hj", band(oh), xb, band(ow))


@pytest.mark.parametrize("shape", [(64, 128), (61, 201), (2, 33, 47)])
def test_pyr_down_matches_banded_matmul(rng, shape):
    from cuda_optical_flow_2_tpu.constants import BINOMIAL_1D

    x = rng.normal(0, 50, shape).astype(np.float32)
    got = np.asarray(ops.pyr_down(jnp.asarray(x)))
    want = _banded_pyr_down(x, np.asarray(BINOMIAL_1D, np.float64))
    np.testing.assert_allclose(got, want, atol=1e-4)


def _precisions(jaxpr, found):
    """(primitive, precision) of every conv/dot in a jaxpr, recursively."""
    from jax.extend import core

    for eqn in jaxpr.eqns:
        if eqn.primitive.name in ("conv_general_dilated", "dot_general"):
            found.append((eqn.primitive.name, eqn.params["precision"]))
        for v in eqn.params.values():
            for sub in v if isinstance(v, (tuple, list)) else (v,):
                if isinstance(sub, core.ClosedJaxpr):
                    _precisions(sub.jaxpr, found)
                elif isinstance(sub, core.Jaxpr):
                    _precisions(sub, found)
    return found


@pytest.mark.parametrize("name", ["PAPER_1080P", "REFERENCE_GPU"])
def test_lk_path_convs_run_at_highest_precision(name):
    """On the GPU a float32 conv or dot may run in TF32 unless asked for
    HIGHEST; every one on the LK path (pyramid, prefilter, gradients,
    window sums, warp, upsample) pins it."""
    import jax
    from jax import lax

    import cuda_optical_flow_2_tpu as of

    cfg = getattr(of, name)
    x = jnp.zeros((96, 128), jnp.float32)
    jaxpr = jax.make_jaxpr(lambda a, b: of.pyramidal_lk(a, b, cfg))(x, x)
    found = _precisions(jaxpr.jaxpr, [])
    assert found, "no conv/dot on the path"
    hi = lax.Precision.HIGHEST
    for prim, prec in found:
        assert prec in (hi, (hi, hi)), (prim, prec)
