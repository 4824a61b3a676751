"""Sparse point tracking over dense flow (models/tracking.py)."""

import numpy as np
import pytest

import jax.numpy as jnp

import cuda_optical_flow_2_tpu as of
from cuda_optical_flow_2_tpu.models import (
    FBConfig,
    advect_points,
    sample_flow,
    track_points,
    track_sequence,
)
from cuda_optical_flow_2_tpu.utils import io


CFG = of.LKConfig(levels=3, window=11, temporal_kernel="gauss3", iterations=2,
                  use_pallas=False)


def test_sample_flow_bilinear_exact():
    """Sampling a linear-in-(x, y) field is exact at sub-pixel positions."""
    h, w = 16, 24
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    flow = jnp.asarray(np.stack([0.5 * xs, 2.0 + 0.25 * ys], -1))
    pts = jnp.asarray([[3.5, 2.25], [0.0, 0.0], [w - 1.0, h - 1.0]],
                      dtype=jnp.float32)
    got = np.asarray(sample_flow(flow, pts))
    want = np.stack([0.5 * np.asarray([3.5, 0.0, w - 1.0]),
                     2.0 + 0.25 * np.asarray([2.25, 0.0, h - 1.0])], -1)
    np.testing.assert_allclose(got, want, rtol=1e-6)
    # out-of-rectangle sample positions clamp to the border value
    out = np.asarray(sample_flow(flow, jnp.asarray([[-5.0, 900.0]])))
    np.testing.assert_allclose(out[0], [0.0, 2.0 + 0.25 * (h - 1)], rtol=1e-6)


def test_tracks_follow_translation():
    """On a constant-velocity sequence every point advances by ~v per frame
    and the jitted scan == the generator form."""
    v = (2.0, 1.0)
    frames = io.synthetic_sequence(6, 96, 128, velocity=v, noise=0.0)
    stack = jnp.asarray(np.stack(frames).astype(np.float32))
    pts0 = np.asarray(
        [[40.0, 40.0], [64.0, 30.0], [90.0, 60.0]], np.float32
    )
    pos, alive = track_sequence(stack, pts0, CFG, warm_start=True)
    assert pos.shape == (5, 3, 2) and alive.shape == (5, 3)
    assert bool(np.asarray(alive).all())
    pos = np.asarray(pos)
    for t in range(5):
        want = pts0 + (t + 1) * np.asarray(v, np.float32)
        np.testing.assert_allclose(pos[t], want, atol=0.35)

    gen = list(track_points(iter(frames), pts0, CFG, warm_start=True))
    assert [i for i, _, _ in gen] == [1, 2, 3, 4, 5]
    for t, (_, gp, ga) in enumerate(gen):
        np.testing.assert_allclose(np.asarray(gp), pos[t], atol=1e-5)
        assert bool(np.asarray(ga).all())


def test_point_dies_at_border_and_freezes():
    """A point advected out of the image goes dead on the exit step (clamped
    to the border) and stays frozen afterward."""
    v = (4.0, 0.0)
    frames = io.synthetic_sequence(6, 64, 96, velocity=v, noise=0.0)
    stack = jnp.asarray(np.stack(frames).astype(np.float32))
    pts0 = np.asarray([[93.0, 32.0], [40.0, 32.0]], np.float32)
    pos, alive = track_sequence(stack, pts0, CFG, warm_start=True)
    pos, alive = np.asarray(pos), np.asarray(alive)
    assert not alive[-1, 0], "border point should die"
    assert alive[:, 1].all(), "interior point should live"
    t_dead = int(np.argmin(alive[:, 0]))  # first dead step
    # frozen from the step after death onward
    for t in range(t_dead + 1, pos.shape[0]):
        np.testing.assert_array_equal(pos[t, 0], pos[t_dead, 0])
    assert pos[t_dead, 0, 0] <= 95.0


def test_tracking_model_generic():
    """track_sequence accepts the extension families (config dispatch)."""
    frames = io.synthetic_sequence(3, 64, 96, velocity=(1.5, -1.0), noise=0.0)
    stack = jnp.asarray(np.stack(frames).astype(np.float32))
    pts0 = np.asarray([[48.0, 32.0]], np.float32)
    cfg = FBConfig(levels=2, iterations=1)
    pos, alive = track_sequence(stack, pts0, cfg, warm_start=False)
    np.testing.assert_allclose(
        np.asarray(pos)[-1, 0], pts0[0] + 2 * np.asarray([1.5, -1.0]),
        atol=0.5,
    )


def test_tracking_survives_decode_failure():
    """A None frame (decode failure) pairs across the gap: the trajectory
    stays continuous and covers the full motion."""
    v = (2.0, 1.0)
    frames = list(io.synthetic_sequence(5, 96, 128, velocity=v, noise=0.0))
    seq = frames[:2] + [None] + frames[3:]  # lose frame 2
    pts0 = np.asarray([[50.0, 40.0]], np.float32)
    out = list(track_points(seq, pts0, CFG, warm_start=True))
    assert [i for i, _, _ in out] == [1, 3, 4]
    final = np.asarray(out[-1][1])[0]
    np.testing.assert_allclose(
        final, pts0[0] + 4 * np.asarray(v, np.float32), atol=0.5
    )


def test_track_points_validates_shape():
    with pytest.raises(ValueError, match="points"):
        list(track_points([np.zeros((32, 32))] * 2,
                          np.zeros((3,), np.float32), CFG))


def test_draw_tracks_overlay():
    """draw_tracks renders trails/dots in-bounds and skips dead points."""
    from cuda_optical_flow_2_tpu.utils.viz import draw_tracks

    img = np.full((32, 40), 128, np.uint8)
    hist = [
        np.asarray([[5.0, 5.0], [30.0, 20.0]], np.float32),
        np.asarray([[10.0, 10.0], [35.0, 25.0]], np.float32),
    ]
    out = draw_tracks(img, hist, alive=np.asarray([True, False]))
    assert out.shape == (32, 40, 3)
    # live point: green trail pixel somewhere on the segment + yellow dot
    assert tuple(out[7, 7]) == (0, 255, 0)
    assert tuple(out[10, 10]) == (255, 255, 0)
    # dead point: untouched along its would-be trail
    assert tuple(out[22, 32]) == (128, 128, 128)
    # empty history is the identity canvas
    np.testing.assert_array_equal(
        draw_tracks(img, [])[..., 0], img
    )


def test_flow_to_color_device_matches_numpy():
    """The device colorizer (arithmetic wheel, no gather) matches the NumPy
    reference within one intensity level, incl. non-finite handling and both
    normalization modes."""
    from cuda_optical_flow_2_tpu.utils.viz import (
        flow_to_color,
        flow_to_color_device,
    )

    rng = np.random.default_rng(0)
    flow = rng.normal(0, 3, (48, 64, 2)).astype(np.float32)
    flow[5, 5] = (np.nan, 1.0)
    flow[10, 10] = (np.inf, -2.0)
    for mf in (None, 4.0):
        a = flow_to_color(flow, max_flow=mf).astype(int)
        b = np.asarray(flow_to_color_device(flow, max_flow=mf)).astype(int)
        assert np.abs(a - b).max() <= 1
    with pytest.raises(ValueError, match="max_flow"):
        flow_to_color_device(flow, max_flow=-1.0)
