"""Native ingestion runtime (ctypes) vs oracle/NumPy fallbacks."""

import numpy as np
import pytest

from cuda_optical_flow_2_tpu.oracle import cpu_reference as cpu
from cuda_optical_flow_2_tpu.utils import io as uio
from cuda_optical_flow_2_tpu.utils import native


@pytest.fixture
def native_lib():
    """The built native library (built at first use, under the build lock)."""
    if not native.available():
        pytest.skip("native toolchain missing")


needs_native = pytest.mark.usefixtures("native_lib")


@needs_native
def test_gray_u8_matches_oracle(rng):
    rgb = rng.integers(0, 256, (37, 53, 3), dtype=np.uint8)
    assert np.array_equal(native.gray_u8(rgb), cpu.grayscale_avg(rgb)[..., 0])


@needs_native
def test_gray_f32_matches_mean(rng):
    rgb = rng.integers(0, 256, (37, 53, 3), dtype=np.uint8)
    want = rgb.astype(np.float32).mean(-1)
    np.testing.assert_allclose(native.gray_f32(rgb), want, atol=5e-5)


@needs_native
def test_synthetic_matches_python():
    want = uio.synthetic_sequence(4, 48, 64, velocity=(2.0, 1.0), noise=0)[3]
    got = native.synthetic_frame(3, 48, 64, 2.0, 1.0)
    assert np.array_equal(got, want)


def test_fallbacks_without_native(rng, monkeypatch):
    monkeypatch.setattr(native, "_try_load", lambda: None)
    rgb = rng.integers(0, 256, (16, 16, 3), dtype=np.uint8)
    assert np.array_equal(native.gray_u8(rgb), cpu.grayscale_avg(rgb)[..., 0])
    np.testing.assert_allclose(
        native.gray_f32(rgb), rgb.astype(np.float32).mean(-1), atol=5e-5
    )
    want = uio.synthetic_sequence(2, 24, 32, velocity=(1.0, 0.0), noise=0)[1]
    assert np.array_equal(native.synthetic_frame(1, 24, 32, 1.0, 0.0), want)


def test_frame_stream_synthetic_matches_direct():
    from cuda_optical_flow_2_tpu.utils import io
    from cuda_optical_flow_2_tpu.utils.native import FrameStream

    frames = io.synthetic_sequence(5, 24, 32, velocity=(2.0, 1.0), noise=0.0)
    got = []
    with FrameStream.synthetic(5, 24, 32, vx=2.0, vy=1.0) as src:
        for t, frame in src:
            assert frame.shape == (24, 32) and frame.dtype == np.float32
            got.append((t, frame))
    assert [t for t, _ in got] == [0, 1, 2, 3, 4]
    for t, frame in got:
        np.testing.assert_allclose(frame, frames[t].astype(np.float32))


def test_frame_stream_ppm(tmp_path):
    from cuda_optical_flow_2_tpu.utils import io
    from cuda_optical_flow_2_tpu.utils.native import FrameStream, gray_f32

    rng = np.random.default_rng(3)
    paths = []
    imgs = []
    for t in range(3):
        img = rng.integers(0, 256, (16, 20, 3), dtype=np.uint8)
        path = str(tmp_path / f"f{t}.ppm")
        io.write_ppm(path, img)
        paths.append(path)
        imgs.append(img)
    with FrameStream.from_ppm(paths, prefetch=2) as src:
        assert (src.h, src.w, src.nframes) == (16, 20, 3)
        for t, frame in src:
            np.testing.assert_allclose(frame, gray_f32(imgs[t]), atol=1e-5)


def test_frame_stream_early_close():
    from cuda_optical_flow_2_tpu.utils.native import FrameStream

    src = FrameStream.synthetic(100, 64, 64, vx=1.0, vy=0.0, prefetch=2)
    next(src)
    src.close()  # must not deadlock or leak the worker


def test_frame_stream_python_fallback(monkeypatch):
    """FrameStream must yield identical frames with the native lib disabled."""
    from cuda_optical_flow_2_tpu.utils import native as nat

    with nat.FrameStream.synthetic(3, 24, 32, vx=2.0, vy=1.0) as src:
        native_frames = [f for _, f in src]
    monkeypatch.setattr(nat, "_lib", None)
    monkeypatch.setattr(nat, "_load_attempted", True)
    with nat.FrameStream.synthetic(3, 24, 32, vx=2.0, vy=1.0) as src:
        fallback_frames = [f for _, f in src]
    assert len(fallback_frames) == 3
    for a, b in zip(native_frames, fallback_frames):
        np.testing.assert_allclose(a, b)


# ---------------------------------------------------------------------------
# PPM header parser hardening (VERDICT r1 item 8)
# ---------------------------------------------------------------------------


def _probe(path):
    """Call the native of2_ppm_probe directly; returns (rc, h, w, ch)."""
    import ctypes

    lib = native._try_load()
    h = ctypes.c_int()
    w = ctypes.c_int()
    ch = ctypes.c_int()
    rc = lib.of2_ppm_probe(
        str(path).encode(), ctypes.byref(h), ctypes.byref(w), ctypes.byref(ch)
    )
    return rc, h.value, w.value, ch.value


@needs_native
def test_ppm_header_with_comments(tmp_path, rng):
    """Netpbm comments ('#' to end of line) are legal anywhere between header
    tokens; the old fscanf parse silently rejected them."""
    img = rng.integers(0, 256, (7, 5), dtype=np.uint8)
    p = tmp_path / "c.pgm"
    p.write_bytes(
        b"P5 # magic comment\n# a full comment line\n 5 # width\n\t7\n# more\n255\n"
        + img.tobytes()
    )
    rc, h, w, ch = _probe(p)
    assert (rc, h, w, ch) == (0, 7, 5, 1)
    from cuda_optical_flow_2_tpu.utils.native import FrameStream

    with FrameStream.from_ppm([str(p)]) as src:
        t, frame = next(src)
    assert t == 0
    np.testing.assert_allclose(frame, img.astype(np.float32))


@needs_native
def test_ppm_probe_error_codes(tmp_path, rng):
    """Distinct error codes: -1 open, -2 malformed, -3 magic, -4 maxval."""
    img = rng.integers(0, 256, (4, 6, 3), dtype=np.uint8)
    cases = {
        "missing.ppm": (None, -1),
        "trunc.ppm": (b"P6 6 4", -2),
        "nonnum.ppm": (b"P6 six 4 255\n", -2),
        "zerodim.ppm": (b"P6 0 4 255\n", -2),
        "ascii.ppm": (b"P3\n6 4\n255\n0 0 0\n", -3),
        "notpnm.ppm": (b"BM whatever", -3),
        "deep.ppm": (b"P6 6 4 65535\n" + img.tobytes() * 2, -4),
    }
    for name, (body, want_rc) in cases.items():
        p = tmp_path / name
        if body is not None:
            p.write_bytes(body)
        rc, *_ = _probe(p)
        assert rc == want_rc, f"{name}: rc={rc}, want {want_rc}"


@needs_native
def test_ppm_read_short_payload(tmp_path, rng):
    import ctypes

    lib = native._try_load()
    p = tmp_path / "short.ppm"
    p.write_bytes(b"P5\n8 8\n255\n" + b"\x00" * 10)  # needs 64 bytes
    buf = np.empty(64, np.uint8)
    rc = lib.of2_ppm_read(
        str(p).encode(), buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), 64
    )
    assert rc == -5


@needs_native
def test_ppm_probe_fuzz(tmp_path, rng):
    """Random byte soup must never crash the parser, only return rc < 0 —
    and headers that DO parse must round-trip through the stream."""
    for i in range(200):
        n = int(rng.integers(0, 64))
        p = tmp_path / f"fuzz{i}.ppm"
        p.write_bytes(rng.integers(0, 256, n, dtype=np.uint8).tobytes())
        rc, h, w, ch = _probe(p)
        assert rc <= 0
        if rc == 0:
            assert h > 0 and w > 0 and ch in (1, 3)
    # structured fuzz: valid headers with random comment/whitespace filler
    ws = [b" ", b"\n", b"\t", b"\r", b" # noise\n", b"#x\n"]
    for i in range(50):
        h, w = int(rng.integers(1, 9)), int(rng.integers(1, 9))
        parts = [b"P5"]
        for tok in (str(w).encode(), str(h).encode(), b"255"):
            parts.append(ws[int(rng.integers(0, len(ws)))])
            if int(rng.integers(0, 2)):
                parts.append(ws[int(rng.integers(0, len(ws)))])
            parts.append(tok)
        p = tmp_path / f"wsfuzz{i}.pgm"
        p.write_bytes(b"".join(parts) + b"\n" + b"\x7f" * (h * w))
        rc, hh, wwv, ch = _probe(p)
        assert (rc, hh, wwv, ch) == (0, h, w, 1), p.read_bytes()[:40]


# ---------------------------------------------------------------------------
# Stream decode-failure recovery + unbounded mode (VERDICT r1 item 5)
# ---------------------------------------------------------------------------


def test_frame_stream_skips_decode_failures(tmp_path, rng):
    """A corrupt / wrong-size frame mid-stream is yielded as (t, None) and
    the stream RECOVERS (the reference's live loop survives glitched frames,
    main.cu:222-275)."""
    from cuda_optical_flow_2_tpu.utils import io
    from cuda_optical_flow_2_tpu.utils.native import FrameStream

    paths = []
    for t in range(6):
        p = tmp_path / f"f{t}.pgm"
        if t == 2:
            p.write_bytes(b"garbage not a pnm")
        elif t == 4:
            io.write_ppm(str(p), rng.integers(0, 256, (8, 20), dtype=np.uint8))
        else:
            io.write_ppm(str(p), np.full((16, 20), t * 10, dtype=np.uint8))
        paths.append(str(p))
    with FrameStream.from_ppm(paths, prefetch=2) as src:
        got = list(src)
        assert [t for t, _ in got] == [0, 1, 2, 3, 4, 5]
        ok = [t for t, f in got if f is not None]
        assert ok == [0, 1, 3, 5]
        for t, f in got:
            if f is not None:
                np.testing.assert_allclose(f, np.full((16, 20), t * 10.0))
        assert (src.decoded, src.failed) == (4, 2)


def test_frame_stream_unbounded(tmp_path):
    """nframes=None streams until close() with bounded memory (ring)."""
    from cuda_optical_flow_2_tpu.utils.native import FrameStream

    src = FrameStream.synthetic(None, 24, 32, vx=1.0, vy=0.0, prefetch=3)
    seen = []
    for t, frame in src:
        assert frame is not None and frame.shape == (24, 32)
        seen.append(t)
        if len(seen) >= 40:
            break
    src.close()  # must join the worker without deadlock
    assert seen == list(range(40))


def test_process_sequence_recovers_from_decode_failure():
    """streaming.process_sequence skips None frames: no flow for the lost
    frame, the next good frame pairs across the gap, warm state re-seeded."""
    import jax.numpy as jnp

    import cuda_optical_flow_2_tpu as of
    from cuda_optical_flow_2_tpu.models import streaming
    from cuda_optical_flow_2_tpu.utils import io as uio

    frames = list(
        uio.synthetic_sequence(6, 48, 64, velocity=(2.0, 1.0), noise=0.0)
    )
    seq = [frames[0], frames[1], None, frames[3], None, frames[5]]
    cfg = of.LKConfig(levels=2, window=9, iterations=2, use_pallas=False)
    out = list(streaming.process_sequence(seq, cfg, warm_start=True))
    assert [i for i, _ in out] == [1, 3, 5]
    # pair (1 -> 3) spans the gap: twice the per-frame velocity
    flow13 = np.asarray(out[1][1])
    inner = flow13[12:-12, 12:-12]
    np.testing.assert_allclose(
        np.median(inner[..., 0]), 4.0, atol=0.2
    )
    np.testing.assert_allclose(np.median(inner[..., 1]), 2.0, atol=0.2)


def test_process_sequence_leading_failures():
    import cuda_optical_flow_2_tpu as of
    from cuda_optical_flow_2_tpu.models import streaming
    from cuda_optical_flow_2_tpu.utils import io as uio

    frames = list(
        uio.synthetic_sequence(4, 48, 64, velocity=(1.0, 0.0), noise=0.0)
    )
    seq = [None, None, frames[2], frames[3]]
    cfg = of.LKConfig(levels=2, window=9, use_pallas=False)
    out = list(streaming.process_sequence(seq, cfg))
    assert [i for i, _ in out] == [3]
    seq_all_bad = [None, None]
    assert list(streaming.process_sequence(seq_all_bad, cfg)) == []


def test_frame_stream_stats_after_drain(tmp_path, rng):
    """Producer-side stats() agree with consumer counters once drained."""
    from cuda_optical_flow_2_tpu.utils import io
    from cuda_optical_flow_2_tpu.utils.native import FrameStream

    paths = []
    for t in range(4):
        img = rng.integers(0, 256, (12, 16, 3), dtype=np.uint8)
        path = str(tmp_path / f"f{t}.ppm")
        io.write_ppm(path, img)
        paths.append(path)
    # corrupt one mid-stream frame
    with open(paths[2], "wb") as f:
        f.write(b"P6\n12 16\nnot-a-header")
    with FrameStream.from_ppm(paths, prefetch=2) as src:
        seen = [(t, frame is not None) for t, frame in src]
        assert [t for t, _ in seen] == [0, 1, 2, 3]
        assert [ok for _, ok in seen] == [True, True, False, True]
        assert (src.decoded, src.failed) == (3, 1)
        assert src.stats() == (3, 1)


def test_frame_stream_cross_thread_close():
    """close() racing a consumer blocked inside next2 must not crash/deadlock.

    The consumer thread iterates an UNBOUNDED stream (so it regularly blocks
    on the empty ring waiting for the producer); the main thread closes the
    stream underneath it.  Regression test for the consumer-side
    use-after-free: close() must drain the waiter count before deleting the
    stream.  Run several rounds to shake the race window.
    """
    import threading
    import time

    from cuda_optical_flow_2_tpu.utils.native import FrameStream

    for round_ in range(5):
        src = FrameStream.synthetic(None, 96, 128, vx=1.0, vy=0.0, prefetch=1)
        n_consumed = []

        def consume(src=src, n_consumed=n_consumed):
            count = 0
            try:
                for _t, _f in src:
                    count += 1
            except StopIteration:  # pragma: no cover - raised inside next()
                pass
            n_consumed.append(count)

        th = threading.Thread(target=consume)
        th.start()
        time.sleep(0.02 * (round_ % 3))
        src.close()
        th.join(timeout=30)
        assert not th.is_alive(), "consumer failed to exit after close()"


def test_frame_stream_concurrent_close():
    """Two threads closing the same stream concurrently: one frees, the
    other no-ops (the close lock serializes them) — no double free, no
    stop() on a stale pointer."""
    import threading

    from cuda_optical_flow_2_tpu.utils.native import FrameStream

    for _ in range(5):
        src = FrameStream.synthetic(None, 32, 48, vx=1.0, vy=0.0, prefetch=1)
        next(iter(src))  # stream is live
        barrier = threading.Barrier(2)

        def close(src=src, barrier=barrier):
            barrier.wait()
            src.close()

        threads = [threading.Thread(target=close) for _ in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
            assert not t.is_alive(), "closer deadlocked"
        assert src._handle is None


def _write_y4m_420(path, frames, extras=b"F25:1 Ip A1:1 C420jpeg Xmade-by-test"):
    h, w = frames[0].shape
    with open(path, "wb") as f:
        f.write(b"YUV4MPEG2 W%d H%d %s\n" % (w, h, extras))
        for fr in frames:
            f.write(b"FRAME\n")
            f.write(fr.tobytes())
            f.write(bytes(((w + 1) // 2) * ((h + 1) // 2) * 2))  # gray chroma


def test_y4m_color_roundtrip(tmp_path, rng):
    """RGB frames write as C444 (BT.601 studio range); read_y4m recovers the
    luma plane, and the Y4M FrameStream consumes the video (skipping the
    full-res chroma planes)."""
    from cuda_optical_flow_2_tpu.utils import io
    from cuda_optical_flow_2_tpu.utils.native import FrameStream

    frames = [
        rng.integers(0, 256, (24, 32, 3), dtype=np.uint8) for _ in range(3)
    ]
    path = str(tmp_path / "color.y4m")
    io.write_y4m(path, frames)
    got = list(io.read_y4m(path))
    assert len(got) == 3
    for y, rgb in zip(got, frames):
        r, g, b = (rgb[..., k].astype(np.float64) for k in range(3))
        want = 16.0 + (65.738 * r + 129.057 * g + 25.064 * b) / 256.0
        assert np.abs(y.astype(np.float64) - want).max() <= 1.0
    with FrameStream.from_y4m(path) as src:
        out = [(t, f) for t, f in src]
    assert [t for t, _ in out] == [0, 1, 2]
    for (_, f), y in zip(out, got):
        np.testing.assert_array_equal(f, y.astype(np.float32))


def test_y4m_writer_rejects_shape_drift(tmp_path):
    from cuda_optical_flow_2_tpu.utils import io

    path = str(tmp_path / "drift.y4m")
    with io.Y4MWriter(path) as wr:
        wr.write(np.zeros((8, 8), np.uint8))
        with np.testing.assert_raises(ValueError):
            wr.write(np.zeros((8, 10), np.uint8))
        with np.testing.assert_raises(ValueError):
            wr.write(np.zeros((8, 8), np.float32))


def test_y4m_roundtrip_and_stream(tmp_path, rng):
    """write_y4m -> read_y4m and the native Y4M FrameStream agree exactly."""
    from cuda_optical_flow_2_tpu.utils import io
    from cuda_optical_flow_2_tpu.utils.native import FrameStream

    frames = [
        rng.integers(0, 256, (24, 32), dtype=np.uint8) for _ in range(4)
    ]
    path = str(tmp_path / "seq.y4m")
    io.write_y4m(path, frames)
    got = list(io.read_y4m(path))
    assert len(got) == 4
    for a, b in zip(got, frames):
        np.testing.assert_array_equal(a, b)
    with FrameStream.from_y4m(path) as src:
        assert (src.h, src.w, src.nframes) == (24, 32, None)
        out = [(t, f) for t, f in src]
    assert [t for t, _ in out] == [0, 1, 2, 3]
    for (_, f), ref in zip(out, frames):
        np.testing.assert_array_equal(f, ref.astype(np.float32))


def test_y4m_420_chroma_skipped(tmp_path, rng):
    """C420 streams yield the luma plane; chroma is skipped unread."""
    from cuda_optical_flow_2_tpu.utils import io
    from cuda_optical_flow_2_tpu.utils.native import FrameStream

    frames = [
        rng.integers(0, 256, (16, 20), dtype=np.uint8) for _ in range(3)
    ]
    path = str(tmp_path / "c420.y4m")
    _write_y4m_420(path, frames)
    got = list(io.read_y4m(path))
    assert len(got) == 3
    np.testing.assert_array_equal(got[1], frames[1])
    with FrameStream.from_y4m(path) as src:
        out = [f for _, f in src]
    assert len(out) == 3
    np.testing.assert_array_equal(out[2], frames[2].astype(np.float32))


def test_y4m_truncated_frame(tmp_path, rng):
    """A truncated trailing frame is a decode failure, then clean EOS."""
    from cuda_optical_flow_2_tpu.utils.native import FrameStream, available

    frames = [
        rng.integers(0, 256, (16, 20), dtype=np.uint8) for _ in range(2)
    ]
    path = str(tmp_path / "trunc.y4m")
    _write_y4m_420(path, frames)
    data = open(path, "rb").read()
    with open(path, "wb") as f:
        f.write(data[:-100])  # cut into the last frame's payload
    with FrameStream.from_y4m(path) as src:
        out = [(t, f is not None) for t, f in src]
    # both native and the python fallback: the cut frame is yielded as a
    # per-frame failure, then clean EOS
    assert out == [(0, True), (1, False)]


@pytest.mark.parametrize("use_native", [True, False])
def test_y4m_garbled_marker_resyncs(tmp_path, rng, monkeypatch, use_native):
    """A corrupt mid-stream FRAME marker costs ONE decode failure and the
    stream RESYNCS at the next FRAME magic — not one failure per few bytes
    of the remaining video (native) or silent stream death (fallback)."""
    from cuda_optical_flow_2_tpu.utils import native as nat
    from cuda_optical_flow_2_tpu.utils.native import FrameStream

    if use_native and not nat.available():
        pytest.skip("native library not built")
    if not use_native:
        monkeypatch.setattr(nat, "_try_load", lambda: None)

    frames = [
        rng.integers(0, 256, (16, 20), dtype=np.uint8) for _ in range(4)
    ]
    path = str(tmp_path / "garble.y4m")
    _write_y4m_420(path, frames, extras=b"C420jpeg")
    data = open(path, "rb").read()
    frame_size = 6 + 16 * 20 + 10 * 8 * 2  # "FRAME\n" + Y + 2 chroma planes
    off = len(b"YUV4MPEG2 W20 H16 C420jpeg\n") + 2 * frame_size
    assert data[off : off + 5] == b"FRAME"
    data = data[:off] + b"JUNK!" + data[off + 5 :]
    open(path, "wb").write(data)
    with FrameStream.from_y4m(path) as src:
        out = [(t, f) for t, f in src]
    assert [(t, f is not None) for t, f in out] == [
        (0, True), (1, True), (2, False), (3, True),
    ]
    # the resynced frame is frame 3, decoded intact
    np.testing.assert_array_equal(out[3][1], frames[3].astype(np.float32))


@pytest.mark.parametrize("use_native", [True, False])
def test_y4m_newline_free_junk_recovers_next_frame(
    tmp_path, rng, monkeypatch, use_native
):
    """Junk bytes with NO newline before an intact frame cost one decode
    failure and the intact frame is still recovered.  Regression: the Python
    fallback read the marker with readline(), so newline-free junk swallowed
    the next frame's real "FRAME\\n" and lost a good frame the native reader
    (which reads exactly 5 magic bytes, then scans) recovers."""
    from cuda_optical_flow_2_tpu.utils import native as nat
    from cuda_optical_flow_2_tpu.utils.native import FrameStream

    if use_native and not nat.available():
        pytest.skip("native library not built")
    if not use_native:
        monkeypatch.setattr(nat, "_try_load", lambda: None)

    frames = [
        rng.integers(0, 256, (16, 20), dtype=np.uint8) for _ in range(4)
    ]
    path = str(tmp_path / "junkblob.y4m")
    _write_y4m_420(path, frames, extras=b"C420jpeg")
    data = open(path, "rb").read()
    frame_size = 6 + 16 * 20 + 10 * 8 * 2  # "FRAME\n" + Y + 2 chroma planes
    off = len(b"YUV4MPEG2 W20 H16 C420jpeg\n") + 2 * frame_size
    assert data[off : off + 5] == b"FRAME"
    data = data[:off] + b"\xde\xad\xbe\xef junk without newline" + data[off:]
    open(path, "wb").write(data)
    with FrameStream.from_y4m(path) as src:
        out = [(t, f) for t, f in src]
    assert [(t, f is not None) for t, f in out] == [
        (0, True), (1, True), (2, False), (3, True), (4, True),
    ]
    # BOTH post-junk frames decode intact — nothing was swallowed
    np.testing.assert_array_equal(out[3][1], frames[2].astype(np.float32))
    np.testing.assert_array_equal(out[4][1], frames[3].astype(np.float32))


def test_y4m_error_codes(tmp_path):
    from cuda_optical_flow_2_tpu.utils.native import FrameStream

    bad = str(tmp_path / "bad.y4m")
    with open(bad, "wb") as f:
        f.write(b"NOTAVIDEO\n")
    with pytest.raises(ValueError):
        FrameStream.from_y4m(bad)
    with pytest.raises(ValueError):
        FrameStream.from_y4m(str(tmp_path / "missing.y4m"))


def test_y4m_rejects_high_bit_depth(tmp_path):
    """>8-bit colorspaces (C420p10, C444p16, mono12) have 2-byte samples —
    both parsers must reject them as unsupported rather than hand back a
    garbage half-frame as valid luma; 8-bit chroma-SITING suffixes
    (C420jpeg/paldv/mpeg2) stay accepted."""
    from cuda_optical_flow_2_tpu.utils import io
    from cuda_optical_flow_2_tpu.utils.native import FrameStream

    y = np.arange(8 * 16, dtype=np.uint8).reshape(8, 16)
    for cs in (b"C420p10", b"C422p12", b"C444p16", b"C444alpha", b"Cmono12"):
        path = str(tmp_path / (cs.decode() + ".y4m"))
        with open(path, "wb") as f:
            f.write(b"YUV4MPEG2 W16 H8 F25:1 Ip A1:1 %s\n" % cs)
            f.write(b"FRAME\n" + (y.tobytes() * 2))  # 2 B/px payload
        with pytest.raises(ValueError, match="unsupported"):
            list(io.read_y4m(path))
        with pytest.raises(ValueError, match="unsupported colorspace"):
            FrameStream.from_y4m(path)
    for cs in (b"C420jpeg", b"C420paldv", b"C420mpeg2"):
        path = str(tmp_path / (cs.decode() + ".y4m"))
        chroma = np.zeros((8 // 2) * (16 // 2) * 2, np.uint8)
        with open(path, "wb") as f:
            f.write(b"YUV4MPEG2 W16 H8 F25:1 Ip A1:1 %s\n" % cs)
            f.write(b"FRAME\n" + y.tobytes() + chroma.tobytes())
        got = list(io.read_y4m(path))
        assert len(got) == 1
        np.testing.assert_array_equal(got[0], y)
        with FrameStream.from_y4m(path) as src:
            out = [(t, f) for t, f in src]
        assert len(out) == 1
        np.testing.assert_array_equal(out[0][1], y.astype(np.float32))


def test_y4m_process_sequence(tmp_path):
    """Full pipeline over a Y4M stream: flow recovered from a real video file."""
    import cuda_optical_flow_2_tpu as of
    from cuda_optical_flow_2_tpu.models import streaming
    from cuda_optical_flow_2_tpu.utils import io as uio
    from cuda_optical_flow_2_tpu.utils.native import FrameStream

    frames = uio.synthetic_sequence(5, 48, 64, velocity=(2.0, 1.0), noise=0.0)
    path = str(tmp_path / "seq.y4m")
    uio.write_y4m(path, [np.asarray(f, np.uint8) for f in frames])
    cfg = of.LKConfig(levels=2, window=9, iterations=2, use_pallas=False)
    with FrameStream.from_y4m(path) as src:
        out = list(
            streaming.process_sequence((f for _, f in src), cfg)
        )
    assert [i for i, _ in out] == [1, 2, 3, 4]
    inner = np.asarray(out[-1][1])[12:-12, 12:-12]
    np.testing.assert_allclose(np.median(inner[..., 0]), 2.0, atol=0.2)
    np.testing.assert_allclose(np.median(inner[..., 1]), 1.0, atol=0.2)


def test_ppm_crlf_header(tmp_path, rng):
    """A P6/P5 header terminated with CRLF (text-mode Windows writers) must
    not shift the raster by one byte — python and native parsers agree."""
    from cuda_optical_flow_2_tpu.utils import io, native

    img = rng.integers(0, 256, (6, 7, 3), dtype=np.uint8)
    path = str(tmp_path / "crlf.ppm")
    with open(path, "wb") as f:
        f.write(b"P6\r\n7 6\r\n255\r\n")
        f.write(img.tobytes())
    np.testing.assert_array_equal(io.read_ppm(path), img)
    lib = native._try_load()
    if lib is not None:
        import ctypes

        h = ctypes.c_int()
        w = ctypes.c_int()
        ch = ctypes.c_int()
        assert lib.of2_ppm_probe(
            path.encode(), ctypes.byref(h), ctypes.byref(w), ctypes.byref(ch)
        ) == 0
        buf = np.empty(6 * 7 * 3, np.uint8)
        assert lib.of2_ppm_read(
            path.encode(),
            buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            buf.size,
        ) == 0
        np.testing.assert_array_equal(buf.reshape(6, 7, 3), img)


@needs_native
def test_stream_open_rejects_absurd_dimensions(tmp_path):
    """Oversized frame dimensions fail the open cleanly (null handle ->
    ValueError) instead of a bad_alloc aborting the process: the Y4M/PPM
    headers cap W and H individually, but their product can request
    terabytes for the prefetch ring (framesrc.cpp stream_start guard)."""
    from cuda_optical_flow_2_tpu.utils.native import FrameStream

    # Synthetic: dimensions are caller-supplied.
    with pytest.raises(ValueError, match="synthetic"):
        FrameStream.synthetic(2, 40000, 40000, vx=1.0, vy=0.0)
    with pytest.raises(ValueError, match="synthetic"):
        FrameStream.synthetic(2, 0, 32, vx=1.0, vy=0.0)

    # Y4M: a well-formed header promising a 1e6 x 1e6 luma plane. The probe
    # itself succeeds (the header IS well-formed), the stream open must not.
    path = tmp_path / "huge.y4m"
    path.write_bytes(b"YUV4MPEG2 W1000000 H1000000 F25:1 C420\nFRAME\n")
    lib = native._try_load()
    import ctypes

    h = ctypes.c_int()
    w = ctypes.c_int()
    assert (
        lib.of2_y4m_probe(str(path).encode(), ctypes.byref(h), ctypes.byref(w))
        == 0
    )
    with pytest.raises(ValueError, match="too large|allocation"):
        FrameStream.from_y4m(str(path))


@needs_native
def test_y4m_header_dimension_overflow(tmp_path):
    """W/H tokens that overflow long must be rejected (strtol clamps, the
    range check fires), never parsed into a garbage positive size."""
    import ctypes

    lib = native._try_load()
    h = ctypes.c_int()
    w = ctypes.c_int()
    path = tmp_path / "overflow.y4m"
    path.write_bytes(
        b"YUV4MPEG2 W99999999999999999999 H480 F25:1 C420\nFRAME\n"
    )
    assert (
        lib.of2_y4m_probe(str(path).encode(), ctypes.byref(h), ctypes.byref(w))
        == -2
    )

class TestV4L2:
    """Camera (V4L2) ingestion — error-path coverage (no camera device in
    CI; the open/negotiate/teardown plumbing is exercised through the
    probe's distinct failure codes)."""

    def test_probe_missing_device(self):
        if not native.available():
            pytest.skip("native library unavailable")
        rc, _, _ = native.v4l2_probe("/nonexistent/video99")
        assert rc == -1

    def test_probe_non_camera_file(self, tmp_path):
        if not native.available():
            pytest.skip("native library unavailable")
        p = tmp_path / "not_a_camera"
        p.write_bytes(b"plain file")
        rc, _, _ = native.v4l2_probe(str(p))
        assert rc == -2  # opens, but QUERYCAP/ioctl rejects it

    def test_from_v4l2_raises_with_reason(self):
        if not native.available():
            pytest.skip("native library unavailable")
        with pytest.raises(ValueError, match="cannot open camera"):
            native.FrameStream.from_v4l2("/nonexistent/video99")

    def test_real_camera_if_present(self):
        """Full capture loop when a camera exists (skipped in CI)."""
        if not native.available():
            pytest.skip("native library unavailable")
        import os

        if not os.path.exists("/dev/video0"):
            pytest.skip("no camera device")
        rc, h, w = native.v4l2_probe("/dev/video0")
        if rc != 0:
            pytest.skip(f"camera present but not usable (rc={rc})")
        stream = native.FrameStream.from_v4l2("/dev/video0")
        try:
            got = 0
            for t, frame in stream:
                if frame is not None:
                    assert frame.shape == (stream.h, stream.w)
                    got += 1
                if t >= 5:
                    break
            assert got >= 1
        finally:
            stream.close()
