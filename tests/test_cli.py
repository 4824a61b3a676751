"""CLI smoke tests: demo and benchmark mains end-to-end on CPU."""

import json
import os

import numpy as np


def test_demo_synthetic_writes_artifacts(tmp_path, capsys):
    from cuda_optical_flow_2_tpu.cli import demo

    out = str(tmp_path / "flow")
    demo.main([
        "--synthetic", "3", "--size", "64x80", "--levels", "2", "--window", "9",
        "--no-pallas", "--out", out, "--debug-gradients",
    ])
    text = capsys.readouterr().out
    assert "EPE vs (2.0, 1.0)" in text
    files = os.listdir(out)
    assert any(f.startswith("flow") for f in files)
    assert any(f.startswith("arrows") for f in files)
    assert any("_I" in f for f in files)  # gradient maps (showTest twin)


def test_demo_out_video(tmp_path, capsys):
    """--out-video writes the flow-color frames as one playable C444 Y4M."""
    from cuda_optical_flow_2_tpu.cli import demo
    from cuda_optical_flow_2_tpu.utils import io

    path = str(tmp_path / "flow.y4m")
    demo.main([
        "--synthetic", "4", "--size", "48x64", "--levels", "2", "--window",
        "9", "--no-pallas", "--out-video", path,
    ])
    capsys.readouterr()
    lumas = list(io.read_y4m(path))
    assert len(lumas) == 3  # one flow frame per pair
    assert lumas[0].shape == (48, 64)


def test_demo_native_stream_matches_materialized(tmp_path, capsys):
    from cuda_optical_flow_2_tpu.cli import demo

    demo.main([
        "--synthetic", "3", "--size", "64x80", "--levels", "2", "--window", "9",
        "--no-pallas", "--native-stream",
    ])
    streamed = capsys.readouterr().out
    demo.main([
        "--synthetic", "3", "--size", "64x80", "--levels", "2", "--window", "9",
        "--no-pallas",
    ])
    direct = capsys.readouterr().out
    # The native stream generates the noise-free texture; the materialized
    # path adds noise=1.0 (io.synthetic_sequence default) — so compare EPE
    # loosely, not bitwise.
    pick = lambda s: [
        float(l.rsplit(":", 1)[1]) for l in s.splitlines() if "EPE" in l
    ]
    a, b = pick(streamed), pick(direct)
    assert len(a) == len(b) == 2
    assert all(abs(x - y) < 0.05 for x, y in zip(a, b))


def test_benchmark_cli_config1(capsys):
    """The benchmark CLI measures the GPU only: on the CPU it exits
    non-zero before printing any result."""
    import pytest

    from cuda_optical_flow_2_tpu.cli import benchmark

    with pytest.raises(SystemExit) as exc:
        benchmark.main(["--configs", "1", "--iters", "3"])
    assert exc.value.code != 0
    captured = capsys.readouterr()
    assert not captured.out.strip() and "needs a GPU" in captured.err


def test_demo_hs_model(capsys):
    from cuda_optical_flow_2_tpu.cli import demo

    demo.main([
        "--synthetic", "3", "--size", "64x80", "--levels", "2",
        "--model", "hs", "--alpha", "8.0", "--iterations", "60", "--no-pallas",
    ])
    text = capsys.readouterr().out
    epes = [float(l.rsplit(":", 1)[1]) for l in text.splitlines() if "EPE" in l]
    assert len(epes) == 2
    assert all(e < 0.8 for e in epes), epes


def test_demo_fb_model(capsys):
    from cuda_optical_flow_2_tpu.cli import demo

    demo.main([
        "--synthetic", "3", "--size", "64x80", "--levels", "2",
        "--model", "fb", "--window", "15", "--no-pallas",
    ])
    text = capsys.readouterr().out
    epes = [float(l.rsplit(":", 1)[1]) for l in text.splitlines() if "EPE" in l]
    assert len(epes) == 2
    assert all(e < 0.5 for e in epes), epes


def test_demo_occlusion_artifacts(tmp_path, capsys):
    from cuda_optical_flow_2_tpu.cli import demo

    out = tmp_path / "occ"
    demo.main([
        "--synthetic", "3", "--size", "48x64", "--levels", "2",
        "--window", "9", "--no-pallas", "--out", str(out), "--occlusion",
    ])
    capsys.readouterr()
    assert (out / "occ0001.png").exists()
    assert (out / "occ0002.png").exists()


def test_benchmark_model_flag(capsys):
    import json

    from cuda_optical_flow_2_tpu.cli import benchmark

    # main() refuses the CPU; the config mapping and the measured run it
    # drives are exercised directly.
    spec = dict(benchmark.CONFIGS[1])
    spec["cfg"] = benchmark._model_cfg("fb", spec["cfg"], no_pallas=True)
    spec["name"] += " [fb]"
    rec = json.loads(json.dumps(benchmark._run_config(1, spec, iters=2)))
    assert rec["config"] == 1 and "[fb]" in rec["name"]
    assert rec["epe_vs_truth"] < 0.5


def test_demo_warm_start(capsys):
    from cuda_optical_flow_2_tpu.cli import demo

    demo.main([
        "--synthetic", "4", "--size", "64x80", "--levels", "1",
        "--window", "11", "--no-pallas", "--warm-start",
        "--iterations", "2", "--temporal-kernel", "gauss3",
    ])
    text = capsys.readouterr().out
    epes = [float(l.rsplit(":", 1)[1]) for l in text.splitlines() if "EPE" in l]
    assert len(epes) == 3
    assert epes[-1] < 0.6, epes


def test_demo_warm_start_with_recovery(capsys):
    """--recover-levels arms the scene-cut check on the demo's streaming
    loop (flag validation + end-to-end run)."""
    import pytest

    from cuda_optical_flow_2_tpu.cli import demo

    demo.main([
        "--synthetic", "4", "--size", "64x80", "--levels", "1",
        "--window", "11", "--no-pallas", "--warm-start",
        "--recover-levels", "3", "--iterations", "2",
        "--temporal-kernel", "gauss3",
    ])
    text = capsys.readouterr().out
    epes = [float(l.rsplit(":", 1)[1]) for l in text.splitlines() if "EPE" in l]
    assert len(epes) == 3
    assert epes[-1] < 0.6, epes
    with pytest.raises(SystemExit):
        demo.main(["--synthetic", "2", "--recover-levels", "3"])
    capsys.readouterr()


def test_demo_file_frames(tmp_path, capsys):
    """--frames glob: PNG round trip through the file-input path."""
    import numpy as np

    from cuda_optical_flow_2_tpu.cli import demo
    from cuda_optical_flow_2_tpu.utils import io, viz

    frames = io.synthetic_sequence(3, 48, 64, velocity=(1.0, 0.5))
    for i, f in enumerate(frames):
        viz.write_png(str(tmp_path / f"f{i:03d}.png"), f.astype(np.uint8))
    out = tmp_path / "out"
    demo.main([
        "--frames", str(tmp_path / "f*.png"), "--levels", "2",
        "--window", "9", "--no-pallas", "--out", str(out),
    ])
    capsys.readouterr()
    assert (out / "flow0001.png").exists()
    assert (out / "arrows0002.png").exists()


def test_demo_tvl1_model(capsys):
    from cuda_optical_flow_2_tpu.cli import demo

    demo.main([
        "--synthetic", "3", "--size", "64x80", "--levels", "2",
        "--model", "tvl1", "--iterations", "15", "--no-pallas",
    ])
    text = capsys.readouterr().out
    epes = [float(l.rsplit(":", 1)[1]) for l in text.splitlines() if "EPE" in l]
    assert len(epes) == 2
    assert all(e < 0.8 for e in epes), epes


def test_demo_dis_model(capsys):
    from cuda_optical_flow_2_tpu.cli import demo

    demo.main([
        "--synthetic", "3", "--size", "64x80", "--levels", "2",
        "--model", "dis", "--window", "9", "--no-pallas",
    ])
    text = capsys.readouterr().out
    epes = [float(l.rsplit(":", 1)[1]) for l in text.splitlines() if "EPE" in l]
    assert len(epes) == 2
    assert all(e < 0.8 for e in epes), epes


def test_demo_track_overlays(tmp_path, capsys):
    """--track N seeds an NxN grid and writes trajectory overlays whose
    tracked points actually moved by the synthetic velocity."""
    from cuda_optical_flow_2_tpu.cli import demo
    from cuda_optical_flow_2_tpu.utils.io import read_image

    out = str(tmp_path / "trk")
    demo.main([
        "--synthetic", "4", "--size", "64x80", "--levels", "2", "--window", "9",
        "--no-pallas", "--out", out, "--track", "3",
    ])
    files = sorted(f for f in os.listdir(out) if f.startswith("tracks"))
    assert files == ["tracks0001.png", "tracks0002.png", "tracks0003.png"]
    img = read_image(os.path.join(out, files[-1]))
    assert img.shape == (64, 80, 3)
    # the overlay drew something non-grayscale (trail + dots)
    assert (img[..., 1].astype(int) != img[..., 0].astype(int)).any()
