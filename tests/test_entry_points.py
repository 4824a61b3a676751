"""Installed console entry points run as real subprocesses from any cwd.

The reference ships a runnable executable (CMakeLists.txt:73); our equivalent
is the `of2-*` console scripts declared in pyproject.toml.  These tests invoke
them through the installed scripts (subprocess, cwd=/ outside the repo), not
in-process `main()` calls, so a missing/broken install is caught.
"""

import json
import os
import shutil
import subprocess
import sys

import pytest


def _script(name: str) -> str:
    path = shutil.which(name)
    if path is None:
        pytest.skip(
            f"{name} not on PATH - run `pip install -e .` (see README)"
        )
    return path


def _run(args, cwd="/"):
    env = dict(os.environ)
    # Same platform pinning as conftest.py: the scripts must work on
    # CPU-only hosts.
    env["JAX_PLATFORMS"] = "cpu"
    env.pop("PYTEST_CURRENT_TEST", None)
    return subprocess.run(
        args, cwd=cwd, env=env, capture_output=True, text=True, timeout=600
    )


@pytest.mark.parametrize(
    "name", ["of2-demo", "of2-benchmark", "of2-eval", "of2-diff"]
)
def test_help_runs_from_root_cwd(name):
    proc = _run([_script(name), "--help"])
    assert proc.returncode == 0, proc.stderr
    assert name in proc.stdout or "usage" in proc.stdout


def test_demo_synthetic_from_tmp(tmp_path):
    out = tmp_path / "flow"
    proc = _run(
        [
            _script("of2-demo"), "--synthetic", "2", "--size", "48x64",
            "--levels", "2", "--window", "9", "--no-pallas",
            "--out", str(out),
        ],
        cwd=str(tmp_path),
    )
    assert proc.returncode == 0, proc.stderr
    assert "EPE" in proc.stdout
    assert any(f.startswith("flow") for f in os.listdir(out))


def test_eval_synthetic_tree_from_tmp(tmp_path):
    # Minimal generic-layout dataset: one pair + .flo truth.
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import numpy as np

    from conftest import make_translating_pair
    from cuda_optical_flow_2_tpu.utils import io

    pair = tmp_path / "data" / "seq0"
    pair.mkdir(parents=True)
    f1, f2 = make_translating_pair(h=48, w=64, dx=1, dy=0)
    io.write_ppm(str(pair / "frame_0001.ppm"), f1)
    io.write_ppm(str(pair / "frame_0002.ppm"), f2)
    truth = np.zeros((48, 64, 2), np.float32)
    truth[..., 0] = 1.0
    io.write_flo(str(pair / "frame_0001.flo"), truth)

    proc = _run(
        [
            _script("of2-eval"), "--dataset", str(tmp_path / "data"),
            "--levels", "2", "--window", "9", "--no-pallas",
        ],
        cwd=str(tmp_path),
    )
    assert proc.returncode == 0, proc.stderr
    record = json.loads(proc.stdout.strip().splitlines()[-1])
    assert record["pairs"] == 1
    assert record["epe_mean"] < 0.5
