"""The measurement tools refuse to run without a GPU, and the compile
cache lives where one helper says."""

import os
import shutil
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(args, cwd=ROOT):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTEST_CURRENT_TEST", None)
    return subprocess.run(
        [sys.executable, *args], cwd=cwd, env=env, capture_output=True,
        text=True, timeout=300,
    )


@pytest.mark.parametrize(
    "args",
    [
        ["chip_smoke.py"],
        ["chip_smoke.py", "--cards", "4"],
        ["bench.py"],
        ["docs/studies/gpu_kernel_study.py", "--quick"],
    ],
    ids=["chip_smoke", "chip_smoke_4_cards", "bench", "kernel_study"],
)
def test_measurement_tools_exit_nonzero_on_cpu(args):
    proc = _run(args)
    assert proc.returncode != 0, proc.stdout
    assert '"ok"' not in proc.stdout and "needs a GPU" in proc.stderr


def test_chip_smoke_alone_exits_nonzero(tmp_path):
    """Copied away from the package, the script fails instead of passing."""
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    proc = _run(["chip_smoke.py"], cwd=str(tmp_path))
    assert proc.returncode != 0 and '"ok"' not in proc.stdout


def test_compile_cache_dir_defaults_to_checkout(monkeypatch):
    from cuda_optical_flow_2_tpu.utils import profiling

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert profiling.compile_cache_dir() == os.path.join(ROOT, ".jax_cache")


def test_compile_cache_dir_honours_env(monkeypatch, tmp_path):
    import jax

    from cuda_optical_flow_2_tpu.utils import profiling

    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    old = jax.config.jax_compilation_cache_dir
    try:
        assert profiling.enable_compile_cache() == str(tmp_path)
        assert jax.config.jax_compilation_cache_dir == str(tmp_path)
    finally:
        jax.config.update("jax_compilation_cache_dir", old)


def test_require_gpu_exits_on_cpu(capsys):
    from cuda_optical_flow_2_tpu.utils import profiling

    with pytest.raises(SystemExit) as exc:
        profiling.require_gpu("tool")
    assert exc.value.code != 0
    assert "needs a GPU" in capsys.readouterr().err
