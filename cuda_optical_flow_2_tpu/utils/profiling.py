"""Timing, profiling and compile-cache helpers.

The reference has no timing instrumentation at all (SURVEY.md section 5 —
no cudaEvent/chrono anywhere); this module provides the measurement layer the
framework standardizes on:

* :func:`device_time` — seconds per call of a jitted function, from the host
  clock around ``block_until_ready`` after a warm-up.
* :func:`trace` — context manager around ``jax.profiler`` for Perfetto traces.
* :func:`enable_compile_cache` — the one place that points JAX's persistent
  compilation cache at a directory.
* :func:`require_gpu` / :func:`device_info` — what every measurement checks
  first and prints beside its numbers.
"""

from __future__ import annotations

import contextlib
import os
import subprocess
import sys
import time
from typing import Callable

import jax
import numpy as np

__all__ = [
    "compile_cache_dir",
    "device_info",
    "device_time",
    "enable_compile_cache",
    "require_gpu",
    "trace",
]

_CHECKOUT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)


def compile_cache_dir() -> str:
    """``JAX_COMPILATION_CACHE_DIR`` when set, else ``<checkout>/.jax_cache``."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or os.path.join(
        _CHECKOUT, ".jax_cache"
    )


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at :func:`compile_cache_dir`.

    Returns the directory.  Call before the first compilation.
    """
    path = compile_cache_dir()
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    return path


def require_gpu(tool: str) -> None:
    """Exit non-zero, printing no result, unless JAX's backend is the GPU.

    Measurements name the device they ran on and never fall back to the CPU.
    """
    backend = jax.default_backend()
    if backend != "gpu":
        print(f"{tool}: needs a GPU; JAX's backend is {backend!r}", file=sys.stderr)
        raise SystemExit(2)


def device_info() -> dict:
    """The device as JAX reports it, plus the card's name and power limit
    (``nvidia-smi``), to print beside every number."""
    dev = jax.devices()[0]
    try:
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=30,
        ).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        card = "not available"
    return {
        "platform": dev.platform,
        "kind": dev.device_kind,
        "count": len(jax.devices()),
        "card": card,
    }


def device_time(
    fn: Callable[..., jax.Array],
    *args: jax.Array,
    iters: int = 20,
    repeats: int = 5,
) -> float:
    """Seconds per call of ``fn(*args)`` on the default device.

    Warms up (compiles) once, then times ``repeats`` windows of ``iters``
    back-to-back calls, each window closed by ``block_until_ready`` on the
    last result; returns the median window time divided by ``iters``.
    Back-to-back dispatch keeps the device queue full, so host dispatch
    overlaps device work as it does in a serving loop.
    """
    jax.block_until_ready(fn(*args))
    windows = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        for _ in range(iters):
            out = fn(*args)
        jax.block_until_ready(out)
        windows.append((time.perf_counter() - t0) / iters)
    return float(np.median(windows))


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a jax.profiler trace (view with Perfetto / TensorBoard)."""
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
