#!/usr/bin/env python
"""Headline benchmark: pyramidal LK throughput on 1080p frame pairs, one GPU.

Prints the card (``nvidia-smi`` name and power limit) and then ONE JSON line:
{"metric", "value", "unit", "vs_baseline", "device"}.

Configuration is BASELINE.json config 4 (the paper operating point scaled to
1080p): 5 pyramid levels, 15x15 integration window, grayscale 1920x1080 pair.
``vs_baseline`` is fps / 60 — the >60 fps target from BASELINE.md (the
reference itself only claims "real-time" at 640x480, README.md:22-24).

Timing: host clock around ``block_until_ready`` after a warm-up, over windows
of back-to-back calls (utils/profiling.device_time).  Exits non-zero, with no
result, when JAX finds no GPU.
"""

from __future__ import annotations

import json

import numpy as np

import jax
import jax.numpy as jnp

import cuda_optical_flow_2_tpu as of
from cuda_optical_flow_2_tpu.utils.profiling import (
    device_info,
    device_time,
    enable_compile_cache,
    require_gpu,
)

H, W = 1080, 1920
BASELINE_FPS = 60.0
ITERS = 50


def main() -> None:
    require_gpu("bench.py")
    enable_compile_cache()
    device = device_info()
    print(device["card"], flush=True)

    cfg = of.PAPER_1080P
    rng = np.random.default_rng(0)
    prev = jnp.asarray(rng.integers(0, 256, (H, W)).astype(np.float32))
    nxt = jnp.asarray(rng.integers(0, 256, (H, W)).astype(np.float32))
    fn = jax.jit(lambda p, n: of.pyramidal_lk(p, n, cfg))
    flow = np.asarray(fn(prev, nxt))
    assert flow.shape == (H, W, 2) and np.isfinite(flow).all()

    fps = 1.0 / device_time(fn, prev, nxt, iters=ITERS)
    print(
        json.dumps(
            {
                "metric": "pyramidal_lk_1080p_fps",
                "value": fps,
                "unit": "frames/sec/card",
                "vs_baseline": fps / BASELINE_FPS,
                "device": device,
            }
        )
    )


if __name__ == "__main__":
    main()
