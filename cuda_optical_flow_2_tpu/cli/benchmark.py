"""Benchmark CLI: throughput + accuracy across the BASELINE configurations.

Runs any of the five BASELINE.json configs (the reference's implied operating
points scaled up) on the GPU and reports per-config throughput (host clock
around ``block_until_ready``, see utils/profiling.py), the device it ran on,
and, where ground truth exists, EPE.  Exits non-zero without a GPU.

    python -m cuda_optical_flow_2_tpu.cli.benchmark --configs 1 4 --iters 20
"""

from __future__ import annotations

import argparse
import json

import numpy as np

import jax
import jax.numpy as jnp

import cuda_optical_flow_2_tpu as of
from cuda_optical_flow_2_tpu.utils import io as uio
from cuda_optical_flow_2_tpu.cli import xla_only
from cuda_optical_flow_2_tpu.utils.profiling import (
    device_info,
    device_time,
    enable_compile_cache,
    require_gpu,
)

__all__ = ["main", "CONFIGS"]

# BASELINE.json "configs" (1-based), scaled to concrete shapes.
CONFIGS = {
    1: dict(
        name="single-level 64x64 checkerboard, 5x5 window",
        shape=(64, 64), cfg=of.LKConfig(levels=1, window=5, temporal_kernel="gauss3"),
        velocity=(1.0, 0.0),
    ),
    2: dict(
        name="single-level 480x360, 9x9 window, 3 iterations",
        shape=(360, 480),
        cfg=of.LKConfig(levels=1, window=9, iterations=3, temporal_kernel="gauss3"),
        velocity=(2.0, 1.0),
    ),
    3: dict(
        name="3-level 720p, bilinear warp + flow upsampling",
        shape=(720, 1280),
        cfg=of.LKConfig(levels=3, window=11, temporal_kernel="gauss3"),
        velocity=(4.0, 2.0),
    ),
    4: dict(
        name="5-level 1080p, 15x15 window (paper config)",
        shape=(1080, 1920), cfg=of.PAPER_1080P, velocity=(6.0, 3.0),
    ),
    5: dict(
        name="64-frame 1080p batch over the device mesh",
        shape=(1080, 1920), cfg=of.PAPER_1080P, velocity=(6.0, 3.0), batch=True,
    ),
}


def _run_config(idx: int, spec: dict, iters: int) -> dict:
    h, w = spec["shape"]
    vx, vy = spec["velocity"]
    cfg = spec["cfg"]
    frames = uio.synthetic_sequence(2, h, w, velocity=(vx, vy), period=24)
    prev = jnp.asarray(frames[0].astype(np.float32))
    nxt = jnp.asarray(frames[1].astype(np.float32))

    from cuda_optical_flow_2_tpu.models import pyramidal_flow

    if spec.get("batch"):
        n_dev = len(jax.devices())
        from cuda_optical_flow_2_tpu import parallel

        mesh = parallel.make_mesh()
        b = max(64 // max(n_dev, 1) * n_dev, n_dev)
        pb = jnp.broadcast_to(prev, (b, h, w))
        nb = jnp.broadcast_to(nxt, (b, h, w))
        fn = lambda p, n: parallel.sharded_flow(p, n, cfg, mesh)  # noqa: E731
        secs = device_time(lambda p, n: fn(p, n), pb, nb, iters=max(iters // 4, 2))
        fps = b / secs
        flow = np.asarray(fn(pb, nb)[0])
    else:
        fn = lambda p, n: pyramidal_flow(p, n, cfg)  # noqa: E731
        secs = device_time(fn, prev, nxt, iters=iters)
        fps = 1.0 / secs
        flow = np.asarray(jax.jit(fn)(prev, nxt))

    m = max(min(h, w) // 8, 8)
    inner = flow[m:-m, m:-m]
    epe = float(np.hypot(inner[..., 0] - vx, inner[..., 1] - vy).mean())
    return {
        "config": idx,
        "name": spec["name"],
        "fps": fps,
        "ms_per_frame": 1e3 * secs,
        "epe_vs_truth": epe,
    }


def _model_cfg(model: str, lk_cfg, no_pallas: bool):
    """Map a BASELINE LK config onto the requested model family."""
    if model == "hs":
        from cuda_optical_flow_2_tpu.models.horn_schunck import HSConfig

        cfg = HSConfig(levels=lk_cfg.levels, iterations=100)
    elif model == "tvl1":
        from cuda_optical_flow_2_tpu.models.tvl1 import TVL1Config

        cfg = TVL1Config(levels=lk_cfg.levels)
    elif model == "fb":
        from cuda_optical_flow_2_tpu.models.farneback import FBConfig

        cfg = FBConfig(
            levels=lk_cfg.levels,
            winsize=lk_cfg.window if lk_cfg.window % 2 else lk_cfg.window + 1,
        )
    elif model == "dis":
        from cuda_optical_flow_2_tpu.models.dis import DISConfig

        cfg = DISConfig(
            levels=lk_cfg.levels,
            window=lk_cfg.window if lk_cfg.window % 2 else lk_cfg.window + 1,
        )
    else:
        cfg = lk_cfg
    return xla_only(cfg) if no_pallas else cfg


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--configs", type=int, nargs="+", default=[1, 2, 3, 4])
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--no-pallas", action="store_true")
    ap.add_argument(
        "--model", default="lk", choices=("lk", "hs", "fb", "tvl1", "dis"),
        help="model family to run the configs with (pyramid depth and window "
        "carry over; HS uses its default 100 sweeps)",
    )
    args = ap.parse_args(argv)
    require_gpu("of2-benchmark")
    enable_compile_cache()
    device = device_info()

    for idx in args.configs:
        spec = dict(CONFIGS[idx])
        spec["cfg"] = _model_cfg(args.model, spec["cfg"], args.no_pallas)
        if args.model != "lk":
            spec["name"] = f'{spec["name"]} [{args.model}]'
        rec = _run_config(idx, spec, args.iters)
        print(json.dumps({**rec, "device": device}), flush=True)


if __name__ == "__main__":
    main()
