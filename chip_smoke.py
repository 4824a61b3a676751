#!/usr/bin/env python
"""Smoke run of the main path on the GPU, checked against its references.

    python chip_smoke.py              # one card, every phase below
    python chip_smoke.py --cards 4    # the four-card paths only

Phases on one card (any failure raises and exits non-zero):

1. the card (nvidia-smi name and power limit), JAX's devices and the
   compile-cache directory;
2. PAPER_1080P (5 levels, 15x15 tri window) on a seeded 1080p pair of a
   translating band-limited texture: compiled once, ``memory_analysis()`` printed, the fused Triton
   residual kernel asserted to be what runs at every level, and compared
   with the XLA twin (|delta flow| bounds) and the analytic velocity (EPE);
3. warm-start streaming at 1080p over 8 frames, EPE against the truth;
4. REFERENCE_GPU (640x480, 9x9 bilateral prefilter) as in phase 2, and the
   uchar-exact compat profile against the NumPy oracle;
5. one 1080p pair of HS, FB, TVL1_REALTIME and DIS_REALTIME through
   ``pyramidal_flow``, EPE printed;
6. the on-card checks of tests/test_gpu_device.py, called in this process.

With ``--cards 4`` it runs data parallelism on 8 1080p pairs and spatial
parallelism on one 2160x3840 pair over four cards, each against one card.
The last line of standard output is one JSON object with the device.
Exits non-zero, printing no result, when JAX finds no GPU.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np


def _phase(name: str):
    print(f"\n== {name}", flush=True)
    return time.perf_counter()


def _done(t0: float, **values) -> None:
    for k, v in values.items():
        print(f"   {k}: {v}", flush=True)
    print(f"   ({time.perf_counter() - t0:.1f} s)", flush=True)


def one_card() -> None:
    import jax

    import cuda_optical_flow_2_tpu as of
    from cuda_optical_flow_2_tpu.models import (
        DIS_REALTIME,
        FBConfig,
        HSConfig,
        TVL1_REALTIME,
        pyramidal_flow,
    )
    from cuda_optical_flow_2_tpu.models.streaming import process_sequence
    from cuda_optical_flow_2_tpu.utils import device_checks as dc

    t0 = _phase("2. PAPER_1080P: fused kernel vs XLA twin at 1920x1080")
    _done(t0, **dc.pipeline_parity(of.PAPER_1080P, 1080, 1920))

    t0 = _phase("3. warm-start streaming, PAPER_1080P, 8 frames of 1080p")
    velocity = (2.0, 1.0)
    seq = dc.frames(8, 1080, 1920, velocity)
    epes = [
        dc.epe(flow, velocity, 120)
        for _, flow in process_sequence(seq, of.PAPER_1080P, warm_start=True)
    ]
    assert len(epes) == 7 and np.isfinite(epes).all() and max(epes) < 0.5, epes
    _done(t0, epe_per_pair=epes)

    t0 = _phase("4. REFERENCE_GPU at 640x480 (bilateral prefilter), compat vs oracle")
    ref = dc.pipeline_parity(of.REFERENCE_GPU, 480, 640)
    _done(t0, **ref, compat=dc.compat_vs_oracle())

    t0 = _phase("5. every family at 1080p through pyramidal_flow")
    prev, nxt = dc.pair(1080, 1920, velocity)
    for name, cfg in [
        ("HS", HSConfig()),
        ("FB", FBConfig()),
        ("TVL1_REALTIME", TVL1_REALTIME),
        ("DIS_REALTIME", DIS_REALTIME),
    ]:
        flow = np.asarray(jax.jit(lambda a, b, c=cfg: pyramidal_flow(a, b, c))(prev, nxt))
        assert flow.shape == (1080, 1920, 2) and np.isfinite(flow).all(), name
        print(f"   {name}: EPE {dc.epe(flow, velocity, 120)}", flush=True)
    _done(t0)

    t0 = _phase("6. on-card checks (tests/test_gpu_device.py)")
    from cuda_optical_flow_2_tpu.models.dis import DISConfig

    # (the box window rode phase 4's REFERENCE_GPU parity)
    for cfg in (
        of.LKConfig(levels=2, window=9, iterations=2),
        of.LKConfig(levels=2, window=9, iterations=2, window_weights="gauss"),
        DISConfig(levels=2, window=9, iterations=2),
    ):
        rows = dc.stage_parity(cfg)
        print(f"   stage parity {cfg.__class__.__name__} "
              f"{getattr(cfg, 'window_weights', '')}: "
              f"max mean |delta| {max(r.mean_abs for r in rows)}", flush=True)
    _done(
        t0,
        spatial_one_card={m: dc.spatial_one_device(m) for m in dc.FAMILIES},
        translation_median=dc.translation_accuracy(),
        charbonnier_dis_mean_diff=dc.charbonnier_parity(),
        fps_256x512=dc.headline_clears_target(),
    )


def four_cards() -> None:
    from cuda_optical_flow_2_tpu.utils import device_checks as dc

    t0 = _phase("DP (8 pairs of 1080p) and spatial TP (2160x3840) on 4 cards")
    _done(t0, **dc.multi_card_parity(4))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cards", type=int, choices=(1, 4), default=1)
    args = ap.parse_args()

    import jax

    from cuda_optical_flow_2_tpu.utils.profiling import (
        device_info,
        enable_compile_cache,
        require_gpu,
    )

    require_gpu("chip_smoke.py")
    t0 = _phase("1. device")
    cache = enable_compile_cache()
    info = device_info()
    _done(t0, card=info["card"], devices=jax.devices(), compile_cache=cache)
    if args.cards == 4:
        four_cards()
    else:
        one_card()
    print(info["card"])
    device = {k: info[k] for k in ("platform", "kind", "count")}
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
