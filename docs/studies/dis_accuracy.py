"""DIS design sweep: temporal kernel x GN iterations x refinement, EPE.

Usage: python docs/studies/dis_accuracy.py   (CPU is fine — accuracy only)

The sweep that fixed the DISConfig defaults (models/dis.py):

* ``temporal_kernel="dt3"`` beats the paper-faithful raw difference
  (``"delta"``) ~2.7x on EPE: the pipeline's spatial gradients are
  Sobel-smoothed, and an unsmoothed temporal term against smoothed spatial
  terms biases the Gauss-Newton step.
* ``iterations=2`` is the knee: on a small (2,1) translation i1/i2 tie,
  on a large (7,4) translation i2 halves i1's EPE; i4 diverges on aliased
  regions (same mechanism as iterated LK).
* Variational refinement with the mean-centered data term keeps EPE flat
  under a +25 global brightness offset; with the raw data term it blows up
  (0.5 -> 4.2) — the measurement behind models/dis._refine's centering.

Representative output (96x128 and 128x160 translating textures, CPU):

    small (2,1):  tk=dt3 i=2 ref=5   clean=0.096  bright=0.097
                  tk=delta i=2 ref=5 clean=0.220  bright=0.218
                  LK w9 i1           clean=0.078  bright=1.250
    large (7,4):  tk=dt3 i=2 ref=5   clean=0.128  bright=0.128
                  tk=dt3 i=1 ref=5   clean=0.188  bright=0.186
                  LK w9 i1           clean=0.317
"""

from __future__ import annotations

import dataclasses
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", ".."))

import numpy as np

import jax.numpy as jnp

from cuda_optical_flow_2_tpu import DISConfig, LKConfig, pyramidal_dis, pyramidal_lk
from cuda_optical_flow_2_tpu.utils import io


def epe(flow, dx, dy, margin):
    e = np.hypot(np.asarray(flow[..., 0]) - dx, np.asarray(flow[..., 1]) - dy)
    return float(e[margin:-margin, margin:-margin].mean())


def sweep(h, w, dx, dy, period, levels, margin):
    fr = io.synthetic_sequence(2, h, w, velocity=(dx, dy), period=period)
    prev = jnp.asarray(fr[0].astype(np.float32))
    nxt = jnp.asarray(fr[1].astype(np.float32))
    nxt_b = nxt + 25.0
    print(f"--- {h}x{w} shift ({dx},{dy}) period {period} ---")
    for tk in ("delta", "dt3"):
        for it in (1, 2, 4):
            for ref in (0, 5):
                cfg = DISConfig(levels=levels, use_pallas=False,
                                temporal_kernel=tk, iterations=it,
                                refine_iterations=ref)
                a = epe(pyramidal_dis(prev, nxt, cfg), dx, dy, margin)
                b = epe(pyramidal_dis(prev, nxt_b, cfg), dx, dy, margin)
                print(f"tk={tk:5s} i={it} ref={ref}  "
                      f"clean={a:8.4f} bright={b:8.4f}")
    lk = LKConfig(levels=levels, window=9, use_pallas=False)
    a = epe(pyramidal_lk(prev, nxt, lk), dx, dy, margin)
    b = epe(pyramidal_lk(prev, nxt_b, lk), dx, dy, margin)
    print(f"LK w9 i1            clean={a:8.4f} bright={b:8.4f}")


def main() -> None:
    sweep(96, 128, 2.0, 1.0, 16, 3, 16)
    sweep(128, 160, 7.0, 4.0, 40, 4, 24)


if __name__ == "__main__":
    from cuda_optical_flow_2_tpu.utils.profiling import enable_compile_cache

    enable_compile_cache()
    main()
