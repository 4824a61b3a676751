"""Why dense LK trailed its anchor, and the fix: window weighting (round 4).

VERDICT r3 item 1: the flagship (dense pyramidal LK) scored 0.194 px
vs-truth on translate/smooth — the worst family on the opencv_parity
harness — and iterating made it WORSE.  This study isolates the mechanism
and measures the fix.

Findings (CPU, study cases from opencv_parity.py):

1. The iteration operator is locally contracting for uniform error
   (measured gain 0.81-0.93 per step at truth+eps), and truth is an exact
   fixed point (residual == 0 at the true integer translation).  Yet the
   full iteration diverges: EPE grows roughly linearly with iterations
   (0.086 -> 0.455 px over 8 on translate/natural).

2. The error field is SMOOTH and mid-frequency (>98% of error energy below
   |k| = 0.125 cyc/px), zero-mean — not a tail of bad pixels, not
   high-frequency noise.

3. Mechanism: the flat (box) integration window's Fourier transfer function
   has NEGATIVE sidelobes (min -0.22 for 19 taps).  The warp-and-re-solve
   update corrects flow-error components via that transfer, so components
   at scales near the window size are corrected with the WRONG SIGN —
   amplified each iteration instead of damped.  The instability grows from
   the bilinear-warp bias noise injected at fractional displacements, which
   is itself smooth at window scales.

4. Fix: any window weighting with a (near-)nonnegative transfer:
   * "tri"   = trapezoid (two iterated box passes, radii r//2 and r-r//2):
               min transfer -0.01.
   * "gauss" = truncated Gaussian, sigma = window/6: min transfer -0.002.
   Both make iterating convergent and cut the anchor cases ~5-13x:

       translate/natural it2:  box 0.105   tri 0.021   gauss 0.008  px
       translate/smooth  it2:  box 0.194   tri 0.068   gauss 0.026  px
       rotate            it2:  box 0.034   tri 0.023   gauss 0.035  px

   (Per-iteration tables printed below; the dense cv2.calcOpticalFlowPyrLK
   anchor itself scores 0.001/0.016/0.000 on these cases —
   docs/studies/opencv_parity.py.)

5. The residual ~0.01-0.03 px gap vs the cv2 anchor is NOT the
   derivative-operator pair: a matched derivative-of-smoothing set
   (Dx = {-1,0,1}/2 (x) {1,2,1}/4, It smoothed by the same 2-D kernel) was
   prototyped under the gauss window and measured slightly WORSE on every
   case (natural it2 0.0100 vs Sobel's 0.0083; smooth 0.033 vs 0.026).
   The envelope is attributed to bilinear-warp interpolation bias at
   fractional displacements + cv2's per-point convergence-tested
   iterations; documented, not pursued further.

Run: python docs/studies/lk_window_study.py          (CPU, ~3 min)
"""

from __future__ import annotations

import numpy as np


import jax.numpy as jnp  # noqa: E402

import opencv_parity as anchor_study  # noqa: E402  (same dir)

import cuda_optical_flow_2_tpu as of  # noqa: E402
from cuda_optical_flow_2_tpu.ops.window import window_weight_taps  # noqa: E402


def transfer_min(taps: np.ndarray, n: int = 512) -> float:
    """Most-negative value of the (real, centered) transfer function."""
    k = taps / taps.sum()
    w = len(taps)
    tf = np.fft.rfft(np.pad(k, (0, n - w)))
    tf = (tf * np.exp(1j * 2 * np.pi * np.fft.rfftfreq(n) * (w - 1) / 2)).real
    return float(tf.min())


def run(prev, nxt, ww: str, iterations: int) -> np.ndarray:
    cfg = of.LKConfig(
        levels=3, window=19, iterations=iterations, temporal_kernel="gauss3",
        use_pallas=False, max_displacement=8, window_weights=ww,
    )
    return np.asarray(
        of.pyramidal_lk(
            jnp.asarray(prev, jnp.float32), jnp.asarray(nxt, jnp.float32), cfg
        )
    )


def main() -> None:
    print("window transfer-function minima (the instability driver):")
    for ww in ("box", "tri", "gauss"):
        print(f"  {ww:<6} min transfer = {transfer_min(window_weight_taps(19, ww)):+.4f}")
    print()

    print(f"{'case':<26} {'weights':<7} " + "  ".join(f"it{i:<2}" for i in (1, 2, 4, 8)))
    for name, prev, nxt, truth in anchor_study.make_cases():
        for ww in ("box", "tri", "gauss"):
            row = [
                f"{anchor_study.interior_epe(run(prev, nxt, ww, it), truth):.4f}"
                for it in (1, 2, 4, 8)
            ]
            print(f"{name:<26} {ww:<7} " + "  ".join(row))

    # Error-field structure at the box config (finding 2)
    name, prev, nxt, truth = anchor_study.make_cases()[0]
    f = run(prev, nxt, "box", 2)
    m = anchor_study.MARGIN
    eu = (f - truth)[m:-m, m:-m, 0]
    F = np.fft.fft2(eu - eu.mean())
    ky = np.fft.fftfreq(eu.shape[0])[:, None]
    kx = np.fft.fftfreq(eu.shape[1])[None, :]
    hi = (np.abs(ky) > 0.125) | (np.abs(kx) > 0.125)
    frac = float((np.abs(F[hi]) ** 2).sum() / (np.abs(F) ** 2).sum())
    print(
        f"\nbox it2 error field on {name}: mean bias {eu.mean():+.4f} px, "
        f"high-frequency energy fraction {frac:.2f} (smooth, mid-scale error)"
    )


if __name__ == "__main__":
    from cuda_optical_flow_2_tpu.utils.profiling import enable_compile_cache

    enable_compile_cache()
    import sys
    import os

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    main()
