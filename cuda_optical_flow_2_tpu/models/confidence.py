"""Per-pixel flow confidence from the structure tensor (extension).

NOT in the reference (its solve divides by the raw determinant with no
validity signal, OptFlowGpu.cu:1810-1899); provided because downstream
consumers need to know WHERE dense LK is trustworthy: the smaller eigenvalue
of the windowed structure tensor G = [[sum Ix^2, sum IxIy], [sum IxIy,
sum Iy^2]] is the classic trackability measure (Shi-Tomasi "good features",
OpenCV's minEigThreshold) — ~0 in flat or single-edge (aperture-problem)
regions, large on corners/texture where the 2x2 solve is well-conditioned.

Design: gradients + one stacked windowed reduction + elementwise
eigenvalue math, all jittable; combine with
models/consistency.occlusion_mask for a motion-dependent signal.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from cuda_optical_flow_2_tpu.config import LKConfig
from cuda_optical_flow_2_tpu.ops.gradients import spatial_gradients
from cuda_optical_flow_2_tpu.ops.window import window_sum

__all__ = ["min_eigenvalue", "confidence_mask", "good_features"]


def min_eigenvalue(frame: jax.Array, config: LKConfig) -> jax.Array:
    """Smaller eigenvalue of the windowed structure tensor, per pixel.

    Args:
      frame: (..., H, W) float grayscale (the PREV frame of a pair — the
        gradients the LK solve actually uses).
      config: supplies the window size and gradient normalization.
    Returns: (..., H, W) float32, normalized by the window pixel count so the
    scale is per-pixel mean squared gradient (comparable across windows).
    """
    ix, iy = spatial_gradients(frame, normalize=config.normalize_gradients)
    sums = window_sum(jnp.stack([ix * ix, iy * iy, ix * iy]), config.window)
    s11, s22, s12 = sums[0], sums[1], sums[2]
    half_tr = 0.5 * (s11 + s22)
    rad = jnp.sqrt(0.25 * (s11 - s22) ** 2 + s12 * s12)
    return (half_tr - rad) / float(config.window * config.window)


def confidence_mask(
    frame: jax.Array, config: LKConfig, threshold: float = 1.0
) -> jax.Array:
    """Boolean mask: True where the LK solve is well-conditioned.

    ``threshold`` is in per-pixel mean-squared-gradient units (uint8-scale
    frames: ~1.0 keeps textured regions, drops flat sky/walls).
    """
    return min_eigenvalue(frame, config) >= threshold


def good_features(
    frame: jax.Array,
    config: LKConfig,
    n_points: int,
    min_distance: int = 7,
) -> tuple[jax.Array, jax.Array]:
    """Top-``n_points`` trackable corners — the goodFeaturesToTrack role.

    Seeds for the sparse tracker (``models.track_sequence`` /
    ``track_points``): local maxima of the min-eigenvalue map, non-max
    suppressed over a ``(2*min_distance+1)``-pixel square, strongest first.
    Border pixels within the gradient/window margin are excluded (their
    scores are zero-padding artifacts).  Jittable (``n_points`` static).

    Returns:
      points: (n_points, 2) float32 ``(x, y)``, strongest first.
      scores: (n_points,) float32 min-eigenvalue at each point.  When the
        image has fewer than ``n_points`` acceptable peaks the tail entries
        have score 0 — filter with ``scores > threshold`` (same units as
        :func:`confidence_mask`).
    """
    from jax import lax

    score = min_eigenvalue(frame, config)
    h, w = score.shape[-2:]
    m = config.window // 2 + 2  # gradient + window zero-pad margin
    ys, xs = jnp.mgrid[0:h, 0:w]
    interior = (ys >= m) & (ys < h - m) & (xs >= m) & (xs < w - m)
    score = jnp.where(interior, score, 0.0)
    k = 2 * min_distance + 1
    pooled = lax.reduce_window(
        score, -jnp.inf, lax.max, (k, k), (1, 1), "SAME"
    )
    peak = jnp.where((score == pooled) & (score > 0.0), score, 0.0)
    # The pooled pass lets EXACT score ties within one window both survive
    # (symmetric synthetic patterns); a greedy pass over the top candidates
    # enforces the spacing exactly.  O(cand^2) on a few hundred points.
    cand = min(4 * n_points, h * w)
    vals, idx = lax.top_k(peak.reshape(-1), cand)
    pts = jnp.stack(
        [(idx % w).astype(jnp.float32), (idx // w).astype(jnp.float32)], -1
    )

    def body(i, keep):
        cheb = jnp.max(jnp.abs(pts - pts[i]), axis=-1)
        clash = (cheb <= min_distance) & keep & (jnp.arange(cand) < i)
        return keep.at[i].set(keep[i] & ~clash.any())

    keep = lax.fori_loop(0, cand, body, vals > 0.0)
    vals = jnp.where(keep, vals, 0.0)
    # kept entries first (stable: preserves strongest-first order)
    order = jnp.argsort(~keep, stable=True)
    return pts[order][:n_points], vals[order][:n_points]
