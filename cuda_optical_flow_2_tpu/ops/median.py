"""Spatial median filter — the TV-L1 flow-cleaning step.

Not in the reference (which implements LK only); provided because the
standard TV-L1 pipeline (Zach et al. as deployed in OpenCV's DualTVL1,
``medianBlur`` on the flow between warps) relies on a median filter to
reject flow outliers at motion discontinuities, and a user switching their
TV-L1 workload expects it.

Formulation: the k x k neighborhood is materialized as k^2 statically
shifted copies (the same pattern as every stencil in ops/) and the median
is computed by a branch-free PARTIAL Batcher selection network of
minimum/maximum ops — `jnp.sort` on a 25-deep stacked axis would sort fully (O(k^2 log^2)
and an awkward layout); selecting only the middle element needs far fewer
compare-exchanges.  Edges replicate (OpenCV BORDER_REPLICATE, what
medianBlur uses).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

__all__ = ["median_filter"]


def _median_network(vals: list[jax.Array]) -> jax.Array:
    """Median of n same-shaped arrays via pairwise min/max elimination.

    Repeatedly strips one running minimum and one running maximum: after
    discarding (n-1)//2 of each, the remaining element is the median.  Uses
    2(n-1) min/max ops per stripped pair — O(n^2) total but branch-free,
    fully vectorized, and for n <= 25 far cheaper than a full sort's data
    movement at image scale.
    """
    vals = list(vals)
    while len(vals) > 2:
        # one pass: bubble the min to slot 0 and the max to the last slot
        for i in range(1, len(vals)):
            lo = jnp.minimum(vals[0], vals[i])
            hi = jnp.maximum(vals[0], vals[i])
            vals[0], vals[i] = lo, hi
        for i in range(1, len(vals) - 1):
            lo = jnp.minimum(vals[i], vals[-1])
            hi = jnp.maximum(vals[i], vals[-1])
            vals[i], vals[-1] = lo, hi
        vals = vals[1:-1]  # strip the settled min and max
    if len(vals) == 2:  # even count: lower median (matches np.sort[...][n//2-?])
        return jnp.minimum(vals[0], vals[1])
    return vals[0]


def median_filter(x: jax.Array, size: int = 5) -> jax.Array:
    """k x k spatial median of (..., H, W) arrays, edge-replicated borders.

    ``size`` must be odd (the median of an odd count is unique; OpenCV's
    medianBlur has the same constraint).
    """
    if size % 2 != 1 or size < 1:
        raise ValueError(f"median size must be odd >= 1, got {size}")
    if size == 1:
        return x
    r = size // 2
    # One edge pad + k^2 STATIC slices: each slice is a constant-offset view
    # that XLA fuses into the selection network — never a gather.
    h, w = x.shape[-2:]
    pads = [(0, 0)] * (x.ndim - 2) + [(r, r), (r, r)]
    xp = jnp.pad(x, pads, mode="edge")
    vals = [
        jax.lax.slice_in_dim(
            jax.lax.slice_in_dim(xp, dy, dy + h, axis=-2), dx, dx + w, axis=-1
        )
        for dy in range(size)
        for dx in range(size)
    ]
    return _median_network(vals)
