"""Spatial (tensor-parallel) sharding for the HS/FB/TV-L1/DIS families.

Extends parallel/spatial.py's row-sharded machinery (ppermute halo exchange
under shard_map) from Lucas-Kanade to the other families, so any model
in the framework can run one frame pair across a mesh:

* **Horn-Schunck**: gradients on an exchanged band, then time-tiled Jacobi
  relaxation — each halo exchange ships ``sweep_tile`` rows and buys
  ``sweep_tile`` local sweeps (a time-tiled trapezoid: band-edge error
  propagates one row per sweep, so rows deeper than the tile stay exact and
  are all we keep).
* **Farnebäck** (image-warp formulation): polynomial expansion on an
  exchanged band (expansion halo r_poly nests inside the window halo), warp
  band, re-expansion, windowed normal equations, solve.

Exactness mirrors spatial_pyramidal_lk: structurally identical to the
unsharded XLA path away from clamp-binding displacements, with zero-padded
global borders reproduced at the mesh's top/bottom shards.  HS is
float-tight (<=5e-4 over a 3-level pyramid); FB's normal-equation chain
amplifies XLA fusion/reassociation ulps (coefficient products -> winsize^2
window sums -> determinant division) to ~1e-2 worst-case on 8-bit inputs —
per-stage diffs stay <=2e-5 up to the window sums (bisection in round 1
logs; the band warp itself is bit-exact after the global-coordinate floor
fix in ops/warp.warp_bilinear_band).
"""

from __future__ import annotations

import dataclasses
import functools
import math

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P

from cuda_optical_flow_2_tpu.constants import MASKS
from cuda_optical_flow_2_tpu.models.dis import DISConfig
from cuda_optical_flow_2_tpu.models.dis import _lk_like as dis_lk_like
from cuda_optical_flow_2_tpu.models.farneback import (
    FBConfig,
    _window as fb_window,
    fb_normal_eq_products,
    solve_normal_eqs,
)
from cuda_optical_flow_2_tpu.config import LKConfig
from cuda_optical_flow_2_tpu.models.horn_schunck import (
    _DXC,
    _DYC,
    HSConfig,
    _avg3x3,
)
from cuda_optical_flow_2_tpu.models.tvl1 import TVL1Config
from cuda_optical_flow_2_tpu.ops.conv import stencil2d
from cuda_optical_flow_2_tpu.ops.gradients import (
    SOBEL_GAIN,
    spatial_gradients,
    temporal_gradient,
)
from cuda_optical_flow_2_tpu.ops.poly_exp import poly_expansion
from cuda_optical_flow_2_tpu.ops.warp import warp_bilinear_band
from cuda_optical_flow_2_tpu.ops.window import window_sum
from cuda_optical_flow_2_tpu.parallel.spatial import (
    _crop_rows,
    _local_lk_level,
    _local_prefilter,
    _local_pyr_down,
    _local_upsample2x_flow,
    _zero_outside_global,
    halo_exchange,
    shard_map,
    validate_prefilter_shards,
)

__all__ = [
    "grid_pyramidal_flow",
    "spatial_pyramidal_flow",
    "validate_spatial_flow",
    "spatial_pyramidal_hs",
    "spatial_pyramidal_fb",
    "spatial_pyramidal_tvl1",
    "spatial_pyramidal_dis",
    "validate_spatial_hs",
    "validate_spatial_fb",
    "validate_spatial_tvl1",
    "validate_spatial_dis",
]


def _band_warp(
    nxt, flow_c, config, axis_name, n, row0, h_global, r_out, *,
    nxt_p=None, flow_p=None,
):
    """Warp a shard band by a clamped flow, returning an ``r_out``-extended
    warped band (the XLA gather warp on the band).

    ``nxt_p`` / ``flow_p`` accept pre-exchanged ``r_out + d + 2``-halo bands
    so loops over a constant frame (the TV-L1 warps loop) exchange it once.
    """
    d = int(math.ceil(config.max_displacement))
    r_img = r_out + d + 2
    if nxt_p is None:
        nxt_p = halo_exchange(nxt, r_img, r_img, axis_name, n)
    if flow_p is None:
        flow_p = halo_exchange(flow_c, r_out, r_out, axis_name, n, row_axis=-3)
    return warp_bilinear_band(
        nxt_p, flow_p, row0 - r_img, row0 - r_out, h_global
    )


# ---------------------------------------------------------------------------
# Horn-Schunck
# ---------------------------------------------------------------------------


def _local_hs_relax(
    prev: jax.Array,
    nxt: jax.Array,
    config: HSConfig,
    axis_name: str,
    n: int,
    row0,
    h_global: int,
    sweep_tile: int,
) -> jax.Array:
    """Jacobi relaxation on a row shard, ``sweep_tile`` sweeps per exchange.

    The gradient band is built once (constant across sweeps); per chunk the
    flow is exchanged with ``K = sweep_tile`` halo rows and swept K times —
    band-edge contamination travels one row per sweep, so the kept interior
    equals the unsharded result exactly.
    """
    from cuda_optical_flow_2_tpu.models.horn_schunck import _robust_eps

    robust = _robust_eps(config)
    # Under the Charbonnier penalty    # XLA twin.  Under the Charbonnier penalty the flow band carries one
    # extra halo row (the lagged weights' central-difference ring) and the
    # weights are recomputed per exchange chunk — sweep_tile is the IRLS
    # cadence, as for the DIS band twin.
    k = min(sweep_tile, config.iterations)
    kh = k + (1 if robust is not None else 0)
    rg = kh + 2
    prev_p = halo_exchange(prev, rg, rg, axis_name, n)
    nxt_p = halo_exchange(nxt, rg, rg, axis_name, n)
    ix, iy = spatial_gradients(prev_p, normalize=True)
    it = temporal_gradient(prev_p, nxt_p, config.temporal_kernel, normalize=True)
    ix = _zero_outside_global(ix, row0 - rg, h_global)
    iy = _zero_outside_global(iy, row0 - rg, h_global)
    it = _zero_outside_global(it, row0 - rg, h_global)
    # gradient band with exactly kh halo rows (the sweeps' working margin)
    ix = _crop_rows(ix, 2)
    iy = _crop_rows(iy, 2)
    it = _crop_rows(it, 2)
    denom = config.alpha**2 + ix * ix + iy * iy

    uv = jnp.zeros(prev.shape + (2,), prev.dtype)
    n_chunks = -(-config.iterations // k)
    sweeps_left = config.iterations
    for _ in range(n_chunks):
        s = min(k, sweeps_left)
        sweeps_left -= s
        uv_p = halo_exchange(uv, kh, kh, axis_name, n, row_axis=-3)
        if robust is not None:
            ed, es = robust
            u, v = uv_p[..., 0], uv_p[..., 1]
            r = ix * u + iy * v + it
            wd = ed * lax.rsqrt(r * r + ed * ed)
            g2 = (
                stencil2d(u, _DXC) ** 2
                + stencil2d(v, _DXC) ** 2
                + stencil2d(u, _DYC) ** 2
                + stencil2d(v, _DYC) ** 2
            )
            ws = es * lax.rsqrt(g2 + es * es)
            ws = _zero_outside_global(ws, row0 - kh, h_global)
            s_plane = jnp.maximum((ws + _avg3x3(ws)) * 0.5, 1e-12)
            inv_s = 1.0 / s_plane
            inv_denom = 1.0 / (
                config.alpha**2 * s_plane + wd * (ix * ix + iy * iy)
            )
            for _ in range(s):
                u_bar = (ws * _avg3x3(u) + _avg3x3(ws * u)) * 0.5 * inv_s
                v_bar = (ws * _avg3x3(v) + _avg3x3(ws * v)) * 0.5 * inv_s
                rate = wd * (ix * u_bar + iy * v_bar + it) * inv_denom
                uv_p = jnp.stack(
                    [u_bar - ix * rate, v_bar - iy * rate], axis=-1
                )
                uv_p = _zero_outside_global(
                    uv_p, row0 - kh, h_global, row_axis=-3
                )
                u, v = uv_p[..., 0], uv_p[..., 1]
            uv = _crop_rows(uv_p, kh, -3)
            continue
        for _ in range(s):
            u_bar = _avg3x3(uv_p[..., 0])
            v_bar = _avg3x3(uv_p[..., 1])
            rate = (ix * u_bar + iy * v_bar + it) / denom
            uv_p = jnp.stack(
                [u_bar - ix * rate, v_bar - iy * rate], axis=-1
            )
            # The unsharded _avg3x3's zero padding stays zero every sweep;
            # the band rows beyond the GLOBAL image must do the same (their
            # u_bar is nonzero after a sweep and would leak back inward).
            uv_p = _zero_outside_global(uv_p, row0 - k, h_global, row_axis=-3)
        uv = _crop_rows(uv_p, k, -3)
    return uv


def _hs_warp_band(nxt, flow, config, axis_name, n, row0, h_global, r_out):
    flow_c = jnp.clip(flow, -config.max_displacement, config.max_displacement)
    warped = _band_warp(
        nxt, flow_c, config, axis_name, n, row0, h_global, r_out
    )
    return flow_c, _crop_rows(warped, r_out)


def validate_spatial_hs(
    h: int, w: int, config: HSConfig, n: int, sweep_tile: int = 8
) -> None:
    validate_prefilter_shards(h, n, config, w)
    top = config.levels - 1
    if h % (n << top) or (top and w % (1 << top)):
        raise ValueError(
            f"spatial HS needs H divisible by n_shards * 2^(levels-1) "
            f"= {n << top} and W by {1 << top}; got {h}x{w}"
        )
    k = min(sweep_tile, config.iterations)
    d = int(math.ceil(config.max_displacement))
    for lvl in range(config.levels):
        hk = (h >> lvl) // n
        need = max(k + 2, 2 + d + 2 if lvl < top else 0, 2)
        if hk < need:
            raise ValueError(
                f"HS level {lvl} holds {hk} rows/shard but its halos need "
                f"{need}; reduce levels, sweep_tile, max_displacement or shards"
            )


def spatial_pyramidal_hs(
    prev: jax.Array,
    nxt: jax.Array,
    config: HSConfig,
    mesh: Mesh,
    axis_name: str = "space",
    sweep_tile: int = 8,
) -> jax.Array:
    """Pyramidal Horn-Schunck for ONE pair, rows sharded over ``mesh``.

    ``sweep_tile`` Jacobi sweeps run per halo exchange (larger = fewer
    collectives, wider halos).
    """
    h, w = prev.shape[-2:]
    n = mesh.shape[axis_name]
    validate_spatial_hs(h, w, config, n, sweep_tile)
    return _spatial_hs_jit(config, mesh, axis_name, n, h, sweep_tile)(prev, nxt)


def _local_hs_level(
    p, nx, flow, config: HSConfig, axis_name, n, row0, hg, sweep_tile
):
    """One HS pyramid level on a row shard: warp (below the coarsest) then
    banded time-tiled relaxation."""
    if flow is None:
        return _local_hs_relax(
            p, nx, config, axis_name, n, row0, hg, sweep_tile
        )
    flow, warped = _hs_warp_band(
        nx, flow, config, axis_name, n, row0, hg, 2
    )
    return flow + _local_hs_relax(
        p, warped, config, axis_name, n, row0, hg, sweep_tile
    )


@functools.lru_cache(maxsize=128)
def _spatial_hs_jit(
    config: HSConfig, mesh: Mesh, axis_name: str, n: int, h: int,
    sweep_tile: int,
):
    # Cached per (config, mesh, shape) so per-frame serving calls reuse the
    # traced/compiled program instead of retracing a fresh closure each time.
    local = _family_local(config, axis_name, n, h, sweep_tile, 0)
    fn = shard_map(
        local,
        mesh=mesh,
        in_specs=(P(axis_name, None), P(axis_name, None)),
        out_specs=P(axis_name, None, None),
    )
    return jax.jit(fn)


# ---------------------------------------------------------------------------
# Farnebäck (image-warp formulation)
# ---------------------------------------------------------------------------


def _fb_radii(config: FBConfig) -> tuple[int, int, int]:
    r_win = config.winsize // 2
    r_poly = config.poly_n // 2
    r_e = r_win + r_poly  # product band + expansion margin
    return r_win, r_poly, r_e


def _banded_expansion(frame_p, config, row0_pad, h_global):
    """Expansion of a padded band, zero outside the global image (matching
    poly_expansion's zero padding of the full frame)."""
    fz = _zero_outside_global(frame_p, row0_pad, h_global)
    return poly_expansion(fz, config.poly_n, config.poly_sigma)


def _local_fb_level(prev, nxt, flow, config, axis_name, n, row0, h_global):
    """One Farnebäck level on a row shard (image-warp formulation).

    Mirrors models/farneback.fb_level_image: the prev expansion is computed
    once on an ``r_e``-padded band; each iteration warps the next-frame band
    by the current flow, re-expands it, and solves the windowed normal
    equations, cropping back to the shard's rows.
    """
    r_win, r_poly, r_e = _fb_radii(config)
    d = int(math.ceil(config.max_displacement))
    r_img = r_e + d + 2

    prev_p = halo_exchange(prev, r_e, r_e, axis_name, n)
    exp1 = _banded_expansion(prev_p, config, row0 - r_e, h_global)
    bx1, by1, axx1, ayy1, axy1 = exp1
    # Only warping iterations need the displacement-wide image halo; a
    # coarsest level running a single iteration never warps (and
    # validate_spatial_fb only guarantees r_e rows for it).
    warps = flow is not None or config.iterations > 1
    r_nxt = r_img if warps else r_e
    nxt_p = halo_exchange(nxt, r_nxt, r_nxt, axis_name, n)

    for _ in range(config.iterations):
        if flow is None:
            w_exp = _banded_expansion(
                _crop_rows(nxt_p, r_nxt - r_e), config, row0 - r_e, h_global
            )
            u = v = jnp.zeros_like(bx1)
        else:
            flow = jnp.clip(
                flow, -config.max_displacement, config.max_displacement
            )
            flow_p = halo_exchange(flow, r_e, r_e, axis_name, n, row_axis=-3)
            warped = _band_warp(
                nxt, flow, config, axis_name, n, row0, h_global, r_e,
                nxt_p=nxt_p, flow_p=flow_p,
            )
            w_exp = _banded_expansion(warped, config, row0 - r_e, h_global)
            u, v = flow_p[..., 0], flow_p[..., 1]
        prods = jnp.stack(list(fb_normal_eq_products(exp1, w_exp, u, v)))
        # The expansion band's outer r_poly rows are contaminated by its own
        # zero padding; they sit outside the window reach of the kept rows,
        # but the window sum must not read them either — zero them, exactly
        # like the full-image path's zero padding beyond the image.
        prods = _zero_outside_global(
            _crop_rows(prods, r_poly), row0 - r_win, h_global
        )
        # fb_window = the unsharded window dispatch: box window_sum, or the
        # separable Gaussian when config.gaussian_window — both are
        # band-local stencils with the same r_win halo, so TP supports both.
        sums = fb_window(prods, config)
        flow = _crop_rows(
            solve_normal_eqs(sums, config.det_eps), r_win, -3
        )
    return flow


def validate_spatial_fb(h: int, w: int, config: FBConfig, n: int) -> None:
    validate_prefilter_shards(h, n, config, w)
    if config.warp_planes != "image":
        raise NotImplementedError(
            "spatial FB implements the image-warp formulation "
            "(warp_planes='image'); the coefficient-warp form would "
            "silently diverge from pyramidal_farneback"
        )
    top = config.levels - 1
    if h % (n << top) or (top and w % (1 << top)):
        raise ValueError(
            f"spatial FB needs H divisible by n_shards * 2^(levels-1) "
            f"= {n << top} and W by {1 << top}; got {h}x{w}"
        )
    _, _, r_e = _fb_radii(config)
    r_img = r_e + int(math.ceil(config.max_displacement)) + 2
    for lvl in range(config.levels):
        hk = (h >> lvl) // n
        # every level past the coarsest warps (needs r_img); the coarsest
        # only expands/windows (r_e), but iterations > 1 warp there too
        warps = lvl < top or config.iterations > 1
        need = max(r_img if warps else r_e, 2)
        if hk < need:
            raise ValueError(
                f"FB level {lvl} holds {hk} rows/shard but its halos need "
                f"{need}; reduce levels, winsize, max_displacement or shards"
            )


def spatial_pyramidal_fb(
    prev: jax.Array,
    nxt: jax.Array,
    config: FBConfig,
    mesh: Mesh,
    axis_name: str = "space",
) -> jax.Array:
    """Pyramidal Farnebäck for ONE pair, rows sharded over ``mesh``."""
    h, w = prev.shape[-2:]
    n = mesh.shape[axis_name]
    validate_spatial_fb(h, w, config, n)
    return _spatial_fb_jit(config, mesh, axis_name, n, h)(prev, nxt)


@functools.lru_cache(maxsize=128)
def _spatial_fb_jit(
    config: FBConfig, mesh: Mesh, axis_name: str, n: int, h: int,
):
    local = _family_local(config, axis_name, n, h, 0, 0)
    fn = shard_map(
        local,
        mesh=mesh,
        in_specs=(P(axis_name, None), P(axis_name, None)),
        out_specs=P(axis_name, None, None),
    )
    return jax.jit(fn)


# ---------------------------------------------------------------------------
# TV-L1 (image-warp, primal-dual) — time-tiled exchanges with carried duals
# ---------------------------------------------------------------------------


def _tvl1_constants(prev_p, warped_p, u0u, u0v, row0_pad, h_global, config):
    """Per-warp linearization constants on a band (gradients masked to the
    global image).  Computed on a band 2 rows wider than the iteration band
    so the Sobel ring's band-edge error never reaches the kept rows."""
    h_b, w = prev_p.shape[-2:]
    rows = jnp.arange(h_b).reshape(-1, 1) + row0_pad
    inside = (rows >= 0) & (rows < h_global)
    zero = jnp.zeros((h_b, w), prev_p.dtype)
    gx, gy = spatial_gradients(warped_p, normalize=True)
    gx = jnp.where(inside, gx, zero)
    gy = jnp.where(inside, gy, zero)
    g2 = gx * gx + gy * gy
    inv_g2s = 1.0 / jnp.maximum(g2, config.epsilon)
    lt = config.lambda_ * config.theta
    th = lt * g2
    itp = warped_p - prev_p - u0u * gx - u0v * gy
    return gx, gy, itp, th, inv_g2s


def _tvl1_pd_band(consts, state, row0_pad, h_global, config, iters):
    """``iters`` primal-dual steps on a row band, global-edge-exact.

    The band's Neumann boundaries must sit at the GLOBAL image edges, not the
    band edges: forward differences are masked to zero at the last global
    row/column (which keeps the dual planes zero there, making the roll-free
    backward divergence reproduce the unsharded special cases).  Band-edge staleness advances one row
    per iteration and is cropped by the caller's trapezoid.
    """
    gx, gy, itp, th, inv_g2s = consts
    h_b, w = gx.shape[-2:]
    rows = jnp.arange(h_b).reshape(-1, 1) + row0_pad
    cols = jnp.arange(w).reshape(1, -1)
    inside = (rows >= 0) & (rows < h_global)
    fd_ok_y = inside & (rows < h_global - 1)
    fd_ok_x = inside & (cols < w - 1)
    zero = jnp.zeros((h_b, w), gx.dtype)
    lt = config.lambda_ * config.theta
    tt = config.tau / config.theta

    def shift(x, d, axis):
        # out[i] = x[i + d], zero-filled (pad-and-slice, no wrap)
        pads = [(0, 0)] * x.ndim
        pads[axis % x.ndim] = (max(-d, 0), max(d, 0))
        xp = jnp.pad(x, pads)
        start = max(d, 0)
        return jax.lax.slice_in_dim(xp, start, start + x.shape[axis], axis=axis)

    def fd_x(x):
        return jnp.where(fd_ok_x, shift(x, 1, -1) - x, zero)

    def fd_y(x):
        return jnp.where(fd_ok_y, shift(x, 1, -2) - x, zero)

    def div(px, py):
        return (px - shift(px, -1, -1)) + (py - shift(py, -1, -2))

    u, v, p1x, p1y, p2x, p2y = state
    for _ in range(iters):
        rho = itp + u * gx + v * gy
        du = jnp.where(rho < -th, lt * gx,
                       jnp.where(rho > th, -lt * gx, -rho * gx * inv_g2s))
        dv = jnp.where(rho < -th, lt * gy,
                       jnp.where(rho > th, -lt * gy, -rho * gy * inv_g2s))
        u = jnp.where(inside, u + du + config.theta * div(p1x, p1y), zero)
        v = jnp.where(inside, v + dv + config.theta * div(p2x, p2y), zero)
        ux, uy = fd_x(u), fd_y(u)
        vx, vy = fd_x(v), fd_y(v)
        nu = 1.0 + tt * jnp.sqrt(ux * ux + uy * uy)
        nv = 1.0 + tt * jnp.sqrt(vx * vx + vy * vy)
        p1x = (p1x + tt * ux) / nu
        p1y = (p1y + tt * uy) / nu
        p2x = (p2x + tt * vx) / nv
        p2y = (p2y + tt * vy) / nv
    return u, v, p1x, p1y, p2x, p2y


def _local_tvl1_level(prev, nxt, flow, config, axis_name, n, row0, h_global,
                      iter_tile):
    """One TV-L1 level on a row shard: per-warp banded relinearizations with
    time-tiled primal-dual chunks (``iter_tile`` iterations per exchange).
    """
    k = min(iter_tile, config.iterations)
    rg = k + 2
    d = int(math.ceil(config.max_displacement))
    r_img = rg + d + 2

    prev_p = halo_exchange(prev, rg, rg, axis_name, n)
    # the next frame is constant across warps: exchange its warp band ONCE
    nxt_pw = halo_exchange(nxt, r_img, r_img, axis_name, n)
    if flow is None:
        flow = jnp.zeros(prev.shape + (2,), prev.dtype)

    for _ in range(config.warps):
        flow = jnp.clip(flow, -config.max_displacement, config.max_displacement)
        flow_p = halo_exchange(flow, rg, rg, axis_name, n, row_axis=-3)
        warped_p = _band_warp(
            nxt, flow, config, axis_name, n, row0, h_global, rg,
            nxt_p=nxt_pw, flow_p=flow_p,
        )
        u0u, u0v = flow_p[..., 0], flow_p[..., 1]
        # Linearization constants on the full rg band (Sobel ring stays 2
        # rows clear of the iteration band), then cropped to the k band.
        consts_f = _tvl1_constants(
            prev_p, warped_p, u0u, u0v, row0 - rg, h_global, config
        )
        # rg - k == 2: drop the Sobel-ring margin rows.
        consts = tuple(_crop_rows(x, rg - k, -2) for x in consts_f)
        # time-tiled primal-dual: duals carried between chunks
        zl = jnp.zeros_like(prev)
        state_loc = (flow[..., 0], flow[..., 1], zl, zl, zl, zl)
        n_chunks = -(-config.iterations // k)
        left = config.iterations
        for _c in range(n_chunks):
            s = min(k, left)
            left -= s
            stacked = halo_exchange(
                jnp.stack(state_loc), k, k, axis_name, n, row_axis=-2
            )
            state_b = tuple(stacked[i] for i in range(6))
            state_b = _tvl1_pd_band(
                consts, state_b, row0 - k, h_global, config, s,
            )
            state_loc = tuple(_crop_rows(x, k, -2) for x in state_b)
        flow = jnp.stack([state_loc[0], state_loc[1]], axis=-1)
        if config.median_filtering > 1:
            # Shard-local median: edge-replicated halo reproduces OpenCV's
            # BORDER_REPLICATE at the mesh's global top/bottom shards;
            # interior shards see true neighbor rows.
            from cuda_optical_flow_2_tpu.ops.median import median_filter

            rm = config.median_filtering // 2
            planes = jnp.stack([flow[..., 0], flow[..., 1]])
            planes = halo_exchange(
                planes, rm, rm, axis_name, n, row_axis=-2, boundary="edge"
            )
            planes = _crop_rows(
                median_filter(planes, config.median_filtering), rm, -2
            )
            flow = jnp.stack([planes[0], planes[1]], axis=-1)
    return flow


def validate_spatial_tvl1(
    h: int, w: int, config, n: int, iter_tile: int = 8
) -> None:
    validate_prefilter_shards(h, n, config, w)
    top = config.levels - 1
    if h % (n << top) or (top and w % (1 << top)):
        raise ValueError(
            f"spatial TV-L1 needs H divisible by n_shards * 2^(levels-1) "
            f"= {n << top} and W by {1 << top}; got {h}x{w}"
        )
    k = min(iter_tile, config.iterations)
    d = int(math.ceil(config.max_displacement))
    # the per-warp median filter exchanges window//2 edge-replicated rows
    need = max(k + 2 + d + 2, config.median_filtering // 2)
    for lvl in range(config.levels):
        hk = (h >> lvl) // n
        if hk < need:
            raise ValueError(
                f"TV-L1 level {lvl} holds {hk} rows/shard but its halos "
                f"need {need}; reduce levels, iter_tile, max_displacement, "
                f"median_filtering or shards"
            )


def spatial_pyramidal_tvl1(
    prev: jax.Array,
    nxt: jax.Array,
    config,
    mesh: Mesh,
    axis_name: str = "space",
    iter_tile: int = 8,
) -> jax.Array:
    """Pyramidal TV-L1 for ONE pair, rows sharded over ``mesh``.

    ``iter_tile`` primal-dual iterations run per halo exchange.
    """
    h, w = prev.shape[-2:]
    n = mesh.shape[axis_name]
    validate_spatial_tvl1(h, w, config, n, iter_tile)
    return _spatial_tvl1_jit(config, mesh, axis_name, n, h, iter_tile)(prev, nxt)


@functools.lru_cache(maxsize=128)
def _spatial_tvl1_jit(
    config, mesh: Mesh, axis_name: str, n: int, h: int, iter_tile: int,
):
    local = _family_local(config, axis_name, n, h, 0, iter_tile)
    fn = shard_map(
        local,
        mesh=mesh,
        in_specs=(P(axis_name, None), P(axis_name, None)),
        out_specs=P(axis_name, None, None),
    )
    return jax.jit(fn)


# ---------------------------------------------------------------------------
# DIS (mean-normalized inverse search + variational refinement)
# ---------------------------------------------------------------------------


def _dis_lk_like(config: DISConfig) -> "LKConfig":
    """LKConfig view of a DISConfig with the search iteration count folded
    in, so spatial._local_lk_level runs the whole per-level search loop."""
    return dataclasses.replace(
        dis_lk_like(config), iterations=config.iterations
    )


def _local_dis_refine(
    prev: jax.Array,
    nxt: jax.Array,
    flow: jax.Array,
    config: DISConfig,
    axis_name: str,
    n: int,
    row0,
    h_global: int,
    sweep_tile: int,
) -> jax.Array:
    """Variational refinement on a row shard (models/dis._refine's TP twin).

    The linearization offset ``-(ix*u0 + iy*v0) - win_mean(it_warped)`` is
    computed once on an ``rp``-extended band (``rp = rg + window//2 + 1``
    rows: the relax halo ``rg = k + 2`` plus the mean-normalization window
    and temporal-stencil margins), with gradients zeroed outside the GLOBAL
    image and the count plane restricted to in-global rows — exactly the
    unsharded centering.  Then ``k``-sweep chunks relax the total flow per
    halo exchange.
    """
    if config.refine_iterations <= 0:
        return flow
    lk_like = _dis_lk_like(config)
    k = min(sweep_tile, config.refine_iterations)
    rg = k + 2
    m = (config.window // 2 + 1) if config.mean_normalize else 1
    rp = rg + m

    flow_c = jnp.clip(flow, -config.max_displacement, config.max_displacement)
    warped_p = _band_warp(
        nxt, flow_c, lk_like, axis_name, n, row0, h_global, rp
    )
    prev_p = halo_exchange(prev, rp, rp, axis_name, n)
    flow_p = halo_exchange(flow_c, rp, rp, axis_name, n, row_axis=-3)

    sscale = 1.0 / SOBEL_GAIN
    ix = stencil2d(prev_p, MASKS["sobel_x"] * sscale)
    iy = stencil2d(prev_p, MASKS["sobel_y"] * sscale)
    ix = _zero_outside_global(ix, row0 - rp, h_global)
    iy = _zero_outside_global(iy, row0 - rp, h_global)
    off = -(ix * flow_p[..., 0] + iy * flow_p[..., 1])
    tmask = MASKS[config.temporal_kernel]
    it_w = stencil2d(warped_p - prev_p, tmask / tmask.sum())
    it_w = _zero_outside_global(it_w, row0 - rp, h_global)
    if config.mean_normalize:
        valid = _zero_outside_global(
            jnp.ones_like(it_w), row0 - rp, h_global
        )
        counts = window_sum(valid, config.window, "cumsum")
        off = off - window_sum(it_w, config.window, "cumsum") / jnp.maximum(
            counts, 1.0
        )
    off = _zero_outside_global(off, row0 - rp, h_global)

    uv = flow_c
    n_chunks = -(-config.refine_iterations // k)
    sweeps_left = config.refine_iterations
    robust = (
        (config.refine_eps_data, config.refine_eps_smooth)
        if config.refine_penalty == "charbonnier"
        else None
    )

    # k-halo gradient bands    # XLA twin: k-halo gradient bands (k+1 under the Charbonnier penalty —
    # the lagged weights' central-difference ring needs chunk-start flow
    # one row beyond the sweep trapezoid), data term constant across
    # sweeps, weights recomputed per chunk (models/dis._robust_relax_xla
    # semantics on a band).
    kh = k + (1 if robust is not None else 0)
    ck = rp - kh
    ixk = _crop_rows(ix, ck)
    iyk = _crop_rows(iy, ck)
    itk = _crop_rows(it_w, ck) + _crop_rows(off, ck)
    alpha2 = config.refine_alpha**2
    denom = alpha2 + ixk * ixk + iyk * iyk
    for _ in range(n_chunks):
        s = min(k, sweeps_left)
        sweeps_left -= s
        uv_p = halo_exchange(uv, kh, kh, axis_name, n, row_axis=-3)
        if robust is not None:
            ed, es = robust
            u, v = uv_p[..., 0], uv_p[..., 1]
            r = ixk * u + iyk * v + itk
            wd = ed * lax.rsqrt(r * r + ed * ed)
            g2 = (
                stencil2d(u, _DXC) ** 2
                + stencil2d(v, _DXC) ** 2
                + stencil2d(u, _DYC) ** 2
                + stencil2d(v, _DYC) ** 2
            )
            ws = es * lax.rsqrt(g2 + es * es)
            ws = _zero_outside_global(ws, row0 - kh, h_global)
            s_plane = jnp.maximum((ws + _avg3x3(ws)) * 0.5, 1e-12)
            inv_s = 1.0 / s_plane
            inv_denom = 1.0 / (alpha2 * s_plane + wd * (ixk * ixk + iyk * iyk))
            for _ in range(s):
                u_bar = (ws * _avg3x3(u) + _avg3x3(ws * u)) * 0.5 * inv_s
                v_bar = (ws * _avg3x3(v) + _avg3x3(ws * v)) * 0.5 * inv_s
                rate = wd * (ixk * u_bar + iyk * v_bar + itk) * inv_denom
                uv_p = jnp.stack([u_bar - ixk * rate, v_bar - iyk * rate], -1)
                uv_p = _zero_outside_global(
                    uv_p, row0 - kh, h_global, row_axis=-3
                )
                u, v = uv_p[..., 0], uv_p[..., 1]
        else:
            for _ in range(s):
                u_bar = _avg3x3(uv_p[..., 0])
                v_bar = _avg3x3(uv_p[..., 1])
                rate = (ixk * u_bar + iyk * v_bar + itk) / denom
                uv_p = jnp.stack(
                    [u_bar - ixk * rate, v_bar - iyk * rate], axis=-1
                )
                uv_p = _zero_outside_global(
                    uv_p, row0 - k, h_global, row_axis=-3
                )
        uv = _crop_rows(uv_p, kh, -3)
    return uv


def _local_dis_level(
    prev, nxt, flow, config: DISConfig, axis_name, n, row0, h_global,
    sweep_tile,
):
    """One DIS pyramid level on a row shard: centered inverse-search steps
    (spatial._local_lk_level with ``centered=mean_normalize`` — the
    centered banded residual) followed by the banded variational
    refinement."""
    flow = _local_lk_level(
        prev, nxt, flow, _dis_lk_like(config), axis_name, n, h_global,
        centered=config.mean_normalize,
    )
    return _local_dis_refine(
        prev, nxt, flow, config, axis_name, n, row0, h_global, sweep_tile
    )


def validate_spatial_dis(
    h: int, w: int, config: DISConfig, n: int, sweep_tile: int = 8
) -> None:
    validate_prefilter_shards(h, n, config, w)
    top = config.levels - 1
    if h % (n << top) or (top and w % (1 << top)):
        raise ValueError(
            f"spatial DIS needs H divisible by n_shards * 2^(levels-1) "
            f"= {n << top} and W by {1 << top}; got {h}x{w}"
        )
    r_grad = config.window // 2 + 2
    d = int(math.ceil(config.max_displacement))
    r_img = r_grad + d + 2
    r_refine = 0
    if config.refine_iterations > 0:
        k = min(sweep_tile, config.refine_iterations)
        m = (config.window // 2 + 1) if config.mean_normalize else 1
        # the refine warp exchanges rp + d + 2 rows in one hop
        r_refine = (k + 2 + m) + d + 2
    for lvl in range(config.finest_level, config.levels):
        warps = lvl < top or config.iterations > 1
        hk = (h >> lvl) // n
        need = max(r_img if warps else r_grad, r_refine, 2)
        if hk < need:
            raise ValueError(
                f"DIS level {lvl} holds {hk} rows/shard but its halos need "
                f"{need}; reduce levels, window, refine sweeps, "
                f"max_displacement or shards"
            )


def spatial_pyramidal_dis(
    prev: jax.Array,
    nxt: jax.Array,
    config: DISConfig,
    mesh: Mesh,
    axis_name: str = "space",
    sweep_tile: int = 8,
) -> jax.Array:
    """Pyramidal DIS for ONE pair, rows sharded over ``mesh``.

    ``sweep_tile`` refinement sweeps run per halo exchange.  Levels below
    ``config.finest_level`` are never solved; the flow upsamples the rest of
    the way shard-locally (the unsharded finest-scale knob).

    Under ``refine_penalty="charbonnier"`` the chunk size is SEMANTIC (the
    lagged weights recompute once per chunk), so ``sweep_tile`` also sets
    the IRLS cadence; the unsharded path recomputes every
    ``min(horn_schunck.ROBUST_CHUNK, refine_iterations)`` sweeps — pass
    ``sweep_tile`` >= that for exact structural parity (automatic whenever
    ``refine_iterations <= sweep_tile``).  The quadratic penalty is
    cadence-invariant.
    """
    h, w = prev.shape[-2:]
    n = mesh.shape[axis_name]
    validate_spatial_dis(h, w, config, n, sweep_tile)
    return _spatial_dis_jit(config, mesh, axis_name, n, h, sweep_tile)(prev, nxt)


@functools.lru_cache(maxsize=128)
def _spatial_dis_jit(
    config: DISConfig, mesh: Mesh, axis_name: str, n: int, h: int,
    sweep_tile: int,
):
    local = _family_local(config, axis_name, n, h, sweep_tile, 0)
    fn = shard_map(
        local,
        mesh=mesh,
        in_specs=(P(axis_name, None), P(axis_name, None)),
        out_specs=P(axis_name, None, None),
    )
    return jax.jit(fn)


# ---------------------------------------------------------------------------
# Generic shard-local pipeline + combined DP x TP for every family
# ---------------------------------------------------------------------------


def _local_family_pipeline(
    prev_blk, nxt_blk, config, axis_name, n, h, level_fn, finest_level=0
):
    """The shared per-shard pipeline skeleton every family instantiates:
    optional banded prefilter -> shard-local pyramids -> coarse-to-fine with
    ``level_fn(p, nx, flow, row0, h_level)`` per solved level -> remaining
    2x upsamples (DIS's finest_level knob; 0 for the other families)."""
    from jax import lax

    if config.prefilter is not None:
        prev_blk = _local_prefilter(prev_blk, config, axis_name, n, h)
        nxt_blk = _local_prefilter(nxt_blk, config, axis_name, n, h)
    prev_pyr, next_pyr = [prev_blk], [nxt_blk]
    for _ in range(1, config.levels):
        prev_pyr.append(_local_pyr_down(prev_pyr[-1], axis_name, n))
        next_pyr.append(_local_pyr_down(next_pyr[-1], axis_name, n))
    flow = None
    for k in range(config.levels - 1, finest_level - 1, -1):
        p, nx = prev_pyr[k], next_pyr[k]
        hloc = p.shape[-2]
        row0 = lax.axis_index(axis_name) * hloc
        if flow is not None:
            flow = _local_upsample2x_flow(flow, axis_name, n)
        flow = level_fn(p, nx, flow, row0, h >> k)
    for _ in range(finest_level):
        flow = _local_upsample2x_flow(flow, axis_name, n)
    return flow


def _family_local(config, axis_name, n, h, sweep_tile, iter_tile):
    """Shard-local pipeline fn for a config's model family.

    The single dispatch point behind every spatial_pyramidal_* entry and
    :func:`grid_pyramidal_flow`.
    """
    if isinstance(config, HSConfig):
        def level_fn(p, nx, flow, row0, hg):
            return _local_hs_level(
                p, nx, flow, config, axis_name, n, row0, hg, sweep_tile
            )
    elif isinstance(config, FBConfig):
        def level_fn(p, nx, flow, row0, hg):
            return _local_fb_level(
                p, nx, flow, config, axis_name, n, row0, hg
            )
    elif isinstance(config, TVL1Config):
        def level_fn(p, nx, flow, row0, hg):
            return _local_tvl1_level(
                p, nx, flow, config, axis_name, n, row0, hg, iter_tile
            )
    elif isinstance(config, DISConfig):
        def level_fn(p, nx, flow, row0, hg):
            return _local_dis_level(
                p, nx, flow, config, axis_name, n, row0, hg, sweep_tile
            )
    elif isinstance(config, LKConfig):
        from cuda_optical_flow_2_tpu.parallel.spatial import _local_pipeline

        def local(prev_blk, nxt_blk):
            return _local_pipeline(prev_blk, nxt_blk, config, axis_name, n, h)

        return local
    else:
        raise TypeError(
            f"config must be an LKConfig / HSConfig / FBConfig / TVL1Config "
            f"/ DISConfig instance; got "
            f"{type(config).__module__}.{type(config).__qualname__}"
        )

    finest = getattr(config, "finest_level", 0)

    def local(prev_blk, nxt_blk):
        return _local_family_pipeline(
            prev_blk, nxt_blk, config, axis_name, n, h, level_fn, finest
        )

    return local


def validate_spatial_flow(
    h: int, w: int, config, n: int, sweep_tile: int = 8, iter_tile: int = 8
) -> None:
    """Model-generic spatial validation (dispatches on the config type)."""
    from cuda_optical_flow_2_tpu.parallel.spatial import validate_spatial

    if isinstance(config, HSConfig):
        validate_spatial_hs(h, w, config, n, sweep_tile)
    elif isinstance(config, FBConfig):
        validate_spatial_fb(h, w, config, n)
    elif isinstance(config, TVL1Config):
        validate_spatial_tvl1(h, w, config, n, iter_tile)
    elif isinstance(config, DISConfig):
        validate_spatial_dis(h, w, config, n, sweep_tile)
    else:
        validate_spatial(h, w, config, n)


def spatial_pyramidal_flow(
    prev: jax.Array,
    nxt: jax.Array,
    config,
    mesh: Mesh,
    axis_name: str = "space",
    sweep_tile: int = 8,
    iter_tile: int = 8,
) -> jax.Array:
    """Model-generic spatial TP: dispatch on the config type (the TP
    counterpart of models.pyramidal_flow)."""
    from cuda_optical_flow_2_tpu.parallel.spatial import spatial_pyramidal_lk

    if isinstance(config, HSConfig):
        return spatial_pyramidal_hs(prev, nxt, config, mesh, axis_name,
                                    sweep_tile)
    if isinstance(config, FBConfig):
        return spatial_pyramidal_fb(prev, nxt, config, mesh, axis_name)
    if isinstance(config, TVL1Config):
        return spatial_pyramidal_tvl1(prev, nxt, config, mesh, axis_name,
                                      iter_tile)
    if isinstance(config, DISConfig):
        return spatial_pyramidal_dis(prev, nxt, config, mesh, axis_name,
                                     sweep_tile)
    return spatial_pyramidal_lk(prev, nxt, config, mesh, axis_name)


def grid_pyramidal_flow(
    prev_batch: jax.Array,
    nxt_batch: jax.Array,
    config,
    mesh: Mesh,
    batch_axis: str = "batch",
    space_axis: str = "space",
    sweep_tile: int = 8,
    iter_tile: int = 8,
) -> jax.Array:
    """Combined DP x TP for ANY model family: a frame-pair batch sharded
    over a 2-D mesh, batch-data-parallel x row-sharded with ppermute halo
    exchange (the model-generic form of spatial.grid_pyramidal_lk).

    Args:
      prev_batch / nxt_batch: (B, H, W), B divisible by the batch axis size,
        H by space-size * 2^(levels-1).
    Returns: (B, H, W, 2) flow, sharded the same way.
    """
    b, h, w = prev_batch.shape[-3:]
    nb = mesh.shape[batch_axis]
    ns = mesh.shape[space_axis]
    if b % nb != 0:
        raise ValueError(f"batch {b} not divisible by {batch_axis} size {nb}")
    validate_spatial_flow(h, w, config, ns, sweep_tile, iter_tile)
    return _grid_flow_jit(
        config, mesh, batch_axis, space_axis, ns, h, sweep_tile, iter_tile
    )(prev_batch, nxt_batch)


@functools.lru_cache(maxsize=128)
def _grid_flow_jit(
    config, mesh: Mesh, batch_axis: str, space_axis: str, ns: int, h: int,
    sweep_tile: int, iter_tile: int,
):
    local = _family_local(
        config, space_axis, ns, h, sweep_tile, iter_tile
    )

    def batched(pb, nb):
        return jax.vmap(local)(pb, nb)

    fn = shard_map(
        batched,
        mesh=mesh,
        in_specs=(P(batch_axis, space_axis, None),) * 2,
        out_specs=P(batch_axis, space_axis, None, None),
    )
    return jax.jit(fn)
