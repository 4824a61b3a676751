"""Per-stage A/B debugging: run any pipeline stage through multiple backends
and diff the results.

The productized form of the reference's comment-swap workflow: main.cu keeps
a commented-out CPU twin next to every GPU call site (main.cu:199, 239, 248,
261) so a developer can swap one stage at a time and eyeball the difference.
Here the same bisection is one call: :func:`stage_report` runs each stage of
the selected model family through the requested backends from IDENTICAL
canonical inputs and reports per-stage max/mean absolute differences — the
tool that round-1 tolerance hunts (e.g. the spatial-FB 1e-2 bound,
tests/test_parallel.py) had to do by hand in study scripts.

Backends:

* ``"xla"``     — the pure-XLA ops (``use_pallas=False``); the default
  comparison baseline.
* ``"pallas"``  — the hand-written kernel (the fused LK residual,
  kernels/lk_fused.py): compiled on the GPU, in interpret mode elsewhere.
  The per-level and end-to-end rows take it only on the GPU, where the
  model dispatch really routes to it.
* ``"banded"``  — the spatial-TP shard-local math, emulated in-process: rows
  are split into ``n_bands`` bands, each stage runs on a halo-extended band
  (halo rows sliced from the full array — exactly what ``ppermute`` halo
  exchange delivers to interior shards; zero/edge filled at the global
  border, matching ``parallel.spatial.halo_exchange``), then cropped and
  concatenated.  Decomposes a sharded-vs-unsharded mismatch into the stage
  that introduces it WITHOUT needing a device mesh.
* ``"oracle"``  — the NumPy float twins (oracle/gpu_reference), where a twin
  of the stage exists (the Lucas-Kanade residual stages).

Stages that a backend cannot isolate (e.g. gradients inside the fused
kernel, or any stage of a family without a kernel) are skipped for that
backend, not faked.

CLI: ``python -m cuda_optical_flow_2_tpu.cli.diff --model fb --size 256x64``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np

import jax
import jax.numpy as jnp

__all__ = ["StageDiff", "stage_report", "format_report", "stages_for", "banded"]


@dataclasses.dataclass(frozen=True)
class StageDiff:
    """One (stage, backend-vs-baseline) comparison at one pyramid level."""

    level: int
    stage: str
    backend: str
    baseline: str
    max_abs: float
    mean_abs: float
    shape: tuple[int, ...]

    def __str__(self) -> str:
        lvl = "E2E" if self.level < 0 else f"L{self.level}"
        return (
            f"{lvl:<3} {self.stage:<12} {self.backend:>7} vs "
            f"{self.baseline}: max {self.max_abs:.3e}  mean "
            f"{self.mean_abs:.3e}  {self.shape}"
        )


# ---------------------------------------------------------------------------
# Band emulation (the "banded" backend)
# ---------------------------------------------------------------------------


def _extend_band(x, lo: int, hi: int, halo: int, row_axis: int = -2):
    """Rows [lo-halo, hi+halo) of ``x``, zero-filling beyond the image like
    parallel.spatial.halo_exchange does at the mesh boundary (the banded
    warp's clamped-sampling semantics come from warp_bilinear_band's
    global-valid logic, not from the fill)."""
    h = x.shape[row_axis]
    a, b = max(lo - halo, 0), min(hi + halo, h)
    band = jax.lax.slice_in_dim(x, a, b, axis=row_axis)
    pad_top, pad_bot = a - (lo - halo), (hi + halo) - b
    if pad_top or pad_bot:
        pads = [(0, 0)] * x.ndim
        pads[row_axis % x.ndim] = (pad_top, pad_bot)
        band = jnp.pad(band, pads)
    return band


def _band_bounds(h: int, n_bands: int) -> list[tuple[int, int]]:
    if h % n_bands:
        raise ValueError(f"{h} rows not divisible into {n_bands} bands")
    k = h // n_bands
    return [(i * k, (i + 1) * k) for i in range(n_bands)]


def banded(fn: Callable, halo: int, n_bands: int, row_axis: int = -2,
           out_row_axis: int | None = None):
    """Lift ``fn(*arrays) -> array|tuple`` to run band-by-band with halos.

    ``fn`` must be a stencil of radius <= ``halo`` rows: each output row
    depends only on input rows within ``halo``.  Then the banded result is
    exactly the sharded result (interior shards see neighbor rows; border
    shards see the boundary fill).  ``out_row_axis`` locates the row axis of
    the outputs when it differs from the inputs' (e.g. image -> flow adds a
    trailing component axis: row_axis=-2, out_row_axis=-3)."""
    oax = row_axis if out_row_axis is None else out_row_axis

    def run(*arrays):
        h = arrays[0].shape[row_axis]
        outs = None
        for lo, hi in _band_bounds(h, n_bands):
            bands = [
                _extend_band(a, lo, hi, halo, row_axis)
                for a in arrays
            ]
            res = fn(*bands)
            tup = res if isinstance(res, tuple) else (res,)
            cropped = [
                jax.lax.slice_in_dim(r, halo, r.shape[oax] - halo, axis=oax)
                if halo
                else r
                for r in tup
            ]
            if outs is None:
                outs = [[c] for c in cropped]
            else:
                for o, c in zip(outs, cropped):
                    o.append(c)
        cat = [jnp.concatenate(o, axis=oax) for o in outs]
        return tuple(cat) if len(cat) > 1 else cat[0]

    return run


# ---------------------------------------------------------------------------
# Stage definitions
# ---------------------------------------------------------------------------


def _interpret() -> bool:
    """Kernels compile for the GPU and run interpreted everywhere else."""
    return jax.default_backend() != "gpu"


def _with_kernel(config, backend: str):
    """``config`` for a whole-level/pipeline row of ``backend``, or None.

    The "pallas" rows exist only on the GPU (elsewhere the dispatch runs
    the XLA twin, so the row would diff XLA against itself) and only for
    families whose config selects the kernel.
    """
    if backend == "xla":
        if hasattr(config, "use_pallas"):
            return dataclasses.replace(config, use_pallas=False)
        return config
    if backend == "pallas" and not _interpret() and hasattr(config, "use_pallas"):
        return dataclasses.replace(config, use_pallas=True)
    return None


def _make_warp_stage(nxt_l, clamped, config, n_bands):
    """Shared 'warp' stage runner (LK and FB use the identical stage)."""

    def warp(backend):
        if backend == "xla":
            from cuda_optical_flow_2_tpu.ops.warp import warp_bilinear

            return warp_bilinear(nxt_l, clamped)
        if backend == "banded":
            from cuda_optical_flow_2_tpu.ops.warp import warp_bilinear_band

            halo = int(np.ceil(config.max_displacement)) + 2
            h = nxt_l.shape[-2]
            outs = []
            for lo, hi in _band_bounds(h, n_bands):
                nb = _extend_band(nxt_l, lo, hi, halo)
                fb = _extend_band(clamped, lo, hi, 0, row_axis=-3)
                outs.append(warp_bilinear_band(nb, fb, lo - halo, lo, h))
            return jnp.concatenate(outs, axis=-2)
        return None

    return warp


def _guarded_solve_np(sums, det_eps: float) -> np.ndarray:
    """NumPy float twin of ops/solve.solve_2x2 (guarded Cramer)."""
    g11, g22, g12, h1, h2 = (np.asarray(s, np.float32) for s in sums)
    det = g11 * g22 - g12 * g12
    if det_eps == 0.0:
        from cuda_optical_flow_2_tpu.oracle.gpu_reference import (
            inverse_matrix_float,
        )

        return inverse_matrix_float(g11, g22, g12, h1, h2)
    safe = np.abs(det) >= det_eps
    inv = np.where(safe, 1.0 / np.where(safe, det, 1.0), 0.0)
    u = (-g22 * h1 + g12 * h2) * inv
    v = (g12 * h1 - g11 * h2) * inv
    return np.stack([u, v], axis=-1).astype(np.float32)


def _lk_stages(prev_l, nxt_l, flow_in, config, n_bands):
    """Stage runners for Lucas-Kanade at one level.

    Canonical inputs: ``prev_l``/``nxt_l`` the level's pyramid images,
    ``flow_in`` the incoming (upsampled) flow.  ``nxt_w`` — the XLA-warped
    next frame — feeds the residual stages so every backend sees identical
    inputs and differences localize to the stage under test."""
    from cuda_optical_flow_2_tpu.constants import MASKS
    from cuda_optical_flow_2_tpu.models.lucas_kanade import (
        _lk_residual_xla,
        lk_level,
        solve_flow,
    )
    from cuda_optical_flow_2_tpu.ops.gradients import (
        spatial_gradients,
        temporal_gradient,
    )
    from cuda_optical_flow_2_tpu.ops.warp import warp_bilinear
    from cuda_optical_flow_2_tpu.ops.window import structure_tensor_sums
    from cuda_optical_flow_2_tpu.oracle import gpu_reference as gref

    r_grad = config.window // 2 + 2
    clamped = jnp.clip(flow_in, -config.max_displacement, config.max_displacement)
    nxt_w = warp_bilinear(nxt_l, clamped)
    ix, iy = spatial_gradients(prev_l, config.normalize_gradients)
    it = temporal_gradient(
        prev_l, nxt_w, config.temporal_kernel, config.normalize_gradients
    )

    def _grads_of(p, nw):
        return spatial_gradients(p, config.normalize_gradients) + (
            temporal_gradient(
                p, nw, config.temporal_kernel, config.normalize_gradients
            ),
        )

    def grads(backend):
        if backend == "xla":
            return _grads_of(prev_l, nxt_w)
        if backend == "banded":
            return banded(_grads_of, 2, n_bands)(prev_l, nxt_w)
        if backend == "oracle":
            p = np.asarray(prev_l, np.float32)[..., None]
            d = (np.asarray(nxt_w, np.float32) - p[..., 0])[..., None]
            s = 1.0 / 8.0 if config.normalize_gradients else 1.0
            gx = gref.conv_3ch_1ch_float(p, MASKS["sobel_x"] * s)
            gy = gref.conv_3ch_1ch_float(p, MASKS["sobel_y"] * s)
            tm = MASKS[config.temporal_kernel]
            if config.normalize_gradients:
                tm = tm / tm.sum()
            gt = gref.conv_3ch_1ch_float(d, tm)
            return gx, gy, gt
        return None

    weights = getattr(config, "window_weights", "box")

    def window_sums(backend):
        if backend == "xla":
            return structure_tensor_sums(
                ix, iy, it, config.window, config.window_method, weights
            )
        if backend == "banded":
            return banded(
                lambda a, b, c: structure_tensor_sums(
                    a, b, c, config.window, config.window_method, weights
                ),
                config.window // 2,
                n_bands,
            )(ix, iy, it)
        if backend == "oracle":
            if weights != "box":
                # The reference's srm sums are inherently flat — there is no
                # oracle twin for a weighted window; skip the row rather
                # than compare mismatched computations.
                return None
            w = config.window
            gx, gy, gt = (np.asarray(a, np.float32) for a in (ix, iy, it))
            return tuple(
                gref.srm_1ch_float(a, b, w, w)
                for a, b in ((gx, gx), (gy, gy), (gx, gy), (gx, gt), (gy, gt))
            )
        return None

    sums = structure_tensor_sums(
        ix, iy, it, config.window, config.window_method, weights
    )

    def solve(backend):
        if backend == "xla":
            return solve_flow(sums, config)
        if backend == "oracle":
            return _guarded_solve_np(sums, config.det_eps)
        return None

    warp = _make_warp_stage(nxt_l, clamped, config, n_bands)

    def residual(backend):
        if backend == "xla":
            return _lk_residual_xla(prev_l, nxt_w, config)
        if backend == "pallas":
            from cuda_optical_flow_2_tpu.kernels import lk_fused

            if config.window > lk_fused.MAX_WINDOW:
                return None
            return lk_fused.lk_residual(
                prev_l, nxt_w, config, interpret=_interpret()
            )
        if backend == "banded":
            from cuda_optical_flow_2_tpu.parallel.spatial import (
                _banded_residual,
            )

            h = prev_l.shape[-2]
            outs = []
            for lo, hi in _band_bounds(h, n_bands):
                pb = _extend_band(prev_l, lo, hi, r_grad)
                nb = _extend_band(nxt_w, lo, hi, r_grad)
                res = _banded_residual(pb, nb, lo - r_grad, h, config)
                outs.append(res[..., r_grad:-r_grad, :, :])
            return jnp.concatenate(outs, axis=-3)
        return None

    def level(backend):
        cfg = _with_kernel(config, backend)
        return None if cfg is None else lk_level(prev_l, nxt_l, flow_in, cfg)

    return {
        "gradients": grads,
        "window_sums": window_sums,
        "solve": solve,
        "warp": warp,
        "residual": residual,
        "level": level,
    }


def _fb_stages(prev_l, nxt_l, flow_in, config, n_bands):
    """Stage runners for Farnebäck (image-warp formulation) at one level."""
    from cuda_optical_flow_2_tpu.models.farneback import (
        _window_solve,
        fb_level_image,
    )
    from cuda_optical_flow_2_tpu.ops.poly_exp import poly_expansion
    from cuda_optical_flow_2_tpu.ops.warp import warp_bilinear

    r_poly = config.poly_n // 2
    clamped = jnp.clip(flow_in, -config.max_displacement, config.max_displacement)
    exp1 = poly_expansion(prev_l, config.poly_n, config.poly_sigma)
    warped = warp_bilinear(nxt_l, clamped)
    w_exp = poly_expansion(warped, config.poly_n, config.poly_sigma)
    bx1, by1, axx1, ayy1, axy1 = exp1
    w_bx, w_by, w_axx, w_ayy, w_axy = w_exp
    u, v = clamped[..., 0], clamped[..., 1]
    axx = 0.5 * (axx1 + w_axx)
    ayy = 0.5 * (ayy1 + w_ayy)
    axy = 0.5 * (axy1 + w_axy)
    db_x = 0.5 * (bx1 - w_bx) + axx * u + axy * v
    db_y = 0.5 * (by1 - w_by) + axy * u + ayy * v
    prods = (
        axx * axx + axy * axy,
        axy * (axx + ayy),
        axy * axy + ayy * ayy,
        axx * db_x + axy * db_y,
        axy * db_x + ayy * db_y,
    )

    def expand(backend):
        if backend == "xla":
            return poly_expansion(prev_l, config.poly_n, config.poly_sigma)
        if backend == "banded":
            return banded(
                lambda f: poly_expansion(f, config.poly_n, config.poly_sigma),
                r_poly,
                n_bands,
            )(prev_l)
        return None

    warp = _make_warp_stage(nxt_l, clamped, config, n_bands)

    def window_solve(backend):
        if backend == "xla":
            return _window_solve(prods, config)
        if backend == "banded":
            return banded(
                lambda *p: _window_solve(p, config),
                config.winsize // 2,
                n_bands,
                out_row_axis=-3,
            )(*prods)
        return None

    def level(backend):
        if backend == "xla":
            return fb_level_image(nxt_l, exp1, flow_in, config)
        return None

    return {
        "expand": expand,
        "warp": warp,
        "window_solve": window_solve,
        "level": level,
    }


def _hs_stages(prev_l, nxt_l, flow_in, config, n_bands):
    """Stage runners for Horn-Schunck at one level: the relaxation is
    isolated on the canonical warped pair (sweeps from zero flow)."""
    from cuda_optical_flow_2_tpu.models.horn_schunck import hs_level
    from cuda_optical_flow_2_tpu.ops.warp import warp_bilinear

    clamped = jnp.clip(flow_in, -config.max_displacement, config.max_displacement)
    nxt_w = warp_bilinear(nxt_l, clamped)

    def sweeps(backend):
        if backend == "xla":
            return hs_level(prev_l, nxt_w, None, config)
        return None

    def level(backend):
        if backend == "xla":
            return clamped + hs_level(prev_l, nxt_w, None, config)
        return None

    return {"sweeps": sweeps, "level": level}


def _tvl1_stages(prev_l, nxt_l, flow_in, config, n_bands):
    """Stage runners for TV-L1 at one level (one linearization/warp)."""
    from cuda_optical_flow_2_tpu.models.tvl1 import tvl1_level
    from cuda_optical_flow_2_tpu.ops.warp import warp_bilinear

    clamped = jnp.clip(flow_in, -config.max_displacement, config.max_displacement)
    warped = warp_bilinear(nxt_l, clamped)

    def sweeps(backend):
        if backend == "xla":
            return tvl1_level(prev_l, warped, clamped, clamped, config)
        return None

    return {"sweeps": sweeps}


def _dis_stages(prev_l, nxt_l, flow_in, config, n_bands):
    """Stage runners for DIS at one level: the mean-normalized inverse
    search and the variational refinement are isolated on the canonical
    clamped/warped inputs."""
    from cuda_optical_flow_2_tpu.models.dis import _refine, dis_level
    from cuda_optical_flow_2_tpu.ops.warp import warp_bilinear

    clamped = jnp.clip(flow_in, -config.max_displacement, config.max_displacement)
    warped = warp_bilinear(nxt_l, clamped)

    def search(backend):
        cfg = _with_kernel(config, backend)
        if cfg is None:
            return None
        return dis_level(
            prev_l, warped, None, dataclasses.replace(cfg, refine_iterations=0)
        )

    def refine(backend):
        if backend == "xla":
            return _refine(prev_l, nxt_l, clamped, config)
        return None

    def level(backend):
        cfg = _with_kernel(config, backend)
        return None if cfg is None else dis_level(prev_l, nxt_l, flow_in, cfg)

    return {"search": search, "refine": refine, "level": level}


def _flow_runner(prev, nxt, config):
    """Whole-pipeline stage ("flow"): unsharded xla/pallas + a REAL-mesh
    ``sharded`` backend (spatial TP over every available device)."""
    from cuda_optical_flow_2_tpu.models import pyramidal_flow

    def run(backend):
        if backend in ("xla", "pallas"):
            cfg = _with_kernel(config, backend)
            return None if cfg is None else pyramidal_flow(prev, nxt, cfg)
        if backend == "sharded":
            import cuda_optical_flow_2_tpu.models.farneback as fb
            import cuda_optical_flow_2_tpu.models.horn_schunck as hs
            import cuda_optical_flow_2_tpu.models.tvl1 as tvl1
            from cuda_optical_flow_2_tpu import parallel

            if len(jax.devices()) < 2:
                return None
            mesh = parallel.make_mesh(axis_name="space")
            try:
                if isinstance(config, hs.HSConfig):
                    return parallel.spatial_pyramidal_hs(prev, nxt, config, mesh)
                if isinstance(config, fb.FBConfig):
                    return parallel.spatial_pyramidal_fb(prev, nxt, config, mesh)
                if isinstance(config, tvl1.TVL1Config):
                    return parallel.spatial_pyramidal_tvl1(prev, nxt, config, mesh)
                from cuda_optical_flow_2_tpu.models.dis import DISConfig

                if isinstance(config, DISConfig):
                    return parallel.spatial_pyramidal_dis(prev, nxt, config, mesh)
                return parallel.spatial_pyramidal_lk(prev, nxt, config, mesh)
            except (ValueError, NotImplementedError):
                return None  # shape/config not shardable this way
        return None

    return run


def stages_for(config) -> Callable:
    """The stage-runner factory for a config's model family."""
    from cuda_optical_flow_2_tpu.models.dis import DISConfig
    from cuda_optical_flow_2_tpu.models.farneback import FBConfig
    from cuda_optical_flow_2_tpu.models.horn_schunck import HSConfig
    from cuda_optical_flow_2_tpu.models.tvl1 import TVL1Config

    if isinstance(config, FBConfig):
        return _fb_stages
    if isinstance(config, HSConfig):
        return _hs_stages
    if isinstance(config, TVL1Config):
        return _tvl1_stages
    if isinstance(config, DISConfig):
        return _dis_stages
    return _lk_stages


# ---------------------------------------------------------------------------
# Report
# ---------------------------------------------------------------------------


def _canonical_levels(prev, nxt, config):
    """Per-level canonical inputs from one unsharded XLA run.

    Returns (prev_pyr, next_pyr, flow_in) with flow_in[k] the flow entering
    level k: zeros at the coarsest, else the upsampled result of running the
    family's own coarse-to-fine over the coarser levels."""
    from cuda_optical_flow_2_tpu.models.streaming import _flow, _preprocess
    from cuda_optical_flow_2_tpu.ops.resize import upsample_flow

    xla_cfg = _with_kernel(config, "xla")
    prev_pyr = _preprocess(prev, xla_cfg)
    next_pyr = _preprocess(nxt, xla_cfg)
    flow_in: dict[int, jax.Array] = {}
    top = config.levels - 1
    flow_in[top] = jnp.zeros(prev_pyr[top].shape + (2,), jnp.float32)
    for k in range(top - 1, -1, -1):
        sub_cfg = dataclasses.replace(xla_cfg, levels=top - k)
        f = _flow(prev_pyr[k + 1 :], next_pyr[k + 1 :], sub_cfg)
        flow_in[k] = upsample_flow(f, prev_pyr[k].shape[-2:])
    return prev_pyr, next_pyr, flow_in


def _diff(a, b) -> tuple[float, float]:
    at = a if isinstance(a, tuple) else (a,)
    bt = b if isinstance(b, tuple) else (b,)
    if len(at) != len(bt):
        raise ValueError(
            f"backend returned {len(bt)} outputs, baseline {len(at)} — "
            f"refusing to silently compare a subset"
        )
    mx = total = 0.0
    count = 0
    for x, y in zip(at, bt):
        d = np.abs(np.asarray(x, np.float64) - np.asarray(y, np.float64))
        mx = max(mx, float(d.max()))
        total += float(d.sum())
        count += d.size
    return mx, total / max(count, 1)


def stage_report(
    prev,
    nxt,
    config,
    *,
    backends: tuple[str, ...] = ("pallas", "banded"),
    baseline: str = "xla",
    levels: tuple[int, ...] | None = None,
    n_bands: int = 4,
    stages: tuple[str, ...] | None = None,
) -> list[StageDiff]:
    """Run each stage through ``backends`` and diff against ``baseline``.

    ``prev``/``nxt``: a planar float frame pair.  Canonical per-level inputs
    (pyramid images and the incoming upsampled flow) come from one unsharded
    XLA run, so every backend computes the SAME stage from the SAME data —
    differences localize to the stage, not to error accumulated upstream.
    The level's rows must divide by ``n_bands`` for the banded backend.
    """
    known = {"xla", "pallas", "banded", "oracle", "sharded"}
    bad = [b for b in (*backends, baseline) if b not in known]
    if bad:
        # A runner silently returns None for names it doesn't know, which
        # would yield an EMPTY report — e.g. `--backends xla,pallas` (one
        # comma-joined token) printing nothing and exiting 0.
        raise ValueError(
            f"unknown backend(s) {bad}; choose from {sorted(known)}"
        )

    prev = jnp.asarray(prev, jnp.float32)
    nxt = jnp.asarray(nxt, jnp.float32)
    prev_pyr, next_pyr, flow_in = _canonical_levels(prev, nxt, config)

    factory = stages_for(config)
    out: list[StageDiff] = []
    lvls = levels if levels is not None else tuple(range(config.levels))
    for k in lvls:
        runners = factory(
            prev_pyr[k], next_pyr[k], flow_in[k], config, n_bands
        )
        for name, run in runners.items():
            if stages is not None and name not in stages:
                continue
            base = run(baseline)
            if base is None:
                continue
            base = jax.tree.map(np.asarray, base)
            for backend in backends:
                got = run(backend)
                if got is None:
                    continue
                mx, mean = _diff(base, jax.tree.map(np.asarray, got))
                out.append(
                    StageDiff(
                        k, name, backend, baseline, mx, mean,
                        tuple(
                            np.shape(
                                base[0] if isinstance(base, tuple) else base
                            )
                        ),
                    )
                )
    if stages is None or "flow" in stages:
        run = _flow_runner(prev, nxt, config)
        base = run(baseline)
        if base is None:
            # Same skip contract as the per-stage loop: e.g. the
            # "oracle" baseline has no end-to-end flow runner.
            return out
        base_np = np.asarray(base)
        for backend in backends:
            got = run(backend)
            if got is None:
                continue
            mx, mean = _diff(base_np, np.asarray(got))
            out.append(
                StageDiff(
                    -1, "flow", backend, baseline, mx, mean,
                    tuple(base_np.shape),
                )
            )
    return out


def format_report(report: list[StageDiff]) -> str:
    if not report:
        # Distinguish "nothing diffed" from a clean run: every row skipped
        # means the stage filter (or a baseline with no runner for any
        # stage) matched nothing.
        return "(no stages matched — check --stages / --baseline)"
    return "\n".join(str(r) for r in report)
