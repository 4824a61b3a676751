"""Checks of the GPU path against its references, run on the card.

Shared by the ``gpu``-marked tests (tests/test_gpu_device.py) and by
chip_smoke.py, which calls them in its own process.  Each check runs on the
default device, raises ``AssertionError`` when a bound fails, and returns the
numbers it measured so callers can print them.
"""

from __future__ import annotations

import dataclasses

import numpy as np

import jax
import jax.numpy as jnp

__all__ = [
    "triton_calls",
    "pipeline_parity",
    "compat_vs_oracle",
    "stage_parity",
    "spatial_one_device",
    "translation_accuracy",
    "charbonnier_parity",
    "headline_clears_target",
    "multi_card_parity",
    "FAMILIES",
]

FAMILIES = ("lk", "hs", "fb", "tvl1", "dis")


def triton_calls(fn, *args) -> int:
    """How many Pallas-Triton kernel calls ``jit(fn)(*args)`` lowers to."""
    return jax.jit(fn).lower(*args).as_text().count("__gpu$xla.gpu.triton")


def frames(n: int, h: int, w: int, velocity=(2.0, 1.0), seed: int = 0) -> np.ndarray:
    """``n`` frames (float32, (n, h, w)) of a seeded band-limited texture
    translating by ``velocity`` px per frame.

    The texture (utils/layered) has structure from 256 px down to 4 px
    periods, so every level of a 5-level pyramid sees alias-free texture;
    flow from frame t to t+1 is exactly ``velocity``.
    """
    from cuda_optical_flow_2_tpu.utils.layered import _texture

    tex = _texture(seed, contrast=25.0, fmin=1.0 / 256.0)
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float64)
    vx, vy = velocity
    return np.stack(
        [tex(ys - vy * t, xs - vx * t) for t in range(n)]
    ).astype(np.float32)


def pair(h: int, w: int, velocity=(2.0, 1.0), seed: int = 0):
    """One translating pair of :func:`frames` as device arrays."""
    seq = frames(2, h, w, velocity, seed)
    return jnp.asarray(seq[0]), jnp.asarray(seq[1])


def epe(flow, velocity, margin: int) -> float:
    """Mean endpoint error against a uniform translation, border cropped."""
    f = np.asarray(flow)[..., margin:-margin, margin:-margin, :]
    return float(np.hypot(f[..., 0] - velocity[0], f[..., 1] - velocity[1]).mean())


def _well_conditioned(prev, config) -> np.ndarray:
    """Pixels whose structure-tensor |det| exceeds 10 * det_eps (finest
    level, spatial sums only — the determinant does not see the warp)."""
    from cuda_optical_flow_2_tpu.models.lucas_kanade import preprocess
    from cuda_optical_flow_2_tpu.ops.gradients import spatial_gradients
    from cuda_optical_flow_2_tpu.ops.window import window_sum

    p0 = preprocess(prev, config)[0]
    ix, iy = spatial_gradients(p0, config.normalize_gradients)
    s = window_sum(
        jnp.stack([ix * ix, iy * iy, ix * iy]), config.window,
        config.window_method, config.window_weights,
    )
    det = np.asarray(s[0] * s[1] - s[2] * s[2])
    return np.abs(det) > 10.0 * max(config.det_eps, 0.0)


def pipeline_parity(
    config, h: int, w: int, velocity=(2.0, 1.0), *,
    max_bound: float = 1e-3, mean_bound: float = 1e-4, epe_slack: float = 0.01,
) -> dict:
    """``pyramidal_lk`` with the fused kernel against its XLA twin.

    Asserts that the kernel path really lowers to Triton calls (one per
    level and iteration), that |flow difference| over well-conditioned
    pixels stays within ``max_bound`` / ``mean_bound`` (float32 sums taken
    in another order), and that the kernel's EPE against the analytic
    velocity is at most the twin's plus ``epe_slack``.
    """
    import cuda_optical_flow_2_tpu as of

    prev, nxt = pair(h, w, velocity)
    kern_cfg = dataclasses.replace(config, use_pallas=True)
    xla_cfg = dataclasses.replace(config, use_pallas=False)

    def run(c):
        return lambda a, b: of.pyramidal_lk(a, b, c)

    calls = triton_calls(run(kern_cfg), prev, nxt)
    assert calls == config.levels * config.iterations, calls
    assert triton_calls(run(xla_cfg), prev, nxt) == 0
    compiled = jax.jit(run(kern_cfg)).lower(prev, nxt).compile()
    got = np.asarray(compiled(prev, nxt))
    want = np.asarray(jax.jit(run(xla_cfg))(prev, nxt))
    assert got.shape == (h, w, 2) and np.isfinite(got).all()
    keep = _well_conditioned(prev, config)
    diff = np.abs(got - want)[keep]
    margin = max(h, w) // 16
    out = {
        "triton_calls": calls,
        "max_abs_diff": float(diff.max()),
        "mean_abs_diff": float(diff.mean()),
        "kept_pixels": float(keep.mean()),
        "epe_kernel": epe(got, velocity, margin),
        "epe_twin": epe(want, velocity, margin),
        "memory": str(compiled.memory_analysis()),
    }
    assert out["max_abs_diff"] <= max_bound, out
    assert out["mean_abs_diff"] <= mean_bound, out
    assert out["epe_kernel"] <= out["epe_twin"] + epe_slack, out
    return out


def compat_vs_oracle() -> dict:
    """The uchar-exact compat profile on the card against the NumPy oracle:
    integer stages bit-exact, flow within 1e-5 EPE (tests/test_compat.py's
    bounds, with float64 solves as there)."""
    from cuda_optical_flow_2_tpu.constants import GAUS_KERNEL_3X3, DX_3X3
    from cuda_optical_flow_2_tpu.models import compat
    from cuda_optical_flow_2_tpu.oracle import cpu_reference as cpu

    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (48, 64, 3), dtype=np.uint8)
    a = rng.integers(0, 256, (40, 48), dtype=np.uint8)
    b = rng.integers(0, 256, (40, 48), dtype=np.uint8)
    ys, xs = np.mgrid[0:128, 0:128]
    tex = 127 + 60 * np.sin(2 * np.pi * xs / 8) * np.sin(2 * np.pi * ys / 8)
    big = np.clip(tex + rng.normal(0, 2, tex.shape), 0, 255)
    prev = np.repeat(big[32:96, 32:96, None].astype(np.uint8), 3, -1)
    nxt = np.repeat(big[31:95, 30:94, None].astype(np.uint8), 3, -1)
    with jax.enable_x64(True):
        exact = {
            "conv_u8": np.array_equal(
                np.asarray(compat.conv_3ch_to_1ch_u8(jnp.asarray(img), DX_3X3)),
                cpu.conv_3ch_to_1ch(img, DX_3X3),
            ),
            "downscale_u8": np.array_equal(
                np.asarray(compat.downscale_gaussian_u8(jnp.asarray(img))),
                cpu.downscale_gaussian(img, GAUS_KERNEL_3X3),
            ),
            "pyramid_u8": all(
                np.array_equal(np.asarray(g), w_)
                for g, w_ in zip(
                    compat.build_pyramid_u8(jnp.asarray(img), 3),
                    cpu.gauss_pyramid(img, 3),
                )
            ),
            "srm_i32": np.array_equal(
                np.asarray(compat.srm_1ch_i32(jnp.asarray(a), jnp.asarray(b), 9)),
                cpu.srm_1ch(a, b, 9, 9),
            ),
        }
        got = compat.pyramidal_lk_exact(
            jnp.asarray(prev), jnp.asarray(nxt), levels=4, profile="cpu"
        )
        got = [np.asarray(g) for g in got]
    want = cpu.calc_optical_flow_pyramid(
        cpu.gauss_pyramid(prev, 4), cpu.gauss_pyramid(nxt, 4), window=9
    )
    level_epe = []
    for g, w_ in zip(got, want):
        fg, fw = np.isfinite(g).all(-1), np.isfinite(w_).all(-1)
        assert np.array_equal(fg, fw), "non-finite masks differ"
        d = g[fg] - w_[fw]
        level_epe.append(float(np.hypot(d[..., 0], d[..., 1]).mean()) if d.size else 0.0)
    out = {**exact, "flow_epe_per_level": level_epe}
    assert all(exact.values()), out
    assert max(level_epe) <= 1e-5, out
    return out


def _family_config(model: str):
    import cuda_optical_flow_2_tpu as of
    from cuda_optical_flow_2_tpu.models.dis import DISConfig
    from cuda_optical_flow_2_tpu.models.farneback import FBConfig
    from cuda_optical_flow_2_tpu.models.horn_schunck import HSConfig
    from cuda_optical_flow_2_tpu.models.tvl1 import TVL1Config

    return {
        "lk": of.LKConfig(levels=2, window=9, iterations=2),
        "hs": HSConfig(levels=2, iterations=20),
        "fb": FBConfig(levels=2, iterations=2, winsize=9),
        "tvl1": TVL1Config(levels=2, iterations=15),
        "dis": DISConfig(levels=2, window=9, iterations=2),
    }[model]


def stage_parity(config, *, mean_bound: float = 1e-4) -> list:
    """Per-stage report (utils/debug.stage_report) of the compiled kernel
    rows against the XLA twin: every row finite, mean |delta| bounded."""
    from cuda_optical_flow_2_tpu.utils.debug import stage_report

    prev, nxt = pair(128, 256)
    report = stage_report(prev, nxt, config, backends=("pallas",))
    assert report, "no kernel rows in the stage report"
    for row in report:
        assert np.isfinite(row.max_abs) and row.mean_abs < mean_bound, row
    return report


def spatial_one_device(model: str) -> float:
    """Spatial TP on a one-card mesh against the unsharded pipeline (the
    shard-local XLA forms against the single-card path, kernel included)."""
    from cuda_optical_flow_2_tpu import parallel
    from cuda_optical_flow_2_tpu.models import pyramidal_flow

    prev, nxt = pair(128, 256)
    cfg = _family_config(model)
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:1]), ("space",))
    got = np.asarray(parallel.spatial_pyramidal_flow(prev, nxt, cfg, mesh))
    want = np.asarray(pyramidal_flow(prev, nxt, cfg))
    assert np.isfinite(got).all()
    mean = float(np.abs(got - want).mean())
    assert mean < 1e-2, (model, mean)
    return mean


def translation_accuracy() -> list[float]:
    """End-to-end accuracy on the card: median inner flow ~= (2, 1)."""
    import cuda_optical_flow_2_tpu as of

    prev, nxt = pair(128, 256)
    cfg = of.LKConfig(levels=3, window=11, temporal_kernel="gauss3", iterations=2)
    flow = np.asarray(of.pyramidal_lk_jit(prev, nxt, cfg))
    m = np.median(flow[24:-24, 24:-24], axis=(0, 1))
    assert abs(m[0] - 2.0) < 0.15 and abs(m[1] - 1.0) < 0.15, m
    return [float(v) for v in m]


def charbonnier_parity() -> float:
    """Robust-refined DIS with the kernel's centered search against its XLA
    twin on the card."""
    from cuda_optical_flow_2_tpu.models import dis as dis_mod

    prev, nxt = pair(128, 256)
    cfg = dis_mod.DISConfig(
        levels=2, window=9, iterations=2, refine_penalty="charbonnier",
        refine_alpha=40.0, refine_eps_data=10.0,
    )
    got = np.asarray(dis_mod.pyramidal_dis(prev, nxt, cfg))
    want = np.asarray(dis_mod.pyramidal_dis(
        prev, nxt, dataclasses.replace(cfg, use_pallas=False)))
    assert np.isfinite(got).all()
    mean = float(np.abs(got - want)[16:-16, 16:-16].mean())
    assert mean < 1e-2, mean
    return mean


def headline_clears_target() -> float:
    """The flagship pipeline clears the 60 fps target at a small shape (a
    sanity floor; bench.py measures the 1080p number)."""
    import cuda_optical_flow_2_tpu as of
    from cuda_optical_flow_2_tpu.utils.profiling import device_time

    prev, nxt = pair(256, 512)
    cfg = of.LKConfig(levels=3, window=15, iterations=1)
    fps = 1.0 / device_time(jax.jit(lambda a, b: of.pyramidal_lk(a, b, cfg)), prev, nxt)
    assert fps > 60.0, fps
    return fps


def multi_card_parity(
    n_cards: int = 4,
    batch: int = 8,
    batch_hw: tuple[int, int] = (1080, 1920),
    tp_hw: tuple[int, int] = (2160, 3840),
    config=None,
    tp_levels: int = 3,
) -> dict:
    """Data and spatial parallelism over ``n_cards`` cards against one card.

    DP: ``parallel.sharded_pyramidal_lk`` on ``batch`` pairs over a 1-D mesh
    of ``jax.devices()[:n_cards]``, against the same batch on card 0.
    Spatial TP: ``parallel.spatial_pyramidal_lk`` on one ``tp_hw`` pair,
    row-sharded over the same cards, against card 0.  TP uses ``tp_levels``
    pyramid levels: its rows must divide by ``n_cards * 2**(levels - 1)``,
    and 2160 = 2**4 * 135 allows at most 3 levels over 4 cards.  The shards
    run the XLA forms of the stages, so the TP rows compare the shard-local
    XLA path against the single-card path with the fused kernel.
    """
    import cuda_optical_flow_2_tpu as of
    from cuda_optical_flow_2_tpu import parallel

    config = of.PAPER_1080P if config is None else config
    devices = jax.devices()[:n_cards]
    assert len(devices) == n_cards, f"need {n_cards} devices, have {len(jax.devices())}"
    mesh = jax.sharding.Mesh(np.array(devices), ("cards",))
    card0 = devices[0]
    velocity = (2.0, 1.0)
    out = {"n_cards": n_cards}

    h, w = batch_hw
    seq = frames(batch + 1, h, w, velocity)
    prev, nxt = seq[:-1], seq[1:]
    dp = np.asarray(parallel.sharded_pyramidal_lk(
        jnp.asarray(prev), jnp.asarray(nxt), config, mesh, "cards"))
    one = np.asarray(jax.jit(lambda a, b: of.pyramidal_lk(a, b, config))(
        jax.device_put(prev, card0), jax.device_put(nxt, card0)))
    d = np.abs(dp - one)
    out["dp"] = {"shape": list(dp.shape), "max_abs_diff": float(d.max()),
                 "mean_abs_diff": float(d.mean()),
                 "epe": epe(dp, velocity, max(h, w) // 16)}
    assert np.isfinite(dp).all() and d.max() <= 1e-3, out

    h, w = tp_hw
    tp_cfg = dataclasses.replace(config, levels=tp_levels)
    p, n = pair(h, w, velocity)
    tp = np.asarray(parallel.spatial_pyramidal_lk(p, n, tp_cfg, mesh, "cards"))
    p0, n0 = jax.device_put(p, card0), jax.device_put(n, card0)
    one = np.asarray(jax.jit(lambda a, b: of.pyramidal_lk(a, b, tp_cfg))(p0, n0))
    twin_cfg = dataclasses.replace(tp_cfg, use_pallas=False)
    twin = np.asarray(jax.jit(lambda a, b: of.pyramidal_lk(a, b, twin_cfg))(p0, n0))
    d, dt = np.abs(tp - one), np.abs(tp - twin)
    out["tp"] = {"shape": list(tp.shape), "levels": tp_levels,
                 "max_abs_diff": float(d.max()), "mean_abs_diff": float(d.mean()),
                 "max_abs_diff_vs_twin": float(dt.max()),
                 "mean_abs_diff_vs_twin": float(dt.mean()),
                 "epe": epe(tp, velocity, max(h, w) // 16)}
    assert np.isfinite(tp).all() and d.mean() <= 1e-4 and dt.max() <= 1e-3, out
    return out
