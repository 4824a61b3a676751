"""Test configuration.

Tests run on CPU with a virtual 8-device mesh so the shard_map batching path
(BASELINE config 5) is testable without a multi-GPU host, per SURVEY.md
section 4.  Must run before jax is imported anywhere.
"""

import os
import sys

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# The suite runs on the CPU unless JAX_PLATFORMS names another platform:
# `JAX_PLATFORMS=cuda python -m pytest -m gpu tests/test_gpu_device.py` runs
# the on-card checks on a GPU.  Float64 (the reference-exact compat solve;
# the reference solves in double, OptFlowGpu.cu:1831) is enabled on the CPU
# only; production code pins float32 explicitly.
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402

if os.environ["JAX_PLATFORMS"] == "cpu":
    jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402
import pytest  # noqa: E402


# Slow tier (VERDICT r3 item 6): every test measured >= 10 s in the round-4
# full-suite durations run (334 tests, 49:25 total; this list sums 2474 s).
# `pytest -m "not slow"` is the fast iteration tier (~8 min, still covers
# every feature area with at least one sub-10s test); the FULL suite is the
# pre-commit / nightly gate — no coverage is tiered out of it.  Centralized
# here (instead of 65 decorators across 15 files) so the list stays in one
# reviewable place next to its measurement provenance; parametrized entries
# name the slow parameter only.
SLOW_TESTS = frozenset({
    "test_parallel.py::test_spatial_dis_charbonnier_matches_unsharded",
    "test_parallel.py::test_spatial_hs_charbonnier_matches_unsharded",
    "test_streaming.py::test_scene_cut_recovery_model_generic_dis",
    "test_consistency.py::test_fill_occluded_flow_improves_unmatched_epe",
    "test_horn_schunck.py::test_hs_charbonnier_beats_quadratic_frontier_on_boundaries",
    "test_parallel.py::test_spatial_prefilter_all_families",
    "test_pallas.py::test_random_config_parity_sweep",
    "test_dis.py::test_dis_dispatch_forced_interpret",
    "test_dis.py::test_charbonnier_decouples_boundary_from_smoothing",
    "test_parallel.py::test_grid_flow_model_generic",
    "test_parallel.py::test_spatial_tvl1_matches_unsharded",
    "test_debug.py::test_lk_stage_report_backends_agree",
    "test_examples.py::test_example_runs[learned_refinement]",
    "test_examples.py::test_example_runs[live_stream]",
    "test_layered_motion.py::test_occlusion_detection_tvl1_disk",
    "test_layered_motion.py::test_occlusion_detection_ap_bar",
    "test_layered_motion.py::test_matched_epe_disk[dis-0.3]",
    "test_median.py::test_tvl1_median_filtering_config",
    "test_pallas.py::test_pipeline_with_pallas_warp_matches_xla",
    "test_parallel.py::test_spatial_dis_matches_unsharded",
    "test_differentiability.py::test_all_families_differentiable",
    "test_debug.py::test_fb_tolerance_decomposes_per_stage",
    "test_streaming.py::test_warm_start_model_generic",
    "test_parallel.py::test_halo_exchange_counts_hoisted",
    "test_evaluate.py::test_eval_cli_preset",
    "test_parallel.py::test_sharded_flow_model_generic",
    "test_parallel.py::test_spatial_fb_matches_unsharded",
    "test_examples.py::test_example_runs[frame_interpolation]",
    "test_dis.py::test_batched_matches_single",
    "test_dis.py::test_large_displacement_beats_plain_lk",
    "test_pipeline.py::test_odd_sizes_recover_translation",
    "test_tvl1.py::test_preserves_motion_discontinuity_vs_hs",
    "test_opencv_parity.py::test_dis_vs_opencv[translate_smooth]",
    "test_cli.py::test_demo_tvl1_model",
    "test_tvl1.py::test_translation_accuracy",
    "test_examples.py::test_example_runs[spatial_tp]",
    "test_parallel.py::test_spatial_fb_gaussian_window_matches_unsharded",
    "test_tvl1.py::test_streaming_tvl1_matches_pairwise",
    "test_golden.py::test_compat_cpu_matches_golden",
    "test_parallel.py::test_spatial_hs_matches_unsharded",
    "test_pipeline.py::test_prefilter_path_runs",
})


def pytest_collection_modifyitems(config, items):
    matched = set()
    collected_modules = set()
    for item in items:
        name = item.nodeid.split("::")[-1]
        key = f"{item.fspath.basename}::{name}"
        collected_modules.add(item.fspath.basename)
        if key in SLOW_TESTS:
            item.add_marker(pytest.mark.slow)
            matched.add(key)
    # Drift guard: a renamed/removed test must not silently fall out of the
    # slow tier (the fast tier would quietly grow past its budget).  Only
    # entries whose MODULE was collected are checked, so single-file runs
    # don't flag entries from other modules; node-id selections
    # (`pytest file.py::test_x`) collect one item per module, so the check
    # is skipped entirely for them (ADVICE r4 — the guard aborted every
    # single-test invocation in a module with slow entries).
    if any("::" in a for a in config.args):
        return
    stale = {
        k for k in SLOW_TESTS - matched
        if k.split("::")[0] in collected_modules
    }
    if stale:
        raise pytest.UsageError(
            "SLOW_TESTS entries match no collected test (renamed/removed? "
            f"update tests/conftest.py): {sorted(stale)}"
        )


@pytest.fixture
def rng() -> np.random.Generator:
    return np.random.default_rng(0)


@pytest.fixture
def kernel_interpret(monkeypatch):
    """Route the models' residual dispatch to the fused Triton kernel, run
    in interpret mode, so the kernel path of a whole pipeline runs on the
    CPU.  ``.calls`` counts the kernel invocations traced."""
    from cuda_optical_flow_2_tpu.kernels import lk_fused
    from cuda_optical_flow_2_tpu.models import dis, lucas_kanade

    kernel = lk_fused.lk_residual

    def interpreted(*args, **kwargs):
        interpreted.calls += 1
        return kernel(*args, **kwargs, interpret=True)

    interpreted.calls = 0
    monkeypatch.setattr(lk_fused, "lk_residual", interpreted)
    for mod in (lucas_kanade, dis):
        chooser = mod.residual_impl

        def route(backend, dtype, shape, config, chooser=chooser):
            return chooser("gpu", dtype, shape, config)

        monkeypatch.setattr(mod, "residual_impl", route)
    return interpreted


@pytest.fixture(autouse=True, scope="module")
def _release_jit_executables():
    """Drop compiled-executable references after each test module.

    A full single-process suite run compiles many hundreds of XLA:CPU
    programs; keeping every LoadedExecutable alive for the whole run grows
    the LLVM JIT's code memory until a late large compile (the spatial-TP
    interpret-mode programs) segfaults inside backend_compile — reproducible
    at the same test in consecutive full runs, while the same test passes in
    isolation.  Cross-module cache reuse is negligible (each module compiles
    its own shapes/configs), so clearing per module costs little and bounds
    the per-process JIT footprint.
    """
    yield
    jax.clear_caches()


def make_translating_pair(
    h: int = 64, w: int = 64, dx: int = 1, dy: int = 0, seed: int = 0, period: int = 8
) -> tuple[np.ndarray, np.ndarray]:
    """Synthetic translating-checkerboard frame pair, (h, w, 3) uint8 each.

    BASELINE config 1's input: a checkerboard (smoothed so LK has usable
    gradients) shifted by an integer (dx, dy) between frames.
    """
    rng_ = np.random.default_rng(seed)
    big = np.zeros((h * 2, w * 2), dtype=np.float64)
    ys, xs = np.mgrid[0 : h * 2, 0 : w * 2]
    big = (
        127.0
        + 60.0 * np.sin(2 * np.pi * xs / period) * np.sin(2 * np.pi * ys / period)
        + 30.0 * np.sin(2 * np.pi * (xs + ys) / (period * 2.3))
        + rng_.normal(0, 2.0, big.shape)
    )
    big = np.clip(big, 0, 255)
    y0, x0 = h // 2, w // 2
    prev = big[y0 : y0 + h, x0 : x0 + w]
    nxt = big[y0 - dy : y0 - dy + h, x0 - dx : x0 - dx + w]
    prev3 = np.repeat(prev[..., None].astype(np.uint8), 3, axis=-1)
    next3 = np.repeat(nxt[..., None].astype(np.uint8), 3, axis=-1)
    return prev3, next3
