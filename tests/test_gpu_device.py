"""On-card checks: the compiled GPU path against its references.

The regular suite runs on the CPU (the Triton kernel in interpret mode).
These tests run the shared checks of utils/device_checks.py — the same
functions chip_smoke.py calls — on a real GPU.  Run them on the card with

    JAX_PLATFORMS=cuda python -m pytest -m gpu tests/test_gpu_device.py -q

On any other backend every test here skips.
"""

from __future__ import annotations

import pytest

pytestmark = pytest.mark.gpu


@pytest.fixture
def gpu():
    import jax

    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU backend (JAX_PLATFORMS=cuda)")
    from cuda_optical_flow_2_tpu.utils import device_checks

    return device_checks


@pytest.mark.parametrize("name", ["PAPER_1080P", "REFERENCE_GPU"])
def test_pipeline_kernel_matches_twin(gpu, name):
    import cuda_optical_flow_2_tpu as of

    h, w = (1080, 1920) if name == "PAPER_1080P" else (480, 640)
    out = gpu.pipeline_parity(getattr(of, name), h, w)
    assert out["triton_calls"] > 0


def test_compat_matches_oracle(gpu):
    gpu.compat_vs_oracle()


@pytest.mark.parametrize("weights", ["box", "tri", "gauss"])
def test_lk_stage_rows_match_twin(gpu, weights):
    import cuda_optical_flow_2_tpu as of

    gpu.stage_parity(
        of.LKConfig(levels=2, window=9, iterations=2, window_weights=weights)
    )


def test_dis_stage_rows_match_twin(gpu):
    from cuda_optical_flow_2_tpu.models.dis import DISConfig

    gpu.stage_parity(DISConfig(levels=2, window=9, iterations=2))


@pytest.mark.parametrize("model", ["lk", "hs", "fb", "tvl1", "dis"])
def test_spatial_one_card_matches_unsharded(gpu, model):
    gpu.spatial_one_device(model)


def test_flow_accuracy_on_translation(gpu):
    gpu.translation_accuracy()


def test_charbonnier_dis_matches_twin(gpu):
    gpu.charbonnier_parity()


def test_headline_clears_target(gpu):
    gpu.headline_clears_target()
