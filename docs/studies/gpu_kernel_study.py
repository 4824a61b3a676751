"""Hand-written kernels against what XLA makes of the plain versions, on the GPU.

Times, at the shapes of the main path (PAPER_1080P's five levels and
REFERENCE_GPU at 640x480):

* the fused LK residual kernel (kernels/lk_fused.py) against the XLA twin
  (models/lucas_kanade._lk_residual_xla), over tile side, warps and the
  band-product algorithm, with the largest |difference| to the twin, and
  its centered (DIS) mode against the DIS twin;
* the pyramid as the strided stencil (ops/pyramid.py) against the banded
  matrix products it replaced (kept here as ``_pyr_down_banded``);
* the XLA bilateral prefilter;
* the whole PAPER_1080P and REFERENCE_GPU pipelines with the kernel off and
  on, in the order off, on, on, off.

Run on the card: ``python docs/studies/gpu_kernel_study.py [--quick]``.
Prints one line per measurement and writes them all to
``chiprun_out/gpu_kernel_study.json``.  Exits non-zero without a GPU.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import traceback

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax import lax  # noqa: E402

import cuda_optical_flow_2_tpu as of  # noqa: E402
from cuda_optical_flow_2_tpu.constants import BINOMIAL_1D  # noqa: E402
from cuda_optical_flow_2_tpu.kernels import lk_fused  # noqa: E402
from cuda_optical_flow_2_tpu.models.dis import DISConfig, _dis_residual_xla  # noqa: E402
from cuda_optical_flow_2_tpu.models.dis import _lk_like as dis_lk_like  # noqa: E402
from cuda_optical_flow_2_tpu.models.lucas_kanade import _lk_residual_xla  # noqa: E402
from cuda_optical_flow_2_tpu.ops import pyramid  # noqa: E402
from cuda_optical_flow_2_tpu.ops.bilateral import bilateral_filter  # noqa: E402
from cuda_optical_flow_2_tpu.utils import device_checks  # noqa: E402
from cuda_optical_flow_2_tpu.utils.profiling import (  # noqa: E402
    device_info,
    device_time,
    enable_compile_cache,
    require_gpu,
)

RESULTS: list[dict] = []


def emit(**rec) -> None:
    RESULTS.append(rec)
    print(json.dumps(rec), flush=True)


def pair(h: int, w: int, seed: int = 0):
    return device_checks.pair(h, w, velocity=(1.3, -0.7), seed=seed)


def residual_study(quick: bool) -> None:
    shapes = [(1080 >> k, 1920 >> k) for k in range(5)]
    # The first variant is the shipped default (kernels/lk_fused.warps_for).
    variants = [dict(tile=None, num_warps=None, dot="tf32x3")]
    if not quick:
        variants += [
            dict(tile=None, num_warps=4, dot="tf32x3"),
            dict(tile=None, num_warps=8, dot="tf32x3"),
            dict(tile=32, num_warps=4, dot="tf32x3"),
            dict(tile=None, num_warps=4, dot="f32"),
        ]
    dots = {
        "tf32x3": lax.DotAlgorithmPreset.TF32_TF32_F32_X3,
        "f32": lax.DotAlgorithmPreset.F32_F32_F32,
    }
    dis_cfg = DISConfig(levels=5)
    cases = [(of.PAPER_1080P, s, False) for s in shapes] + [
        (of.REFERENCE_GPU, (480, 640), False),
        (dis_lk_like(dis_cfg), (540, 960), True),
    ]
    for c, (h, w), centered in cases:
        p, n = pair(h, w)
        if centered:
            xla = jax.jit(lambda a, b: _dis_residual_xla(a, b, dis_cfg))
        else:
            xla = jax.jit(lambda a, b, c=c: _lk_residual_xla(a, b, c))
        want = np.asarray(xla(p, n))
        t_xla = device_time(xla, p, n)
        emit(study="residual", impl="xla", h=h, w=w, window=c.window,
             weights=c.window_weights, centered=centered, ms=t_xla * 1e3)
        for v in variants:
            lk_fused._GPU_DOT = dots[v["dot"]]
            jax.clear_caches()
            try:
                fn = jax.jit(lambda a, b, c=c, v=v, ce=centered: lk_fused.lk_residual(
                    a, b, c, centered=ce, tile=v["tile"], num_warps=v["num_warps"]))
                got = np.asarray(fn(p, n))
                err = np.abs(got - want)
                ms = device_time(fn, p, n) * 1e3
                emit(study="residual", impl="triton", h=h, w=w, window=c.window,
                     weights=c.window_weights, centered=centered, **v, ms=ms,
                     max_abs_diff=float(np.nanmax(err)),
                     mean_abs_diff=float(np.nanmean(err)),
                     speedup=t_xla * 1e3 / ms)
            except Exception as e:  # noqa: BLE001 - a study reports every variant
                emit(study="residual", impl="triton", h=h, w=w, **v,
                     error=traceback.format_exception_only(e)[-1][:400])
    lk_fused._GPU_DOT = dots["tf32x3"]


def _pyr_down_banded(x, k=BINOMIAL_1D):
    """The replaced pyramid form: blur + 2x subsample as two banded matrix
    products, out = D_h @ x @ D_w^T with D[i, 2i + j - r] = k[j]."""
    k = np.asarray(k, np.float32)
    r = k.size // 2
    oh, ow = x.shape[-2] // 2, x.shape[-1] // 2

    def band(n_out):
        d = np.zeros((n_out, 2 * n_out), np.float32)
        for j, c in enumerate(k):
            for i in range(n_out):
                if 0 <= 2 * i + j - r < 2 * n_out:
                    d[i, 2 * i + j - r] = c
        return jnp.asarray(d)

    xb = x[..., : 2 * oh, : 2 * ow]
    hi = lax.Precision.HIGHEST
    tmp = jnp.einsum("hi,...iw->...hw", band(oh), xb, precision=hi)
    return jnp.einsum("...hw,jw->...hj", tmp, band(ow), precision=hi)


def pyramid_study() -> None:
    for h, w in [(1080, 1920), (480, 640)]:
        x = jnp.stack(list(pair(h, w)))
        for form, down in (("matmul", _pyr_down_banded), ("stencil", pyramid.pyr_down)):
            def build(a, down=down):
                pyr = [a]
                for _ in range(4):
                    pyr.append(down(pyr[-1]))
                return pyr
            fn = jax.jit(build)
            out = fn(x)
            emit(study="pyramid", form=form, h=h, w=w,
                 ms=device_time(fn, x) * 1e3,
                 checksum=float(sum(jnp.sum(o) for o in out)))


def bilateral_study() -> None:
    pf = of.BilateralConfig()
    for h, w in [(480, 640), (1080, 1920)]:
        x = jnp.stack(list(pair(h, w)))
        fn = jax.jit(lambda a: bilateral_filter(a, None, pf.window, pf.sigma_spatial, pf.sigma_range))
        emit(study="bilateral", impl="xla", h=h, w=w, ms=device_time(fn, x) * 1e3)


def pipeline_study() -> None:
    for name, cfg, (h, w) in [("PAPER_1080P", of.PAPER_1080P, (1080, 1920)),
                              ("REFERENCE_GPU", of.REFERENCE_GPU, (480, 640))]:
        p, n = pair(h, w)
        for use_pallas in (False, True, True, False):
            c = dataclasses.replace(cfg, use_pallas=use_pallas)
            fn = jax.jit(lambda a, b, c=c: of.pyramidal_lk(a, b, c))
            flow = np.asarray(fn(p, n))
            emit(study="pipeline", config=name, h=h, w=w,
                 use_pallas=use_pallas, ms=device_time(fn, p, n) * 1e3,
                 median_flow=[float(v) for v in np.median(flow[h // 8:-h // 8, w // 8:-w // 8], axis=(0, 1))])


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--only", default="residual,pyramid,bilateral,pipeline")
    args = ap.parse_args()
    require_gpu("gpu_kernel_study.py")
    enable_compile_cache()
    emit(**device_info())
    studies = {"residual": lambda: residual_study(args.quick), "pyramid": pyramid_study,
               "bilateral": bilateral_study, "pipeline": pipeline_study}
    for name in args.only.split(","):
        studies[name]()
    os.makedirs("chiprun_out", exist_ok=True)
    with open("chiprun_out/gpu_kernel_study.json", "w") as f:
        json.dump(RESULTS, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
