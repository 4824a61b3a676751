"""Demo CLI — the headless twin of the reference's webcam app (main.cu).

The reference's only executable is a webcam loop with OpenCV debug windows;
accelerator hosts are headless, so this demo consumes synthetic sequences or image
files and writes PNG artifacts (flow color wheel, arrow overlays, per-level
gradient maps a la showTest) plus an fps/EPE report to stdout.

Examples:

    python -m cuda_optical_flow_2_tpu.cli.demo --synthetic 10 --out /tmp/flow
    python -m cuda_optical_flow_2_tpu.cli.demo --frames 'seq/*.png' --levels 4 \
        --window 19 --out /tmp/flow --debug-gradients
"""

from __future__ import annotations

import argparse
import glob
import os
import time

import numpy as np

import jax.numpy as jnp

import cuda_optical_flow_2_tpu as of
from cuda_optical_flow_2_tpu.models import streaming
from cuda_optical_flow_2_tpu.ops.color import grayscale
from cuda_optical_flow_2_tpu.ops.conv import conv2d
from cuda_optical_flow_2_tpu.ops.pyramid import build_pyramid
from cuda_optical_flow_2_tpu.ops.resize import upscale_nn
from cuda_optical_flow_2_tpu.constants import DT_3X3_N, DX_3X3, DY_3X3
from cuda_optical_flow_2_tpu.utils import io, native, viz

__all__ = ["main"]


def _load_frames(args) -> np.ndarray:
    if args.frames:
        if args.frames.endswith(".y4m"):
            frames = [f.astype(np.float32) for f in io.read_y4m(args.frames)]
            if len(frames) < 2:
                raise SystemExit(f"need >= 2 frames in {args.frames}")
            return np.stack(frames)
        paths = sorted(glob.glob(args.frames))
        if len(paths) < 2:
            raise SystemExit(f"need >= 2 frames, matched {len(paths)}: {args.frames}")
        frames = []
        for p in paths:
            img = io.read_image(p)
            if img.ndim == 3:
                img = np.asarray(grayscale(jnp.asarray(img)))
            frames.append(img.astype(np.float32))
        return np.stack(frames)
    h, w = (int(t) for t in args.size.split("x"))
    # noise=0.0 matches FrameStream.synthetic (native and fallback), so
    # --native-stream changes only the ingestion path, not the data — an
    # A/B of the prefetching pipeline must not be confounded by the input.
    return io.synthetic_sequence(
        args.synthetic, h, w, velocity=tuple(args.velocity), noise=0.0
    ).astype(np.float32)


def _dump_gradients(frame, prev_frame, levels: int, out_dir: str, idx: int) -> None:
    """showTest twin (main.cu:19-92): per-level Ix/Iy/It maps, binarized and
    upscaled to full resolution."""
    pyr = build_pyramid(jnp.asarray(frame), levels)
    prev_pyr = build_pyramid(jnp.asarray(prev_frame), levels)
    for k, (lvl, plvl) in enumerate(zip(pyr, prev_pyr)):
        maps = {
            "x": conv2d(lvl, DX_3X3),
            "y": conv2d(lvl, DY_3X3),
            "t": conv2d(lvl, DT_3X3_N) - conv2d(plvl, DT_3X3_N),
        }
        for name, m in maps.items():
            u8 = np.asarray(jnp.clip(jnp.abs(m), 0, 255)).astype(np.uint8)
            binz = viz.cleanup_outliers(u8)
            up = np.asarray(upscale_nn(jnp.asarray(binz), k))
            viz.write_png(
                os.path.join(out_dir, f"frame{idx:04d}_L{k}_I{name}.png"), up
            )


def main(argv=None) -> None:
    from cuda_optical_flow_2_tpu.cli import xla_only
    from cuda_optical_flow_2_tpu.utils.profiling import enable_compile_cache

    enable_compile_cache()
    ap = argparse.ArgumentParser(description=__doc__)
    src = ap.add_mutually_exclusive_group()
    src.add_argument(
        "--frames",
        help="glob of input frames (png/ppm/npy), or a .y4m video file",
    )
    src.add_argument(
        "--synthetic", type=int, default=8, help="number of synthetic frames"
    )
    ap.add_argument("--size", default="480x640", help="synthetic frame size HxW")
    ap.add_argument(
        "--velocity", type=float, nargs=2, default=(2.0, 1.0),
        help="synthetic ground-truth velocity (vx vy) px/frame",
    )
    ap.add_argument(
        "--model", default="lk", choices=("lk", "hs", "fb", "tvl1", "dis"),
        help="flow model: pyramidal Lucas-Kanade (reference pipeline), "
        "Horn-Schunck (global variational), Farneback (polynomial "
        "expansion), TV-L1 (robust primal-dual) or DIS (mean-normalized "
        "inverse search + variational refinement) — extensions beyond lk",
    )
    ap.add_argument("--levels", type=int, default=4)
    ap.add_argument("--window", type=int, default=19)
    ap.add_argument(
        "--window-weights", default=None, choices=("box", "tri", "gauss"),
        help="integration-window weighting for lk/dis (default: the "
        "config's default, 'tri' for lk / 'box' for dis — see "
        "LKConfig.window_weights)",
    )
    ap.add_argument(
        "--iterations", type=int, default=None,
        help="LK solver iterations (default 1) / HS sweeps per level (default 100)",
    )
    ap.add_argument(
        "--alpha", type=float, default=10.0, help="HS smoothness weight"
    )
    ap.add_argument(
        "--temporal-kernel", default="gauss3", choices=("dt3", "gauss3")
    )
    ap.add_argument("--bilateral", action="store_true", help="enable pre-filter")
    ap.add_argument(
        "--median", type=int, default=None,
        help="TV-L1 flow median filter size (odd; 0 = off; default: the "
        "config default 5, matching OpenCV DualTVL1)",
    )
    ap.add_argument(
        "--no-pallas", action="store_true",
        help="run the XLA twin instead of the fused GPU residual kernel",
    )
    ap.add_argument("--out", default=None, help="artifact output directory")
    ap.add_argument("--arrow-res", type=int, default=30)
    ap.add_argument(
        "--debug-gradients", action="store_true",
        help="dump per-level Ix/Iy/It maps (showTest twin)",
    )
    ap.add_argument(
        "--flo", action="store_true",
        help="also write Middlebury .flo flow files next to the PNGs",
    )
    ap.add_argument(
        "--occlusion", action="store_true",
        help="also estimate backward flow per pair and write the "
        "forward-backward occlusion mask (white = untrusted)",
    )
    ap.add_argument(
        "--warm-start", action="store_true",
        help="seed each pair's coarsest level with the previous pair's flow "
        "(serving mode: combine with a shallow --levels)",
    )
    ap.add_argument(
        "--recover-levels", type=int, default=None, metavar="N",
        help="with --warm-start: on-device scene-cut detection; invalid "
        "warm seeds re-acquire over an N-level pyramid "
        "(models.streaming.RecoveryConfig)",
    )
    ap.add_argument(
        "--native-stream", action="store_true",
        help="feed frames through the native prefetching FrameStream "
        "(C++ worker + ring buffer) instead of materializing the sequence",
    )
    src.add_argument(
        "--camera", default=None, metavar="DEV",
        help="capture live from a V4L2 camera device (e.g. /dev/video0) — "
        "the reference's webcam source; implies the native stream path",
    )
    ap.add_argument(
        "--camera-frames", type=int, default=64,
        help="frames to process from --camera before exiting (0 = until "
        "the stream ends)",
    )
    ap.add_argument(
        "--out-video", default=None, metavar="FLOW.y4m",
        help="write the flow-color frames as one Y4M video (play with "
        "`ffplay FLOW.y4m` — the headless twin of the reference's live "
        "imshow window); works for unbounded streams (constant memory)",
    )
    ap.add_argument(
        "--track", type=int, default=0, metavar="N",
        help="track an NxN grid of points through the stream (sparse "
        "pyramidal-LK tracker role) and write tracks####.png trajectory "
        "overlays to --out",
    )
    ap.add_argument(
        "--viz-max-flow", type=float, default=None, metavar="PX",
        help="fixed |flow| mapped to full color saturation in the PNG/video "
        "renders; default normalizes per frame, which flickers across a "
        "video when the peak motion varies",
    )
    args = ap.parse_args(argv)
    recovery = None
    if args.recover_levels is not None:
        if not args.warm_start:
            ap.error("--recover-levels requires --warm-start")
        recovery = streaming.RecoveryConfig(levels=args.recover_levels)

    stream = None
    if args.native_stream or args.camera:
        if args.camera:
            # Live webcam capture — the reference's cv::VideoCapture(0)
            # source (main.cu:181-184), through the native V4L2 runtime.
            # Unbounded; --camera-frames caps the CLI session.
            stream = native.FrameStream.from_v4l2(args.camera)
        elif args.frames and args.frames.endswith(".y4m"):
            stream = native.FrameStream.from_y4m(args.frames)
        elif args.frames:
            paths = sorted(glob.glob(args.frames))
            if len(paths) < 2:
                raise SystemExit(f"need >= 2 frames, matched {len(paths)}")
            stream = native.FrameStream.from_ppm(paths)
        else:
            h, w = (int(t) for t in args.size.split("x"))
            vx_, vy_ = args.velocity
            stream = native.FrameStream.synthetic(
                args.synthetic, h, w, vx=vx_, vy=vy_
            )
        recent: dict[int, np.ndarray] = {}

        def _record(src):
            # Keep the last two GOOD frames (None = decode failure, skipped
            # by process_sequence; the pair then spans the gap, so "prev"
            # is the last good index, not i-1).
            good: list[int] = []
            for i, (_, f) in enumerate(src):
                if f is not None:
                    recent[i] = f
                    good.append(i)
                    if len(good) > 2:
                        recent.pop(good.pop(0), None)
                yield f

        frames = None
        src = stream
        if args.camera and args.camera_frames:
            import itertools

            src = itertools.islice(iter(stream), args.camera_frames)
        frame_iter = _record(src)
    else:
        frames = _load_frames(args)
        frame_iter = iter(frames)
    prefilter = of.BilateralConfig() if args.bilateral else None
    if args.model == "tvl1":
        from cuda_optical_flow_2_tpu.models.tvl1 import TVL1Config

        cfg = TVL1Config(
            levels=args.levels,
            iterations=args.iterations if args.iterations is not None else 30,
            **({} if args.median is None else {"median_filtering": args.median}),
            prefilter=prefilter,
        )
    elif args.model == "dis":
        from cuda_optical_flow_2_tpu.models.dis import DISConfig

        cfg = DISConfig(
            levels=args.levels,
            window=args.window if args.window % 2 else args.window + 1,
            iterations=args.iterations if args.iterations is not None else 2,
            **({} if args.window_weights is None
               else {"window_weights": args.window_weights}),
            prefilter=prefilter,
        )
    elif args.model == "fb":
        from cuda_optical_flow_2_tpu.models.farneback import FBConfig

        cfg = FBConfig(
            levels=args.levels,
            iterations=args.iterations if args.iterations is not None else 3,
            winsize=args.window if args.window % 2 else args.window + 1,
            prefilter=prefilter,
        )
    elif args.model == "hs":
        from cuda_optical_flow_2_tpu.models.horn_schunck import HSConfig

        cfg = HSConfig(
            alpha=args.alpha,
            iterations=args.iterations if args.iterations is not None else 100,
            levels=args.levels,
            temporal_kernel=args.temporal_kernel,
            prefilter=prefilter,
        )
    else:
        cfg = of.LKConfig(
            levels=args.levels,
            window=args.window,
            iterations=args.iterations if args.iterations is not None else 1,
            temporal_kernel=args.temporal_kernel,
            **({} if args.window_weights is None
               else {"window_weights": args.window_weights}),
            prefilter=prefilter,
        )
    if args.no_pallas:
        cfg = xla_only(cfg)
    if args.out:
        os.makedirs(args.out, exist_ok=True)

    backward_flow = None
    if args.out and args.occlusion:
        # Jitted ONCE outside the frame loop (config is static) — the
        # backward pass otherwise re-dispatches eagerly per frame, the exact
        # per-op pathology the framework exists to avoid.
        import functools

        import jax

        from cuda_optical_flow_2_tpu.models import pyramidal_flow

        backward_flow = jax.jit(functools.partial(pyramidal_flow, config=cfg))

    track_pts = track_alive = None
    track_hist: "deque[np.ndarray]" = None
    if args.track:
        from collections import deque

        track_hist = deque(maxlen=24)  # bounded trail on unbounded streams

    # Flow-color rendering runs ON DEVICE (viz.flow_to_color_device): the
    # NumPy pass costs seconds per 1080p frame on a weak host CPU and would
    # cap the live view; on the device the host fetches 3 B/px of uint8 RGB
    # instead of running the colorize in the frame loop.
    import jax as _jax

    _render = _jax.jit(viz.flow_to_color_device, static_argnums=(1,))
    render = lambda fl: np.asarray(_render(fl, args.viz_max_flow))  # noqa: E731

    vx, vy = args.velocity
    t0 = time.perf_counter()
    count = 0
    video = io.Y4MWriter(args.out_video) if args.out_video else None
    try:
        for i, flow in streaming.process_sequence(
            frame_iter, cfg, warm_start=args.warm_start, recovery=recovery
        ):
            flow_np = np.asarray(flow)
            count += 1
            msg = f"frame {i}: |flow| median {np.median(np.hypot(flow_np[...,0], flow_np[...,1])):.3f}"
            if args.frames is None:
                m = min(24, flow_np.shape[0] // 4, flow_np.shape[1] // 4)
                inner = flow_np[m : flow_np.shape[0] - m, m : flow_np.shape[1] - m]
                # After a decode failure the pair spans the gap, so the true
                # displacement is (frames skipped + 1) x the per-frame velocity.
                gap = 1 if frames is not None else i - max(k for k in recent if k < i)
                ex, ey = gap * vx, gap * vy
                epe = float(np.hypot(inner[..., 0] - ex, inner[..., 1] - ey).mean())
                msg += f"  EPE vs ({ex}, {ey}): {epe:.3f}"
            print(msg, flush=True)
            if video is not None:
                video.write(render(flow))
            if args.out:
                cur = frames[i] if frames is not None else recent[i]
                prv = (
                    frames[i - 1]
                    if frames is not None
                    else recent[max(k for k in recent if k < i)]
                )
                viz.write_png(
                    os.path.join(args.out, f"flow{i:04d}.png"), render(flow)
                )
                if args.flo:
                    io.write_flo(
                        os.path.join(args.out, f"flow{i:04d}.flo"), flow_np
                    )
                viz.write_png(
                    os.path.join(args.out, f"arrows{i:04d}.png"),
                    viz.draw_flow_arrows(cur.astype(np.uint8), flow_np, args.arrow_res),
                )
                if args.occlusion:
                    from cuda_optical_flow_2_tpu.models import occlusion_mask

                    bw = backward_flow(
                        jnp.asarray(cur.astype(np.float32)),
                        jnp.asarray(prv.astype(np.float32)),
                    )
                    occ = np.asarray(occlusion_mask(jnp.asarray(flow_np), bw))
                    viz.write_png(
                        os.path.join(args.out, f"occ{i:04d}.png"),
                        (occ * 255).astype(np.uint8),
                    )
                if args.debug_gradients:
                    _dump_gradients(cur, prv, min(args.levels, 3), args.out, i)
            if args.track:
                from cuda_optical_flow_2_tpu.models import tracking

                if track_pts is None:
                    h_, w_ = flow_np.shape[:2]
                    gy, gx = np.mgrid[1 : args.track + 1, 1 : args.track + 1]
                    track_pts = jnp.asarray(
                        np.stack(
                            [
                                gx.ravel() * w_ / (args.track + 1),
                                gy.ravel() * h_ / (args.track + 1),
                            ],
                            -1,
                        ).astype(np.float32)
                    )
                track_pts, track_alive = tracking._advect_jit(
                    flow, track_pts, track_alive
                )
                track_hist.append(np.asarray(track_pts))
                if args.out:
                    cur = frames[i] if frames is not None else recent[i]
                    viz.write_png(
                        os.path.join(args.out, f"tracks{i:04d}.png"),
                        viz.draw_tracks(
                            cur.astype(np.uint8), track_hist,
                            np.asarray(track_alive),
                        ),
                    )
    finally:
        if video is not None:
            video.close()
        if stream is not None:
            stream.close()  # joins the C++ worker even on mid-loop errors
    dt = time.perf_counter() - t0
    print(f"{count} frames in {dt:.2f}s  ({count/dt:.1f} fps end-to-end incl. host IO)")


if __name__ == "__main__":
    main()
