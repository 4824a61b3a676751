"""Streaming video flow: carried pyramid state across frames.

Device-resident replacement for the reference's main loop state management
(main.cu:222-275): the reference keeps prev/cur image pyramids in host memory
and pointer-swaps them each frame (main.cu:270-272); here the carried state is
a device-resident pytree of pyramid levels, the per-frame step is one jitted
function, and the state buffers are donated so XLA reuses them in place — the
functional equivalent of the pointer swap, with zero host round trips.

    state = init_state(first_frame, config)
    for frame in frames:
        state, flow = step(state, frame, config)   # jitted, donates state
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import lax

from cuda_optical_flow_2_tpu.models.farneback import (
    FBConfig,
    fb_coarse_to_fine,
    fb_preprocess,
)
from cuda_optical_flow_2_tpu.models.horn_schunck import (
    HSConfig,
    hs_coarse_to_fine,
    hs_preprocess,
)
from cuda_optical_flow_2_tpu.models.lucas_kanade import (
    _validate,
    coarse_to_fine,
    preprocess,
)
from cuda_optical_flow_2_tpu.models.tvl1 import (
    TVL1Config,
    tvl1_coarse_to_fine,
    tvl1_preprocess,
)
from cuda_optical_flow_2_tpu.models.dis import (
    DISConfig,
    dis_coarse_to_fine,
    dis_preprocess,
)
from cuda_optical_flow_2_tpu.ops.resize import downsample_flow

__all__ = [
    "FlowState",
    "RecoveryConfig",
    "init_state",
    "step",
    "process_sequence",
]


@dataclasses.dataclass(frozen=True)
class RecoveryConfig:
    """Scene-cut detection + warm-state recovery policy for warm streaming.

    The recommended serving configuration (warm start + shallow pyramid,
    docs/PERF.md "Warm-start serving") tracks large motion because every
    pair is seeded with the previous pair's flow.  A scene cut with valid
    decodes breaks the premise: the seed describes the OLD scene's motion,
    and with ``levels=1`` the single level cannot re-acquire motion beyond
    ~2 px from a garbage seed — one cut loses lock permanently (the
    eval-harness lock-loss test measures exactly this failure).

    With a ``RecoveryConfig``, :func:`step` runs a cheap on-device
    acquisition check before using the seed: the mean photometric residual
    of the deepest carried pyramid level warped by the seed, against the
    zero-flow residual of the same pair.  Locked tracking explains the
    coarse frame difference far better than doing nothing (measured
    r_seed/r_zero 0.27-0.43 on the harness cases); a post-cut stale seed
    does not (0.85-1.0).  When the check fails
    (``r_seed >= ratio * r_zero`` with a non-trivial seed) the seed is
    dropped and the pair is solved from scratch over a DEEPER pyramid
    (``levels``), restoring the cold acquisition range for that one frame;
    tracking resumes warm on the next pair.  Cold starts (no seed yet —
    stream start, or after a decode failure dropped the seed) also solve at
    the recovery depth: the policy is acquire deep, track shallow.

    The failure asymmetry shapes the defaults: a FALSE POSITIVE (valid
    seed dropped) costs one deep solve — slower, equally accurate; a FALSE
    NEGATIVE (stale seed kept) loses lock for the rest of the stream.  So
    the threshold sits well below 1.0, and seeds near zero motion are
    always kept (``seed_floor``) — dropping a ~0 seed changes nothing
    accuracy-wise but would put static scenes (r_seed ~= r_zero ~= sensor
    noise, ratio ~= 1) permanently on the slow deep path.

    Attributes:
      levels: pyramid depth for the recovery/acquisition solve.  The
        carried state always holds ``max(levels, config.levels)`` pyramid
        levels; the extra coarse levels are tiny (4x smaller per level),
        only the fallback branch of a ``lax.cond`` solves over them, and
        the acquisition check reads the deepest one (so its warp runs at
        1/4^(levels-1) the frame area — noise next to the solve).
      ratio: the seed is dropped when ``r_seed >= ratio * r_zero`` (mean
        |residual| at the deepest carried level).  Default 0.7, validated
        across a 54-condition grid (texture class x velocity x noise x
        cut type, docs/studies/recovery_threshold_study.py): every
        harmful stale seed measures >= 0.818, so no false negative
        appears; locked ratios are 0.27-0.56 on normal content but reach
        0.73 on low-contrast diagonal motion — such content trips the
        check and runs the deep (cold-accurate) solve at lower fps, the
        designed failure direction.  Raise toward ~0.8 only to buy back
        throughput on content like that, at a thinner lock-loss margin.
      seed_floor: keep the seed regardless of the ratio when its mean
        magnitude (px, at the deepest level's scale) is below this.
    """

    levels: int = 3
    ratio: float = 0.7
    seed_floor: float = 0.25

    def __post_init__(self) -> None:
        if self.levels < 1:
            raise ValueError(f"levels must be >= 1, got {self.levels}")
        if not 0.0 < self.ratio:
            raise ValueError(f"ratio must be > 0, got {self.ratio}")
        if self.seed_floor < 0:
            raise ValueError(
                f"seed_floor must be >= 0, got {self.seed_floor}"
            )


def _preprocess(frame: jax.Array, config) -> list[jax.Array]:
    """Model-generic preprocess: dispatches on the config type
    (LK/HS/FB/TVL1/DIS)."""
    if isinstance(config, HSConfig):
        return hs_preprocess(frame, config)
    if isinstance(config, FBConfig):
        return fb_preprocess(frame, config)
    if isinstance(config, TVL1Config):
        return tvl1_preprocess(frame, config)
    if isinstance(config, DISConfig):
        return dis_preprocess(frame, config)
    return preprocess(frame, config)


def _flow(
    prev_pyr: list[jax.Array],
    next_pyr: list[jax.Array],
    config,
    init_flow: jax.Array | None = None,
) -> jax.Array:
    if isinstance(config, HSConfig):
        return hs_coarse_to_fine(prev_pyr, next_pyr, config, init_flow)
    if isinstance(config, FBConfig):
        return fb_coarse_to_fine(prev_pyr, next_pyr, config, init_flow)
    if isinstance(config, TVL1Config):
        return tvl1_coarse_to_fine(prev_pyr, next_pyr, config, init_flow)
    if isinstance(config, DISConfig):
        return dis_coarse_to_fine(prev_pyr, next_pyr, config, init_flow)
    return coarse_to_fine(prev_pyr, next_pyr, config, init_flow)[0]


class FlowState(NamedTuple):
    """Carried per-stream state: the previous frame's pyramid (coarse last)
    and, when warm-starting, the previous pair's flow (else None)."""

    pyramid: tuple[jax.Array, ...]
    flow: jax.Array | None = None


def _carry_config(config, recovery: RecoveryConfig | None):
    """The config whose pyramid depth the carried state is built at."""
    if recovery is None or recovery.levels <= config.levels:
        return config
    return dataclasses.replace(config, levels=recovery.levels)


@functools.partial(jax.jit, static_argnames=("config", "recovery"))
def init_state(
    frame: jax.Array, config, recovery: RecoveryConfig | None = None
) -> FlowState:
    """Build the initial state from the first frame (main.cu:209 equivalent).

    ``config`` is an :class:`LKConfig` or :class:`HSConfig` — the streaming
    layer is model-generic over the pyramidal families.  Pass the same
    ``recovery`` given to :func:`step`: the state then carries the deeper
    acquisition pyramid (see :class:`RecoveryConfig`).
    """
    carry_cfg = _carry_config(config, recovery)
    return FlowState(tuple(_preprocess(frame.astype(jnp.float32), carry_cfg)))


@functools.partial(
    jax.jit,
    static_argnames=("config", "warm_start", "recovery"),
    donate_argnums=(0,),
)
def step(
    state: FlowState,
    frame: jax.Array,
    config,
    warm_start: bool = False,
    recovery: RecoveryConfig | None = None,
) -> tuple[FlowState, jax.Array]:
    """One frame step: returns (new state, dense flow prev->frame).

    The old pyramid buffers are donated; XLA writes the new pyramid into
    them — the device-resident version of the reference's pointer swap
    (main.cu:270-272).

    ``warm_start=True`` seeds the coarsest level with the previous pair's
    flow (downsampled through the pyramid's floor-halving grids).  Tracked
    motion then stays within the per-level search range even with a shallow
    pyramid — the serving configuration is fewer levels + warm start.

    ``recovery`` (warm-start only) arms scene-cut detection: the seed is
    validated on device against the zero-flow photometric residual and
    invalid seeds fall back to a fresh solve over a deeper pyramid — see
    :class:`RecoveryConfig`.  Both branches live under one ``lax.cond`` in
    the single jitted program; per-step cost of the check itself is one
    bilinear warp plus two mean reductions at the coarsest tracking level.
    """
    if recovery is not None and not warm_start:
        raise ValueError("recovery requires warm_start=True")
    carry_cfg = _carry_config(config, recovery)
    pyr = _preprocess(frame.astype(jnp.float32), carry_cfg)
    if len(state.pyramid) != len(pyr):
        raise ValueError(
            f"state carries {len(state.pyramid)} pyramid levels but this "
            f"config/recovery needs {len(pyr)}; build the state with "
            f"init_state(frame, config, recovery)"
        )
    track = config.levels  # levels used by the warm tracking solve
    init = None
    if warm_start and state.flow is not None:
        init = downsample_flow(state.flow, pyr[track - 1].shape[-2:])

    if recovery is None or init is None:
        if recovery is not None:
            # Cold start under a recovery policy: acquire at the deep config
            # (stream start / post-decode-failure re-acquisition).
            flow = _flow(list(state.pyramid), pyr, carry_cfg, None)
        else:
            flow = _flow(list(state.pyramid), pyr, config, init)
        return FlowState(tuple(pyr), flow if warm_start else None), flow

    # Acquisition check at the DEEPEST carried level: does the seed explain
    # the frame difference better than zero flow?  After a scene cut it
    # does not (the seed describes the old scene's motion).  The deepest
    # level (not the coarsest tracking level) keeps the check cheap at the
    # serving config — with levels=1 the tracking pyramid is full-res, but
    # the recovery pyramid's top is 4^(levels-1)x smaller.
    from cuda_optical_flow_2_tpu.ops.warp import warp_bilinear as warp

    prev_c = state.pyramid[-1]
    next_c = pyr[-1]
    seed_c = downsample_flow(state.flow, next_c.shape[-2:])
    # Per-STREAM residual means (frames may carry leading batch dims — a
    # batch of independent streams under DP sharding): a cut in one stream
    # must not dilute into the batch mean.
    r_seed = jnp.mean(jnp.abs(warp(next_c, seed_c) - prev_c), axis=(-2, -1))
    r_zero = jnp.mean(jnp.abs(next_c - prev_c), axis=(-2, -1))
    small_seed = (
        jnp.mean(jnp.abs(seed_c), axis=(-3, -2, -1))
        < jnp.float32(recovery.seed_floor)
    )
    seed_ok = small_seed | (r_seed < jnp.float32(recovery.ratio) * r_zero)

    def _track(_):
        return _flow(list(state.pyramid[:track]), pyr[:track], config, init)

    def _reacquire(_):
        # Any invalid stream re-acquires the WHOLE batch at the deep config
        # (a per-stream branch is impossible under jit without paying for
        # both solves everywhere; the deep solve is the accurate cold path
        # for every stream, so valid streams lose only throughput, and only
        # on cut events).
        return _flow(list(state.pyramid), pyr, carry_cfg, None)

    flow = lax.cond(jnp.all(seed_ok), _track, _reacquire, None)
    return FlowState(tuple(pyr), flow), flow


def process_sequence(
    frames,
    config,
    warm_start: bool = False,
    recovery: RecoveryConfig | None = None,
):
    """Convenience driver: yields (frame_index, flow) for frames[1:].

    ``frames`` is any iterable of (H, W) arrays (NumPy or jax) — finite OR
    unbounded (the live-capture twin of the reference's while(true) loop,
    main.cu:222-275).  A :class:`utils.native.FrameStream` yields
    ``(t, frame)`` tuples, so unpack it first::

        with FrameStream.synthetic(None, h, w, vx=2, vy=1) as src:
            for i, flow in process_sequence((f for _, f in src), cfg):
                ...
    ``config`` selects the model family (LKConfig / HSConfig / FBConfig /
    TVL1Config / DISConfig).  Host->device transfer happens once per frame at this
    boundary — the reference crosses PCIe ~24 times per level per frame
    (SURVEY.md section 3.1) — and in the frame's NATIVE dtype: a uint8
    source (PNG/Y4M/native stream) ships 1 byte/px over the host link and
    is cast to float32 on device inside the jitted step, not 4 bytes/px
    after a host-side cast.  ``warm_start`` seeds each pair with the
    previous pair's flow (see :func:`step`).

    Decode-failure recovery: a ``None`` element (how
    :class:`utils.native.FrameStream` reports a per-frame decode failure)
    is SKIPPED — no flow is yielded for it, the next good frame pairs with
    the last good frame, and the carried warm flow is dropped (the motion
    gap across the lost frame invalidates it as a seed).  Memory stays
    bounded: the carried state is one pyramid + one flow regardless of
    stream length.

    ``recovery`` (with ``warm_start=True``) arms on-device scene-cut
    detection and deep re-acquisition — see :class:`RecoveryConfig`.
    """
    it = iter(frames)
    # Pull frames until the first GOOD one (leading decode failures skip).
    first = None
    offset = 0
    for offset, frame in enumerate(it):
        if frame is not None:
            first = jnp.asarray(frame)
            break
    if first is None:
        return
    # Shape/levels validation is model-generic (every config has .levels);
    # fail with the friendly error before tracing any model's preprocess.
    _validate(first, first, _carry_config(config, recovery))
    state = init_state(first, config, recovery)
    for i, frame in enumerate(it, start=offset + 1):
        if frame is None:
            if state.flow is not None:
                state = FlowState(state.pyramid, None)
            continue
        state, flow = step(
            state, jnp.asarray(frame), config, warm_start, recovery
        )
        yield i, flow
