"""The frame-loop pipeline: tracking + depth refinement + keyframing.

Port of ``egomotion_with_local_loop_closures_tpu/runtime/pipeline.py``
(the reference's frame loop, ``src/main.cpp:199-505``) in GN mode.  Each
non-keyframe frame runs :func:`track_refine_step` (pyramid -> align ->
stereo.observe -> doRegularization -> depth-pyramid rebuild); every
``keyframe_interval``-th frame runs :func:`keyframe_step`.

The JAX package runs a keyframe interval as one compiled program (a
``lax.scan`` under ``jax.jit``) and, without the loop window, up to
``intervals_per_dispatch`` intervals in one dispatch
(:func:`process_intervals`), to amortize the host's latency per dispatch
(its ``runner.py``): at this resolution that latency dominates a single
interval, which makes batching intervals the main single-video throughput
lever.  Here :func:`process_interval` on a CUDA state replays one captured
CUDA graph of the whole interval (``runtime/graphs.py``): its body
:func:`_interval` runs the step bodies ``_track_refine_step`` and
``_keyframe_step`` over the interval's frames and stacks the outputs, and
the state is copied into the graph and cloned out once an interval.
:func:`process_intervals`, ``parallel/sharded.py::batched_process_interval``
and LC mode's batches take that graph, one for each frame count (K-1 for
a sequence's first interval, K after it).  :func:`track_refine_step` and
:func:`keyframe_step` called alone replay a graph of the one step:
``runtime/runner.py``'s frame-at-a-time loop (recovery, outputs read
late) and LC mode's tail.  On a CPU state every body runs eagerly.  A
Python loop over the steps takes the place of ``lax.scan``, and nothing
here waits for the device except the caller reading the outputs.  The
JAX package's masked intervals (``valid``/``kf_valid``, one XLA program
for every interval length of LC mode) have no counterpart: a graph is
captured for each frame count.  Nor has
``process_interval(s)_with_fallback``, which reruns intervals whose
window-warp gather clipped; the port's gather is exact.

Depth regularization goes through the CUDA kernel's wrappers
(``ops/reg_kernel.py``), which use the plain PyTorch version for tensors
on the CPU.

The port implements the exact form of every TPU-only layout switch and
reads none of these config fields: ``use_window_warp``, ``warp_window``,
``warp_window_rematch``, ``warp_oow_fallback``, ``warp_valid_floor``,
``stereo_compact_frac``, ``stereo_short_steps``, ``stereo_short_frac``,
``stereo_pack_u8``, ``use_pallas_reg``.  The JAX settings that compute the
same thing are ``config.PARITY_OVERRIDES``.

With the loop window on (``do_loop_closure`` or ``restore_connection``)
each tracked frame also accumulates its GN weight images into the
keyframe (``Keyframe.weight_acc``), and :func:`keyframe_step` returns the
finalized old keyframe, its depth state included, as a
:class:`KeyframeSnapshot` for the window.  The LC replay tracks with
``cfg.max_iters_replay`` and seeds each frame's rotation from the
rotation-averaged world pose (``init_rotation``).  Connection recovery
(``loop/recovery.py``) is driven by the runner, and undistortion by
:func:`undistort_source`, the frame source of both runners.

Every step also advances V videos at once when its state carries a
leading video axis (every tensor (V, ...), built by
``parallel.sharded.batched_init``) and its frames are (V, H, W): the same
calls and launches as one video, each on V videos' data.

While a profiler records, :func:`init_pipeline`, :func:`process_interval`
and each frame step mark their span on the trace's clock
(``utils/profiling.span``): ``ellc.init``, ``ellc.interval`` around an
interval and its graph's phases (``runtime/graphs.py``), and
``ellc.step.track_refine`` or ``ellc.step.keyframe`` around a step
called alone and its graph's phases, or around a step of an interval's
body where it runs eagerly (:func:`_interval`).
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Iterator, Optional, Tuple

import numpy as np
import torch

from egomotion_with_local_loop_closures_tpu_torch.config import ELLCConfig
from egomotion_with_local_loop_closures_tpu_torch.depth import (
    fusion, propagate, state as dstate, stereo)
from egomotion_with_local_loop_closures_tpu_torch.geom import camera, lie
from egomotion_with_local_loop_closures_tpu_torch.image import pyramid
from egomotion_with_local_loop_closures_tpu_torch.ops import reg_kernel
from egomotion_with_local_loop_closures_tpu_torch.runtime import graphs
from egomotion_with_local_loop_closures_tpu_torch.track import alignment
from egomotion_with_local_loop_closures_tpu_torch.utils import profiling


@dataclasses.dataclass(frozen=True)
class Keyframe:
    """Device-resident keyframe: image pyramid, level-0 gradients and the
    per-level depth/var pyramids consumed by the tracker."""
    images: Tuple[torch.Tensor, ...]    # image pyramid, level 0..L-1
    depths: Tuple[torch.Tensor, ...]    # depth pyramid (0 = invalid)
    vars_: Tuple[torch.Tensor, ...]     # variance pyramid (-1 = invalid)
    gradx: torch.Tensor                 # level-0 gradients (depth filter)
    grady: torch.Tensor
    maxgrad: torch.Tensor               # 3x3-dilated max gradient, level 0
    world_pose: torch.Tensor            # (6,) poseWrtWorld of this KF
    rescale: torch.Tensor               # scalar rescaleFactor
    # GN weight images accumulated per level for the loop-closure rematch
    # (saveWeights, PixelWisePyramid.cpp:544-551); empty unless the loop
    # window is on
    weight_acc: Tuple[torch.Tensor, ...]
    weight_count: torch.Tensor          # scalar

    def replace(self, **kw) -> "Keyframe":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class KeyframeSnapshot:
    """A finalized keyframe as pushed to the loop-closure window
    (globalOptimize::pushToArray, GlobalOptimize.cpp:178-223)."""
    image: torch.Tensor
    kf_levels: Tuple[alignment.KeyframeLevel, ...]
    weight_levels: Tuple[torch.Tensor, ...]   # averaged (finaliseWeights)
    world_pose: torch.Tensor
    rescale: torch.Tensor
    seeds: torch.Tensor
    # the keyframe's hypothesis state, for connection recovery
    # (LoopFrame.h:33 this_currentDepthMap)
    depth_state: dstate.DepthMapState


@dataclasses.dataclass(frozen=True)
class PipelineState:
    """One video's state; in a batched state every tensor has a leading
    video axis, (V, ...)."""
    kf: Keyframe
    depth: dstate.DepthMapState
    prev_wrt_kf: torch.Tensor      # (6,) pose of frame t-1 w.r.t. the KF
    global_scale: torch.Tensor     # scalar GLOABL_DEPTH_SCALE

    @property
    def device(self) -> torch.device:
        return self.prev_wrt_kf.device


@dataclasses.dataclass(frozen=True)
class FrameOutput:
    """Per-frame results mirroring a poses_orig.txt line; in a stacked
    output every field has a leading frame axis."""
    pose_wrt_kf: torch.Tensor      # (6,)
    pose_wrt_world: torch.Tensor   # (6,)
    rescale: torch.Tensor          # keyframe rescaleFactor
    seeds: torch.Tensor            # depth occupancy %
    weighted_pose: torch.Tensor
    valid_fraction: torch.Tensor
    oow_fraction: torch.Tensor     # always 0: the port samples exactly


def _image(image, device) -> torch.Tensor:
    """An (H, W) frame or map (or a stack of them) as a float32 tensor on
    ``device``."""
    if isinstance(image, torch.Tensor):
        return image.to(device=device, dtype=torch.float32)
    return torch.as_tensor(np.asarray(image, dtype=np.float32), device=device)


def undistort_source(frames: Iterable, cfg: ELLCConfig, device
                     ) -> Iterator[torch.Tensor]:
    """The frames of a source as float32 tensors on ``device``,
    undistorted when ``cfg.do_undistortion`` is set (cv::undistort on
    every decoded frame, Frame.cpp:86-96)."""
    for im in frames:
        im = _image(im, device)
        yield (camera.undistort_image(im, cfg.fx, cfg.fy, cfg.cx, cfg.cy,
                                      cfg.distortion)
               if cfg.do_undistortion else im)


def _needs_window(cfg: ELLCConfig) -> bool:
    """Keyframe snapshots and accumulated GN weights feed the loop window,
    for loop-closure edges (FLAG_DO_LOOP_CLOSURE) or for connection
    recovery (FLAG_RESTORE_CONNECTION): both re-localize with the
    constant-weight aligner."""
    return cfg.do_loop_closure or cfg.restore_connection


def _kf_levels(kf: Keyframe) -> Tuple[alignment.KeyframeLevel, ...]:
    return tuple(alignment.KeyframeLevel(i, d, v)
                 for i, d, v in zip(kf.images, kf.depths, kf.vars_))


def _refresh_kf_depth(kf: Keyframe, st: dstate.DepthMapState,
                      cfg: ELLCConfig
                      ) -> Tuple[Keyframe, dstate.DepthMapState]:
    """updateDepthImage: state -> level-0 maps -> fused pyramids (one
    kernel launch on the card)."""
    st, depths, vars_ = fusion.refresh_depth_pyramid(st, cfg)
    return kf.replace(depths=tuple(depths), vars_=tuple(vars_)), st


def make_keyframe(image: torch.Tensor, st: dstate.DepthMapState,
                  world_pose: torch.Tensor, rescale: torch.Tensor,
                  cfg: ELLCConfig,
                  levels: Optional[pyramid.Levels] = None
                  ) -> Tuple[Keyframe, dstate.DepthMapState]:
    """The keyframe of ``image`` with the state ``st``.  ``levels``: the
    image's ``pyramid.build_levels`` with the max-gradient map, when the
    caller has it (the keyframe step's tracking made it)."""
    if levels is None:
        levels = pyramid.build_levels(image, cfg.num_levels, max_grad=True)
    imgs = levels.images
    kf = Keyframe(images=imgs, depths=(), vars_=(), gradx=levels.gradx[0],
                  grady=levels.grady[0], maxgrad=levels.maxgrad,
                  world_pose=world_pose.to(torch.float32),
                  rescale=rescale.to(torch.float32),
                  weight_acc=(tuple(torch.zeros_like(i) for i in imgs)
                              if _needs_window(cfg) else ()),
                  weight_count=torch.zeros(image.shape[:-2],
                                           device=image.device))
    return _refresh_kf_depth(kf, st, cfg)


def _fresh_state(kf: Keyframe, st: dstate.DepthMapState) -> PipelineState:
    lead = kf.rescale.shape
    return PipelineState(kf=kf, depth=st,
                         prev_wrt_kf=torch.zeros(lead + (6,),
                                                 device=kf.rescale.device),
                         global_scale=torch.ones(lead,
                                                 device=kf.rescale.device))


def init_pipeline(first_image, cfg: ELLCConfig, device,
                  generator: Optional[torch.Generator] = None
                  ) -> PipelineState:
    """Frame 1: random depth init on the first keyframe (main.cpp:228-236,
    DepthPropagation.cpp:83-184).  ``generator`` (a CPU
    ``torch.Generator``) draws the inverse depths unless
    ``cfg.bootstrap_rng == "glibc"``; see ``depth.state.initialize_random``.

    Given V first frames (V, H, W) and a sequence of V generators (or
    None), it initializes V videos at once (``parallel.sharded``)."""
    with profiling.span("ellc.init"):
        device = torch.device(device)
        image = _image(first_image, device)
        lead = image.shape[:-2]
        levels = pyramid.build_levels(image, cfg.num_levels, max_grad=True)
        st = dstate.initialize_random(generator, levels.maxgrad, cfg)
        st = reg_kernel.regularize(st, cfg)
        kf, st = make_keyframe(image, st,
                               torch.zeros(lead + (6,), device=device),
                               torch.ones(lead, device=device), cfg, levels)
        return _fresh_state(kf, st)


def init_from_depth(first_image, depth, var, world_pose, cfg: ELLCConfig,
                    device) -> PipelineState:
    """Start from a saved depth map (FLAG_REPLICATE_NEW_DEPTH replay path,
    DepthPropagation.cpp:90-137)."""
    device = torch.device(device)
    st = dstate.from_depth(_image(depth, device), _image(var, device))
    kf, st = make_keyframe(_image(first_image, device), st,
                           _image(world_pose, device),
                           torch.ones((), device=device), cfg)
    return _fresh_state(kf, st)


def _track(state: PipelineState, image: torch.Tensor, cfg: ELLCConfig,
           replay: bool, init_rotation=None, max_grad: bool = False):
    """GetImagePoseEstimate from the previous frame's pose (constant
    position model, ImageFunc.cpp:97-108), or with the rotation of an
    RA-corrected world pose and the translation of t-1
    (ImageFunc.cpp:109-138).  The replay uses ``cfg.max_iters_replay``.
    Returns the pose, the diagnostics, the current levels and the frame's
    ``pyramid.build_levels`` (with the max-gradient map when
    ``max_grad``: the keyframe step's new keyframe)."""
    pose0 = state.prev_wrt_kf
    if init_rotation is not None:
        rot_wrt_kf = lie.relative(_image(init_rotation, state.device),
                                  state.kf.world_pose)
        pose0 = torch.cat([rot_wrt_kf[..., :3], pose0[..., 3:]], dim=-1)
    levels = pyramid.build_levels(image, cfg.num_levels, max_grad)
    cur = alignment.current_levels(levels)
    iters = cfg.max_iters_replay if replay else cfg.max_iters
    pose, diag = alignment.align(_kf_levels(state.kf), cur, pose0, cfg,
                                 iters)
    return pose, diag, cur, levels


def _accumulate_weights(kf: Keyframe, cur, pose: torch.Tensor,
                        cfg: ELLCConfig) -> Keyframe:
    """Add the per-level GN weight images at the tracked pose
    (saveWeights with useAverageWeights=true, PixelWisePyramid.cpp:544-551;
    all levels are evaluated at the final pose, as in the JAX package)."""
    kf_levels = _kf_levels(kf)
    acc = tuple(a + alignment.weight_image(kf_levels[l], cur[l], pose, l,
                                           cfg)
                for l, a in enumerate(kf.weight_acc))
    return kf.replace(weight_acc=acc, weight_count=kf.weight_count + 1.0)


def finalize_snapshot(state: PipelineState) -> KeyframeSnapshot:
    """Average the accumulated weights (finaliseWeights, Frame.cpp:678-695)
    and package the active keyframe for the loop-closure window."""
    kf = state.kf
    n = torch.clamp_min(kf.weight_count, 1.0)[..., None, None]
    return KeyframeSnapshot(image=kf.images[0], kf_levels=_kf_levels(kf),
                            weight_levels=tuple(a / n for a in kf.weight_acc),
                            world_pose=kf.world_pose, rescale=kf.rescale,
                            seeds=dstate.seeds_percent(state.depth),
                            depth_state=state.depth)


def _graphed(step, name: str, state: PipelineState, image,
             cfg: ELLCConfig, replay: bool, init_rotation):
    """``step`` on a CUDA state through its captured graph, on a CPU
    state eagerly, in the span ``name``."""
    with profiling.span(name):
        image = _image(image, state.device)
        if init_rotation is not None:
            init_rotation = _image(init_rotation, state.device)
        if state.device.type == "cuda":
            return graphs.run_step(step, state, image, cfg, replay,
                                   init_rotation)
        return step(state, image, cfg, replay, init_rotation)


def track_refine_step(state: PipelineState, image, cfg: ELLCConfig,
                      replay: bool = False, init_rotation=None
                      ) -> Tuple[PipelineState, FrameOutput]:
    """One non-keyframe frame: track, then refine the KF depth map
    (main.cpp:330, 499-502).  A replay of its captured graph on a CUDA
    state."""
    return _graphed(_track_refine_step, "ellc.step.track_refine", state,
                    image, cfg, replay, init_rotation)


def _track_refine_step(state: PipelineState, image, cfg: ELLCConfig,
                       replay: bool = False, init_rotation=None
                       ) -> Tuple[PipelineState, FrameOutput]:
    """The body of :func:`track_refine_step`, run eagerly."""
    image = _image(image, state.device)
    pose, diag, cur, _ = _track(state, image, cfg, replay, init_rotation)
    kf = state.kf
    if _needs_window(cfg):
        kf = _accumulate_weights(kf, cur, pose, cfg)
    out = stereo.observe(state.depth, kf.images[0], kf.gradx, kf.grady,
                         kf.maxgrad, image, pose, cfg)
    st = reg_kernel.do_regularization(out.state, kf.maxgrad, cfg)
    kf, st = _refresh_kf_depth(kf, st, cfg)
    new_state = PipelineState(kf=kf, depth=st, prev_wrt_kf=pose,
                              global_scale=state.global_scale)
    return new_state, FrameOutput(
        pose_wrt_kf=pose, pose_wrt_world=lie.compose(pose, kf.world_pose),
        rescale=kf.rescale, seeds=dstate.seeds_percent(st),
        weighted_pose=diag.weighted_pose,
        valid_fraction=diag.valid_fraction, oow_fraction=diag.oow_fraction)


def keyframe_step(state: PipelineState, image, cfg: ELLCConfig,
                  replay: bool = False, init_rotation=None
                  ) -> Tuple[PipelineState, FrameOutput,
                             Optional[KeyframeSnapshot]]:
    """Keyframe propagation (main.cpp:404-495 + createKeyFrame,
    DepthPropagation.cpp:1758-1794): track the new frame, finalize the old
    KF's map, reproject it into the new KF, regularize, renormalize scale,
    and swap keyframes.  The output line reports the OLD keyframe's
    rescale (main.cpp writes the pose before createKeyFrame).  With the
    loop window on, also returns the old keyframe's snapshot, taken after
    its final regularization with this frame's weights accumulated (else
    None).  A replay of its captured graph on a CUDA state."""
    return _graphed(_keyframe_step, "ellc.step.keyframe", state, image,
                    cfg, replay, init_rotation)


def _keyframe_step(state: PipelineState, image, cfg: ELLCConfig,
                   replay: bool = False, init_rotation=None
                   ) -> Tuple[PipelineState, FrameOutput,
                              Optional[KeyframeSnapshot]]:
    """The body of :func:`keyframe_step`, run eagerly."""
    image = _image(image, state.device)
    pose, diag, cur, levels = _track(state, image, cfg, replay,
                                     init_rotation, max_grad=True)
    kf_old = state.kf
    if _needs_window(cfg):
        kf_old = _accumulate_weights(kf_old, cur, pose, cfg)

    # finaliseKeyframe: one more doRegularization (main.cpp:436)
    st = reg_kernel.do_regularization(state.depth, kf_old.maxgrad, cfg)
    kf_old, st = _refresh_kf_depth(kf_old, st, cfg)
    snapshot = finalize_snapshot(PipelineState(
        kf=kf_old, depth=st, prev_wrt_kf=pose,
        global_scale=state.global_scale)) if _needs_window(cfg) else None

    # the new keyframe's pyramid, gradients and max-gradient map come from
    # the tracking above, computed once
    mg = levels.maxgrad
    st = propagate.propagate(st, kf_old.images[0], image, mg, pose, cfg)
    st = reg_kernel.regularize(st, cfg, remove_occlusions=True)
    st = reg_kernel.do_regularization(st, mg, cfg)
    st, rescale = dstate.make_idepth_one(st)

    new_world = lie.compose(pose, kf_old.world_pose)
    kf, st = make_keyframe(image, st, new_world, rescale, cfg, levels)
    new_state = PipelineState(
        kf=kf, depth=st, prev_wrt_kf=torch.zeros_like(pose),
        global_scale=state.global_scale * rescale)
    out = FrameOutput(pose_wrt_kf=pose, pose_wrt_world=new_world,
                      rescale=kf_old.rescale, seeds=dstate.seeds_percent(st),
                      weighted_pose=diag.weighted_pose,
                      valid_fraction=diag.valid_fraction,
                      oow_fraction=diag.oow_fraction)
    return new_state, out, snapshot


def stack_outputs(outs) -> FrameOutput:
    """Per-frame outputs -> one FrameOutput with a frame axis: leading,
    (K, ...), or after the video axis of a batched run, (V, K, ...)."""
    return stack_trees(outs, outs[0].seeds.dim())


def stack_trees(trees, dim: int):
    """Trees of one structure (dataclasses, tuples, None) -> one tree
    whose tensors are stacked at ``dim``."""
    leaves = [graphs.tree_flatten(t)[0] for t in trees]
    return graphs.tree_unflatten(graphs.tree_flatten(trees[0])[1],
                                 [torch.stack(ls, dim=dim)
                                  for ls in zip(*leaves)])


def _frames(images, device) -> torch.Tensor:
    """A sequence of K frames (tensors or arrays), or one (K, ...)
    tensor or array, as one float32 tensor (K, ...) on ``device``."""
    if isinstance(images, (list, tuple)) and isinstance(images[0],
                                                        torch.Tensor):
        return torch.stack([_image(im, device) for im in images])
    return _image(images, device)


def _interval(state: PipelineState, frames: torch.Tensor, cfg: ELLCConfig,
              replay: bool = False, rotations=None
              ) -> Tuple[PipelineState, FrameOutput,
                         Optional[KeyframeSnapshot]]:
    """The body of :func:`process_interval`, run eagerly: the
    track_refine step body over ``frames`` (K, ...) but the last, the
    keyframe step body on the last, the outputs stacked.  Each step's
    span opens where the body runs eagerly: on a CPU state, and on the
    card in its graph's warm-up and capture, not in a replay."""
    rots = [None] * len(frames) if rotations is None else rotations
    outs = []
    for k in range(len(frames) - 1):
        with profiling.span("ellc.step.track_refine"):
            state, out = _track_refine_step(state, frames[k], cfg, replay,
                                            rots[k])
        outs.append(out)
    with profiling.span("ellc.step.keyframe"):
        state, out, snapshot = _keyframe_step(state, frames[-1], cfg,
                                              replay, rots[-1])
    outs.append(out)
    return state, stack_outputs(outs), snapshot


def process_interval(state: PipelineState, images, cfg: ELLCConfig,
                     replay: bool = False, init_rotations=None
                     ) -> Tuple[PipelineState, FrameOutput,
                                Optional[KeyframeSnapshot]]:
    """One keyframe interval: track+refine over all frames but the last,
    then the keyframe step on the last.  ``images`` is a sequence of
    (H, W) frames, or of (V, H, W) frames for a batched state (K of them,
    or K-1 for a sequence's first interval), or one tensor or array of
    them, (K, H, W) or (K, V, H, W);
    ``init_rotations``, if given, holds one RA-corrected world pose per
    frame (the LC replay), as one (K, 6) array or tensor.  Returns the new
    state, the stacked per-frame outputs and the old keyframe's snapshot
    (None without the loop window).  On a CUDA state one replay of the
    interval's captured graph runs it (``graphs.run_interval``), on a CPU
    state :func:`_interval` runs eagerly."""
    with profiling.span("ellc.interval"):
        frames = _frames(images, state.device)
        rots = (None if init_rotations is None
                else _image(init_rotations, state.device))
        if state.device.type == "cuda":
            return graphs.run_interval(_interval, state, frames, cfg,
                                       replay, rots)
        # as the graph's static input holds them
        return _interval(state, frames.contiguous(), cfg, replay, rots)


def process_intervals(state: PipelineState, images, cfg: ELLCConfig,
                      replay: bool = False, init_rotations=None
                      ) -> Tuple[PipelineState, FrameOutput,
                                 Optional[KeyframeSnapshot]]:
    """N whole keyframe intervals with nothing read back between them:
    the port of the JAX package's ``process_intervals`` (one dispatch of
    N scanned intervals there, N replays of the interval's graph here on a
    CUDA state).

    ``images`` is (N, K, H, W), or (N, K, V, H, W) for a batched state;
    ``init_rotations``, if given, (N, K, 6).  Returns the new state, the
    outputs stacked (N, K, ...) ((V, N, K, ...) for a batched state) and,
    with the loop window on, the N old keyframes' snapshots stacked the
    same way (else None)."""
    images = _image(images, state.device)
    if init_rotations is not None:
        init_rotations = _image(init_rotations, state.device)
    outs, snaps = [], []
    for n in range(images.shape[0]):
        state, out, snap = process_interval(
            state, images[n], cfg, replay,
            None if init_rotations is None else init_rotations[n])
        outs.append(out)
        snaps.append(snap)
    dim = state.prev_wrt_kf.dim() - 1        # after the video axis
    return (state, stack_trees(outs, dim),
            None if snaps[0] is None else stack_trees(snaps, dim))
