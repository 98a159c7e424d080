"""The frame-loop pipeline: tracking + depth refinement + keyframing.

Port of ``egomotion_with_local_loop_closures_tpu/runtime/pipeline.py``
(the reference's frame loop, ``src/main.cpp:199-505``) in GN mode.  Each
non-keyframe frame runs :func:`track_refine_step` (pyramid -> align ->
stereo.observe -> doRegularization -> depth-pyramid rebuild); every
``keyframe_interval``-th frame runs :func:`keyframe_step`.  A Python loop
takes the place of the JAX package's ``lax.scan``, and PyTorch runs each
op eagerly on the state's device: nothing here waits for the device
except the caller reading the outputs.

Depth regularization goes through the CUDA kernel's wrappers
(``ops/reg_kernel.py``), which use the plain PyTorch version for tensors
on the CPU.

The port implements the exact form of every TPU-only layout switch and
reads none of these config fields: ``use_window_warp``, ``warp_window``,
``warp_window_rematch``, ``warp_oow_fallback``, ``warp_valid_floor``,
``stereo_compact_frac``, ``stereo_short_steps``, ``stereo_short_frac``,
``stereo_pack_u8``, ``use_pallas_reg``.  The JAX settings that compute the
same thing are ``config.PARITY_OVERRIDES``.

With ``do_loop_closure`` each tracked frame also accumulates its GN
weight images into the keyframe (``Keyframe.weight_acc``), and
:func:`keyframe_step` returns the finalized old keyframe as a
:class:`KeyframeSnapshot` for the loop window.  The LC replay tracks with
``cfg.max_iters_replay`` and seeds each frame's rotation from the
rotation-averaged world pose (``init_rotation``).

Outside the port's slice, and refused with ``NotImplementedError``:
connection recovery (``restore_connection``) and undistortion
(``do_undistortion``).  The JAX package's masked single-program intervals
and chunked ``process_intervals`` exist to bound jit compiles; here the
callers run K-1-frame, K-frame and tail intervals directly.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from egomotion_with_local_loop_closures_tpu_torch.config import ELLCConfig
from egomotion_with_local_loop_closures_tpu_torch.depth import (
    fusion, propagate, state as dstate, stereo)
from egomotion_with_local_loop_closures_tpu_torch.geom import lie
from egomotion_with_local_loop_closures_tpu_torch.image import pyramid
from egomotion_with_local_loop_closures_tpu_torch.ops import reg_kernel
from egomotion_with_local_loop_closures_tpu_torch.track import alignment


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


@dataclasses.dataclass(frozen=True)
class PipelineState:
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


def check_supported(cfg: ELLCConfig) -> None:
    """Refuse the features outside the port's slice."""
    for name in ("restore_connection", "do_undistortion"):
        if getattr(cfg, name):
            raise NotImplementedError(
                f"{name}=True is not ported to PyTorch yet")


def _image(image, device) -> torch.Tensor:
    """An (H, W) frame or map as a float32 tensor on ``device``."""
    if isinstance(image, torch.Tensor):
        return image.to(device=device, dtype=torch.float32)
    return torch.as_tensor(np.asarray(image, dtype=np.float32), device=device)


def _needs_window(cfg: ELLCConfig) -> bool:
    """Keyframe snapshots and accumulated GN weights feed the loop window
    (FLAG_DO_LOOP_CLOSURE)."""
    return cfg.do_loop_closure


def _kf_levels(kf: Keyframe) -> Tuple[alignment.KeyframeLevel, ...]:
    return tuple(alignment.KeyframeLevel(i, d, v)
                 for i, d, v in zip(kf.images, kf.depths, kf.vars_))


def _refresh_kf_depth(kf: Keyframe, st: dstate.DepthMapState,
                      cfg: ELLCConfig
                      ) -> Tuple[Keyframe, dstate.DepthMapState]:
    """updateDepthImage: state -> level-0 maps -> fused pyramids."""
    st, depth0, var0 = dstate.to_depth_image(st, cfg)
    depths, vars_ = fusion.build_depth_var_pyramid(depth0, var0,
                                                   cfg.num_levels)
    return kf.replace(depths=tuple(depths), vars_=tuple(vars_)), st


def make_keyframe(image: torch.Tensor, st: dstate.DepthMapState,
                  world_pose: torch.Tensor, rescale: torch.Tensor,
                  cfg: ELLCConfig) -> Tuple[Keyframe, dstate.DepthMapState]:
    gx, gy = pyramid.gradients(image)
    imgs = tuple(pyramid.build_pyramid(image, cfg.num_levels))
    kf = Keyframe(images=imgs, depths=(), vars_=(), gradx=gx, grady=gy,
                  maxgrad=pyramid.max_abs_gradient(gx, gy),
                  world_pose=world_pose.to(torch.float32),
                  rescale=rescale.to(torch.float32),
                  weight_acc=(tuple(torch.zeros_like(i) for i in imgs)
                              if _needs_window(cfg) else ()),
                  weight_count=torch.zeros((), device=image.device))
    return _refresh_kf_depth(kf, st, cfg)


def _fresh_state(kf: Keyframe, st: dstate.DepthMapState,
                 device) -> PipelineState:
    return PipelineState(kf=kf, depth=st,
                         prev_wrt_kf=torch.zeros(6, device=device),
                         global_scale=torch.ones((), device=device))


def init_pipeline(first_image, cfg: ELLCConfig, device,
                  generator: Optional[torch.Generator] = None
                  ) -> PipelineState:
    """Frame 1: random depth init on the first keyframe (main.cpp:228-236,
    DepthPropagation.cpp:83-184).  ``generator`` (a CPU
    ``torch.Generator``) draws the inverse depths unless
    ``cfg.bootstrap_rng == "glibc"``; see ``depth.state.initialize_random``."""
    check_supported(cfg)
    device = torch.device(device)
    image = _image(first_image, device)
    gx, gy = pyramid.gradients(image)
    st = dstate.initialize_random(generator,
                                  pyramid.max_abs_gradient(gx, gy), cfg)
    st = reg_kernel.regularize(st, cfg)
    kf, st = make_keyframe(image, st, torch.zeros(6, device=device),
                           torch.ones((), device=device), cfg)
    return _fresh_state(kf, st, device)


def init_from_depth(first_image, depth, var, world_pose, cfg: ELLCConfig,
                    device) -> PipelineState:
    """Start from a saved depth map (FLAG_REPLICATE_NEW_DEPTH replay path,
    DepthPropagation.cpp:90-137)."""
    check_supported(cfg)
    device = torch.device(device)
    st = dstate.from_depth(_image(depth, device), _image(var, device))
    kf, st = make_keyframe(_image(first_image, device), st,
                           _image(world_pose, device),
                           torch.ones((), device=device), cfg)
    return _fresh_state(kf, st, device)


def _track(state: PipelineState, image: torch.Tensor, cfg: ELLCConfig,
           replay: bool, init_rotation=None):
    """GetImagePoseEstimate from the previous frame's pose (constant
    position model, ImageFunc.cpp:97-108), or with the rotation of an
    RA-corrected world pose and the translation of t-1
    (ImageFunc.cpp:109-138).  The replay uses ``cfg.max_iters_replay``."""
    pose0 = state.prev_wrt_kf
    if init_rotation is not None:
        rot_wrt_kf = lie.relative(_image(init_rotation, state.device),
                                  state.kf.world_pose)
        pose0 = torch.cat([rot_wrt_kf[:3], pose0[3:]])
    cur = alignment.make_current_levels(
        pyramid.build_pyramid(image, cfg.num_levels))
    iters = cfg.max_iters_replay if replay else cfg.max_iters
    pose, diag = alignment.align(_kf_levels(state.kf), cur, pose0, cfg,
                                 iters)
    return pose, diag, cur


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
    n = torch.clamp_min(kf.weight_count, 1.0)
    return KeyframeSnapshot(image=kf.images[0], kf_levels=_kf_levels(kf),
                            weight_levels=tuple(a / n for a in kf.weight_acc),
                            world_pose=kf.world_pose, rescale=kf.rescale,
                            seeds=dstate.seeds_percent(state.depth))


def track_refine_step(state: PipelineState, image, cfg: ELLCConfig,
                      replay: bool = False, init_rotation=None
                      ) -> Tuple[PipelineState, FrameOutput]:
    """One non-keyframe frame: track, then refine the KF depth map
    (main.cpp:330, 499-502)."""
    check_supported(cfg)
    image = _image(image, state.device)
    pose, diag, cur = _track(state, image, cfg, replay, init_rotation)
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
    None)."""
    check_supported(cfg)
    image = _image(image, state.device)
    pose, diag, cur = _track(state, image, cfg, replay, init_rotation)
    kf_old = state.kf
    if _needs_window(cfg):
        kf_old = _accumulate_weights(kf_old, cur, pose, cfg)

    # finaliseKeyframe: one more doRegularization (main.cpp:436)
    st = reg_kernel.do_regularization(state.depth, kf_old.maxgrad, cfg)
    kf_old, st = _refresh_kf_depth(kf_old, st, cfg)
    snapshot = finalize_snapshot(PipelineState(
        kf=kf_old, depth=st, prev_wrt_kf=pose,
        global_scale=state.global_scale)) if _needs_window(cfg) else None

    gx, gy = pyramid.gradients(image)
    mg = pyramid.max_abs_gradient(gx, gy)
    st = propagate.propagate(st, kf_old.images[0], image, mg, pose, cfg)
    st = reg_kernel.regularize(st, cfg, remove_occlusions=True)
    st = reg_kernel.do_regularization(st, mg, cfg)
    st, rescale = dstate.make_idepth_one(st)

    new_world = lie.compose(pose, kf_old.world_pose)
    kf, st = make_keyframe(image, st, new_world, rescale, cfg)
    new_state = PipelineState(
        kf=kf, depth=st, prev_wrt_kf=torch.zeros(6, device=state.device),
        global_scale=state.global_scale * rescale)
    out = FrameOutput(pose_wrt_kf=pose, pose_wrt_world=new_world,
                      rescale=kf_old.rescale, seeds=dstate.seeds_percent(st),
                      weighted_pose=diag.weighted_pose,
                      valid_fraction=diag.valid_fraction,
                      oow_fraction=diag.oow_fraction)
    return new_state, out, snapshot


def stack_outputs(outs) -> FrameOutput:
    """Per-frame outputs -> one FrameOutput with a leading frame axis."""
    return FrameOutput(**{
        f.name: torch.stack([getattr(o, f.name) for o in outs])
        for f in dataclasses.fields(FrameOutput)})


def process_interval(state: PipelineState, images, cfg: ELLCConfig,
                     replay: bool = False, init_rotations=None
                     ) -> Tuple[PipelineState, FrameOutput,
                                Optional[KeyframeSnapshot]]:
    """One keyframe interval: track+refine over all frames but the last,
    then the keyframe step on the last.  ``images`` is a sequence of
    (H, W) frames (K of them, or K-1 for a sequence's first interval);
    ``init_rotations``, if given, holds one RA-corrected world pose per
    frame (the LC replay).  Returns the new state, the stacked per-frame
    outputs and the old keyframe's snapshot (None without the loop
    window)."""
    rots = ([None] * len(images) if init_rotations is None
            else list(init_rotations))
    outs = []
    for img, rot in zip(images[:-1], rots[:-1]):
        state, out = track_refine_step(state, img, cfg, replay, rot)
        outs.append(out)
    state, out, snapshot = keyframe_step(state, images[-1], cfg, replay,
                                         rots[-1])
    outs.append(out)
    return state, stack_outputs(outs), snapshot
