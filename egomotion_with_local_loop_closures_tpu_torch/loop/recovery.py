"""Connection recovery: re-localize against the loop window when the
depth map dies.

Port of ``egomotion_with_local_loop_closures_tpu/loop/recovery.py`` (the
reference's FLAG_RESTORE_CONNECTION, ``src/GlobalOptimize.cpp:717-943``
consumed in ``src/main.cpp:252-324``):

- :func:`check_connection`: tracking is lost when the depth map's seed
  occupancy is at or below ``min_seeds_for_connection_lost`` (0 %).
- :func:`find_connection`: the stray frame is tried against every window
  keyframe whose frame-id gap exceeds ``min_match_difference`` (stray
  frames skip the KL and view-angle gates, GlobalOptimize.cpp:344-412),
  newest first.  Each trial re-estimates the stray frame's pose against
  the candidate with the constant-weight aligner from a zero pose
  (:855-868), propagates the candidate's hypotheses into the stray frame
  and finalizes them as createKeyFrame does (:895,
  DepthPropagation.cpp:1758-1794), and counts the seeds.  The newest
  candidate whose seeds are above the threshold wins (:902-907); with
  none, the frame is dropped.

All trials run as one batch over the candidates (:func:`_batched_trials`):
one aligner call, one ``propagate``, one launch of each K3 wrapper over
(B, H, W) planes, and one host read of the seeds.  The batch holds the
real candidates; the JAX package pads it to the window cap of 20 only to
bound its jit compiles, which does not change the winner.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from egomotion_with_local_loop_closures_tpu_torch.config import ELLCConfig
from egomotion_with_local_loop_closures_tpu_torch.depth import propagate
from egomotion_with_local_loop_closures_tpu_torch.depth import state as dstate
from egomotion_with_local_loop_closures_tpu_torch.depth.state import FIELDS
from egomotion_with_local_loop_closures_tpu_torch.geom import lie
from egomotion_with_local_loop_closures_tpu_torch.image import pyramid
from egomotion_with_local_loop_closures_tpu_torch.loop import closure
from egomotion_with_local_loop_closures_tpu_torch.ops import reg_kernel
from egomotion_with_local_loop_closures_tpu_torch.track import alignment


class Recovery(NamedTuple):
    """A successful re-localization: what the runner needs to rebuild the
    pipeline state around the stray frame as a new keyframe."""
    matched_kf_id: int
    pose_wrt_matched: torch.Tensor     # (6,) stray frame w.r.t. matched KF
    world_pose: torch.Tensor           # (6,) stray frame w.r.t. world
    depth_state: dstate.DepthMapState  # propagated + renormalized map
    rescale: torch.Tensor              # makeInvDepthOne factor
    seeds: float                       # occupancy % after propagation


def check_connection(seeds_percent: float, cfg: ELLCConfig) -> bool:
    """True when tracking is lost (checkConnection,
    GlobalOptimize.cpp:934-943)."""
    return seeds_percent <= cfg.min_seeds_for_connection_lost


def _batched_trials(kf_levels, weight_levels,
                    depth_states: dstate.DepthMapState,
                    kf_images: torch.Tensor, image: torch.Tensor,
                    cfg: ELLCConfig):
    """Every candidate's trial at once; the keyframe levels, weights,
    depth states and images carry a leading candidate axis B.  Returns
    (poses (B, 6), states (B, H, W), rescales (B,), seeds% (B,))."""
    levels = pyramid.build_levels(image, cfg.num_levels, max_grad=True)
    cur_levels = alignment.current_levels(levels)
    maxgrad = levels.maxgrad
    B = kf_images.shape[0]
    poses, _ = alignment.align_const_weight(
        kf_levels, weight_levels, cur_levels,
        torch.zeros((B, 6), device=image.device), cfg)
    st = propagate.propagate(depth_states, kf_images, image, maxgrad, poses,
                             cfg)
    st = reg_kernel.regularize(st, cfg, remove_occlusions=True)
    st = reg_kernel.do_regularization(
        st, maxgrad.expand(kf_images.shape).contiguous(), cfg)
    st, rescales = dstate.make_idepth_one(st)
    return poses, st, rescales, dstate.seeds_percent(st)


def find_connection(closer: closure.LoopCloser, frame_id: int,
                    image: torch.Tensor, cfg: ELLCConfig
                    ) -> Optional[Recovery]:
    """Trial every eligible window keyframe in one batch and return the
    newest whose propagated depth map revives tracking (the reference's
    first-hit walk, GlobalOptimize.cpp:774-932), or None."""
    cands = [i for i in range(len(closer.entries) - 1, -1, -1)
             if frame_id - closer.entries[i].frame_id
             > cfg.min_match_difference
             and closer.entries[i].depth_state is not None]
    if not cands:
        return None
    ents = [closer.entries[i] for i in cands]
    kf_levels, weight_levels = closure.stack_levels(closer.entries, cands)
    depth = dstate.DepthMapState(**{
        n: torch.stack([getattr(e.depth_state, n) for e in ents])
        for n in FIELDS})
    poses, states, rescales, seeds = _batched_trials(
        kf_levels, weight_levels, depth, kf_levels[0].image, image, cfg)
    seeds = seeds.cpu().tolist()
    for k, e in enumerate(ents):            # newest -> oldest, first hit
        if check_connection(seeds[k], cfg):
            continue        # still lost: try the next candidate (:902-907)
        return Recovery(
            matched_kf_id=e.frame_id, pose_wrt_matched=poses[k],
            world_pose=lie.compose(poses[k], e.world_pose),
            depth_state=dstate.DepthMapState(**{
                n: getattr(states, n)[k] for n in FIELDS}),
            rescale=rescales[k], seeds=seeds[k])
    return None
