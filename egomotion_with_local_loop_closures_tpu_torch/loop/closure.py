"""Local loop closure: sliding keyframe window, matching, rematch edges.

Port of ``egomotion_with_local_loop_closures_tpu/loop/closure.py``
(``globalOptimize``, ``src/GlobalOptimize.cpp``, ``src/LoopFrame.h``).
The window is a host list of entries whose payload (keyframe pyramid,
averaged weights, histogram, world pose) stays on the device; tensors are
never written in place, so an entry holds references, not copies.  Each
push runs the gates for the whole window as one batched computation and
reads them back in one transfer; the accepted candidates are stacked and
rematched in one call of the batched constant-weight aligner.

Matching rules (GlobalOptimize.cpp:274-416):
- candidate window = up to the last ``cfg.loop_window`` (=20) pushed
  keyframes, evicted oldest first, walked newest -> oldest;
- frame-id gap > ``min_match_difference`` (=8), then a cooldown of
  ``min_wait_count`` walked entries after each match;
- KL(old_hist || cur_hist) <= ``match_threshold`` (=0.1);
- relative view angle <= ``max_rel_view_angle`` (=10 deg) between the
  third rotation rows of the two world poses, with the reference's degree
  conversion 180/3.14 (GlobalOptimize.cpp:432);
- a match's pose is re-estimated against the matched keyframe and only
  yields a graph edge (GlobalOptimize.cpp:589-606).
"""

from __future__ import annotations

import dataclasses
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from egomotion_with_local_loop_closures_tpu_torch.config import ELLCConfig
from egomotion_with_local_loop_closures_tpu_torch.depth.state import (
    DepthMapState)
from egomotion_with_local_loop_closures_tpu_torch.geom import lie
from egomotion_with_local_loop_closures_tpu_torch.image import pyramid
from egomotion_with_local_loop_closures_tpu_torch.loop import histogram
from egomotion_with_local_loop_closures_tpu_torch.track import alignment


class LoopEntry(NamedTuple):
    """One keyframe in the window (LoopFrame.h:24-37); tensors on the
    pipeline's device."""
    frame_id: int
    hist: torch.Tensor                               # (bins,)
    kf_levels: Tuple[alignment.KeyframeLevel, ...]
    weight_levels: Tuple[torch.Tensor, ...]
    world_pose: torch.Tensor                         # (6,)
    rescale: torch.Tensor                            # scalar
    seeds: torch.Tensor                              # scalar
    # the keyframe's hypothesis state for connection recovery
    # (LoopFrame.h:33 this_currentDepthMap); None when it was not kept
    depth_state: Optional[DepthMapState] = None


class LoopEdge(NamedTuple):
    """An extra pose-graph edge written to matchframes_globalopt.txt
    (GlobalOptimize.cpp:574-582)."""
    frame_id: int
    matched_kf_id: int
    pose_wrt_matched: np.ndarray   # (6,)
    rescale: float
    seeds: float
    match_value: float
    rms_error: float
    view_angle: float


def _angle_deg(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Angle between two vectors (..., 3) in the reference's degrees
    (180/3.14, GlobalOptimize.cpp:432)."""
    c = torch.sum(a * b, dim=-1) / (
        torch.linalg.vector_norm(a, dim=-1)
        * torch.linalg.vector_norm(b, dim=-1) + 1e-12)
    return torch.arccos(torch.clamp(c, -1.0, 1.0)) * 180.0 / 3.14


def view_angle_deg(pose_a: torch.Tensor, pose_b: torch.Tensor
                   ) -> torch.Tensor:
    """Relative view angle between world poses, reference semantics
    (GlobalOptimize.cpp:419-452, incl. the 180/3.14 conversion)."""
    return _angle_deg(lie.view_vector(pose_a), lie.view_vector(pose_b))


def trigger_angle_deg(world_pose: torch.Tensor) -> torch.Tensor:
    """Angle between the camera center (-R^T t) and the viewing direction
    (third row of R) of a world pose: the loop-closure trigger statistic
    (triggerRotation, GlobalOptimize.cpp:675-683, incl. 180/3.14)."""
    T = lie.exp_se3(world_pose)
    R, t = T[..., :3, :3], T[..., :3, 3]
    center = -(R.transpose(-1, -2) @ t[..., None])[..., 0]
    return _angle_deg(center, R[..., 2, :])


def _gate_stats(entries: List[LoopEntry], hist: torch.Tensor,
                pose: torch.Tensor):
    """The window gates for every entry in one batched computation: KL
    divergences (GlobalOptimize.cpp:344-358, the old histogram is p),
    relative view angles (:419-452), the rms of the rotation difference
    (:421), and each entry's rematch initial pose (the current world pose
    relative to the entry's, ImageFunc.cpp:97-108).  The first four come
    back to the host in one transfer, with each entry's rescale and
    seeds; the initial poses stay on the device."""
    poses = torch.stack([e.world_pose for e in entries])
    kls = histogram.kl_divergence_batched(
        torch.stack([e.hist for e in entries]), hist)
    angles = view_angle_deg(poses, pose.expand_as(poses))
    d = pose[:3] - poses[:, :3]
    rms = torch.sqrt(torch.sum(d * d, dim=-1))
    rels = lie.relative(pose.expand_as(poses), poses)
    host = torch.stack([kls, angles, rms,
                        torch.stack([e.rescale for e in entries]),
                        torch.stack([e.seeds for e in entries])]).cpu()
    return host.numpy(), rels


def stack_levels(entries: List[LoopEntry], idx: List[int]):
    """The chosen entries' keyframe and weight pyramids, stacked along a
    new leading candidate axis."""
    kf = tuple(alignment.KeyframeLevel(*(
        torch.stack([getattr(entries[i].kf_levels[l], f) for i in idx])
        for f in alignment.KeyframeLevel._fields))
        for l in range(len(entries[0].kf_levels)))
    w = tuple(torch.stack([entries[i].weight_levels[l] for i in idx])
              for l in range(len(entries[0].weight_levels)))
    return kf, w


def rms_rotation_error(pose_a, pose_b) -> float:
    """The reference's 'rms_error': the euclidean distance of the rotation
    components of two world twists (GlobalOptimize.cpp:421), on the host
    in the poses' own precision.  The window's gates compute the same distance for every
    entry at once on the device (``_gate_stats``)."""
    d = np.asarray(pose_a[:3]) - np.asarray(pose_b[:3])
    return float(np.sqrt(np.sum(d * d)))


@dataclasses.dataclass
class LoopCloser:
    """Sliding-window loop-closure detector + rematcher."""
    cfg: ELLCConfig
    entries: List[LoopEntry] = dataclasses.field(default_factory=list)
    edges: List[LoopEdge] = dataclasses.field(default_factory=list)
    # detectedShortLoopClosure hysteresis latch (GlobalOptimize.cpp:33,
    # :690-704); starts False
    trigger_active: bool = False

    def update_trigger(self, world_pose: torch.Tensor) -> bool:
        """triggerRotation (GlobalOptimize.cpp:671-714): turn matching ON
        when the center/view angle exceeds trigger_loop_closure_on, OFF
        again once it falls below trigger_loop_closure_off.  One host
        read."""
        theta = float(trigger_angle_deg(world_pose))
        if not self.trigger_active and theta > self.cfg.trigger_loop_closure_on:
            self.trigger_active = True
        elif self.trigger_active and theta < self.cfg.trigger_loop_closure_off:
            self.trigger_active = False
        return self.trigger_active

    def push_keyframe(self, frame_id: int, image: torch.Tensor,
                      kf_levels: Tuple[alignment.KeyframeLevel, ...],
                      weight_levels: Tuple[torch.Tensor, ...],
                      world_pose: torch.Tensor, rescale, seeds,
                      depth_state: Optional[DepthMapState] = None,
                      match: bool = True) -> List[LoopEdge]:
        """pushToArray + findMatchParallel (GlobalOptimize.cpp:151-272,
        454-646): match the keyframe against the window, emit an edge for
        every accepted match, then insert it, evicting the oldest entry
        when the window is full.  With cfg.use_loop_closure_trigger,
        matching only runs while the rotation trigger is latched on
        (GlobalOptimize.cpp:225-237).  ``match=False`` only inserts (the
        window of connection recovery without loop closure), and
        ``depth_state`` is kept for recovery."""
        cfg = self.cfg
        dev = image.device
        hist = histogram.image_histogram(image, cfg.histogram_bins)
        world_pose = torch.as_tensor(world_pose, dtype=torch.float32,
                                     device=dev)
        do_match = match and (self.update_trigger(world_pose)
                              if cfg.use_loop_closure_trigger else True)
        new_edges = (self._find_matches(frame_id, hist, world_pose, image)
                     if do_match else [])
        if len(self.entries) >= cfg.loop_window:
            self.entries.pop(0)
        f32 = dict(dtype=torch.float32, device=dev)
        self.entries.append(LoopEntry(
            frame_id=frame_id, hist=hist, kf_levels=tuple(kf_levels),
            weight_levels=tuple(weight_levels), world_pose=world_pose,
            rescale=torch.as_tensor(rescale, **f32),
            seeds=torch.as_tensor(seeds, **f32), depth_state=depth_state))
        self.edges.extend(new_edges)
        return new_edges

    def _candidates(self, frame_id: int, hist: torch.Tensor,
                    pose: torch.Tensor):
        """Window indices passing all gates, walked newest -> oldest with
        the cooldown (GlobalOptimize.cpp:464-474), plus the host gate
        statistics and the device initial poses."""
        cfg = self.cfg
        if not self.entries:
            return [], None, None
        stats, rels = _gate_stats(self.entries, hist, pose)
        kls, angles = stats[0], stats[1]
        out = []
        wait = 0
        for i in range(len(self.entries) - 1, -1, -1):
            # the cooldown decrements once per walked entry (GO.cpp:469-473)
            if wait != 0:
                wait -= 1
                continue
            if frame_id - self.entries[i].frame_id <= cfg.min_match_difference:
                continue
            if kls[i] > cfg.match_threshold:
                continue
            if angles[i] > cfg.max_rel_view_angle:
                continue
            out.append(i)
            wait = cfg.min_wait_count       # GO.cpp:536
        return out, stats, rels

    def _find_matches(self, frame_id: int, hist: torch.Tensor,
                      pose: torch.Tensor, image: torch.Tensor
                      ) -> List[LoopEdge]:
        cfg = self.cfg
        cands, stats, rels = self._candidates(frame_id, hist, pose)
        if not cands:
            return []
        cur_levels = alignment.current_levels(
            pyramid.build_levels(image, cfg.num_levels))
        kf, w = stack_levels(self.entries, cands)
        idx = torch.as_tensor(cands, device=rels.device)
        poses, _ = alignment.align_const_weight(kf, w, cur_levels, rels[idx],
                                                cfg)
        poses = poses.cpu().numpy()
        kls, angles, rms, rescales, seeds = stats
        return [LoopEdge(frame_id=frame_id,
                         matched_kf_id=self.entries[i].frame_id,
                         pose_wrt_matched=poses[k],
                         rescale=float(rescales[i]), seeds=float(seeds[i]),
                         match_value=float(kls[i]), rms_error=float(rms[i]),
                         view_angle=float(angles[i]))
                for k, i in enumerate(cands)]
