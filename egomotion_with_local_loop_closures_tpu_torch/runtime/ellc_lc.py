"""ELLC-LC mode: alternating Gauss-Newton tracking and rotation averaging.

Port of ``egomotion_with_local_loop_closures_tpu/runtime/ellc_lc.py``
(the reference's ``bin/ELLC_LC.sh`` + the ``ToggleFlags.h`` batch state
machine + ``matlab_scripts/small_batch_rotavg{,_bootstrap}.m``), in one
process with the state on the device:

  bootstrap: GN-track batch 1 (``ra_batch_size_bootstrap`` keyframe
             intervals) with loop closures on, keeping the batch's frames
             and the transition keyframe's depth
  repeat:    1. rotation-average the batch's keyframe rotations from the
                odometry and loop-closure edges (graph.batch)
             2. replay the batch from the saved transition depth, seeding
                each frame's rotation from the averaged poses, with the
                replay iteration schedule {5,1,1,1} (ToggleFlags.h:34-38)
             3. GN-track the next batch (``ra_batch_size`` intervals)
             4. accumulate corrected world poses (World_pose.mat analog)

RA corrects only rotations; the odometry translations, in the drifting
per-keyframe scale, are kept (perform_rotation_averaging_transition1.m:
79-82).  Frames that end the stream short of an interval are tracked
against the last keyframe without a new keyframe or RA.

Two faults of the JAX package are not copied: a stream that ends exactly
on a batch boundary does not call the tail tracker with no frames (which
trips its assertion there), and the replay without rotations passes None,
not zero rotations.  Sim(3) refinement (``do_sim3_refine``) is not ported.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Iterable, List, Optional, Tuple

import numpy as np
import torch

from egomotion_with_local_loop_closures_tpu_torch.config import ELLCConfig
from egomotion_with_local_loop_closures_tpu_torch.depth import state as dstate
from egomotion_with_local_loop_closures_tpu_torch.geom import lie
from egomotion_with_local_loop_closures_tpu_torch.graph import (
    batch as graph_batch)
from egomotion_with_local_loop_closures_tpu_torch.loop import closure
from egomotion_with_local_loop_closures_tpu_torch.runtime import io as ellc_io
from egomotion_with_local_loop_closures_tpu_torch.runtime import pipeline


def _compose_batch(poses, base, device) -> np.ndarray:
    """world_i = pose_i o base for a whole batch in one batched compose
    (the World_pose accumulation, small_batch_rotavg.m:43-50)."""
    poses = torch.as_tensor(np.asarray(poses, np.float32), device=device)
    base = torch.as_tensor(np.asarray(base, np.float32), device=device)
    return lie.compose(poses, base.expand_as(poses)).cpu().numpy()


class _Timer:
    """Accumulates wall-clock seconds per phase into ``stats``."""

    def __init__(self, stats: Optional[dict]):
        self.stats = stats

    def __call__(self, phase: str, t0: float) -> float:
        t = time.perf_counter()
        if self.stats is not None:
            self.stats[phase] = self.stats.get(phase, 0.0) + (t - t0)
        return t


@dataclasses.dataclass
class BatchRecord:
    """Everything remembered about one GN batch for RA + replay."""
    start_frame_id: int                 # transition frame (a keyframe)
    pose_rows: List[List[float]]        # frame_id, kf_id, pose6 (world)
    odometry_rows: List[List[float]]    # frame_id, kf_id, pose6 (wrt KF)
    loop_rows: List[List[float]]        # loop edges, same layout
    start_image: torch.Tensor           # transition KF image
    start_depth: torch.Tensor           # its refined depth map
    start_var: torch.Tensor


@dataclasses.dataclass
class LCResult:
    world_poses: np.ndarray             # (N, 6) final corrected world poses
    frame_ids: np.ndarray
    raw_world_poses: np.ndarray         # pre-RA (GN-only) world poses
    num_batches: int
    num_loop_edges: int
    loop_edges: list = dataclasses.field(default_factory=list)


def _track_batch(state: pipeline.PipelineState, frames: List[np.ndarray],
                 start_frame_id: int, cfg: ELLCConfig,
                 closer: Optional[closure.LoopCloser],
                 replay: bool = False,
                 init_rotations: Optional[np.ndarray] = None,
                 base_world: Optional[np.ndarray] = None,
                 timer: Optional[_Timer] = None
                 ) -> Tuple[pipeline.PipelineState, BatchRecord]:
    """Track a whole batch interval by interval, starting from ``state``
    whose keyframe is frame ``start_frame_id``; ``frames`` excludes that
    keyframe.  A batch starting at frame 1 tracks K-1 frames in its first
    interval, so keyframes land on multiples of K (main.cpp:404).  With a
    ``closer``, each finalized keyframe is pushed to the loop window with
    its world pose anchored by ``base_world`` (the corrected world pose of
    the transition frame), so matches work across batches."""
    K = cfg.keyframe_interval
    first = start_frame_id == 1
    assert (len(frames) + (1 if first else 0)) % K == 0
    if base_world is None:
        base_world = np.zeros(6, np.float32)
    timer = timer or _Timer(None)
    _, depth0, var0 = dstate.to_depth_image(state.depth, cfg)
    rec = BatchRecord(start_frame_id=start_frame_id,
                      pose_rows=[], odometry_rows=[], loop_rows=[],
                      start_image=state.kf.images[0],
                      start_depth=depth0, start_var=var0)
    dev = state.device
    kf_id = fid = start_frame_id
    b = 0
    while b < len(frames):
        size = (K - 1) if (first and b == 0) else K
        rots = (None if init_rotations is None
                else init_rotations[b:b + size])
        state, outs, snapshot = pipeline.process_interval(
            state, frames[b:b + size], cfg, replay, rots)
        t0 = time.perf_counter()
        if closer is not None:
            world_global = lie.compose(
                snapshot.world_pose,
                torch.as_tensor(base_world, device=dev))
            edges = closer.push_keyframe(
                kf_id, snapshot.image, snapshot.kf_levels,
                snapshot.weight_levels, world_global, snapshot.rescale,
                snapshot.seeds)
            rec.loop_rows += [[e.frame_id, e.matched_kf_id,
                               *e.pose_wrt_matched] for e in edges]
            timer("window", t0)
        world = outs.pose_wrt_world.cpu().numpy()
        rel = outs.pose_wrt_kf.cpu().numpy()
        for j in range(size):
            fid += 1
            rec.pose_rows.append([fid, kf_id, *world[j]])
            rec.odometry_rows.append([fid, kf_id, *rel[j]])
        kf_id = fid
        b += size
    return state, rec


def _track_tail(state: pipeline.PipelineState, frames: List[np.ndarray],
                frame_id0: int, base_world: np.ndarray, cfg: ELLCConfig
                ) -> List[Tuple[int, np.ndarray]]:
    """Track r < K end-of-stream frames (track+refine each, no keyframe)
    and return their (frame_id, corrected world pose) rows."""
    K = cfg.keyframe_interval
    r = len(frames)
    assert 0 < r < K, r
    outs = []
    for img in frames:
        state, o = pipeline.track_refine_step(state, img, cfg)
        outs.append(o.pose_wrt_world)
    world = _compose_batch(torch.stack(outs).cpu().numpy(), base_world,
                           state.device)
    return [(frame_id0 + 1 + i, world[i]) for i in range(r)]


def _rotation_average_batch(rec: BatchRecord, cfg: ELLCConfig, device
                            ) -> np.ndarray:
    """Run RA over a batch record; returns (M, 7) corrected poses
    (frame_id, pose6) w.r.t. the batch's transition frame."""
    tf = rec.start_frame_id
    pose_abs = np.zeros((1 + len(rec.pose_rows), 8))
    pose_abs[0] = [tf, tf, 0, 0, 0, 0, 0, 0]
    for i, row in enumerate(rec.pose_rows):
        pose_abs[1 + i] = [row[0], tf, *row[2:8]]
    odometry = np.asarray(rec.odometry_rows, dtype=np.float64)
    extra = (np.asarray(rec.loop_rows, dtype=np.float64)
             if rec.loop_rows else None)
    return graph_batch.perform_rotation_averaging(
        odometry, extra, pose_abs, tf, device,
        kf_interval=cfg.keyframe_interval, sigma_deg=cfg.ra_sigma_deg,
        l1_iters=cfg.ra_l1_max_iters, irls_iters=cfg.ra_irls_max_iters,
        tol=cfg.ra_irls_tol)


def run_ellc_lc(frames: Iterable[np.ndarray], cfg: ELLCConfig, device,
                out_dir: Optional[str] = None, seed: int = 0,
                max_frames: Optional[int] = None,
                stats: Optional[dict] = None) -> LCResult:
    """The full alternating pipeline on a frame stream, on ``device``.

    ``stats``, when given, accumulates wall-clock seconds per phase:
    ``track`` (the GN batches, the loop window included), ``window`` (the
    keyframe pushes: gates and rematches), ``ra``, ``replay`` and
    ``tail``.  Writes ``poses_corrected.txt`` to ``out_dir``."""
    if cfg.do_sim3_refine:
        raise NotImplementedError("do_sim3_refine=True is not ported to "
                                  "PyTorch yet")
    timer = _Timer(stats)
    cfg = cfg.replace(do_loop_closure=True)
    # the replay feeds no loop window, so it accumulates no weights
    replay_cfg = cfg.replace(do_loop_closure=False)
    device = torch.device(device)
    it = iter(frames)
    state = pipeline.init_pipeline(
        next(it), cfg, device, generator=torch.Generator().manual_seed(seed))
    closer = closure.LoopCloser(cfg)

    K = cfg.keyframe_interval
    limit = max_frames if max_frames is not None else cfg.max_frames

    corrected: List[Tuple[int, np.ndarray]] = []   # World_pose analog
    raw: List[Tuple[int, np.ndarray]] = []
    # corrected world pose of the current transition frame
    base_world = np.zeros(6, np.float32)
    frame_id = 1
    num_batches = 0
    done = False

    def track_tail(extra_frames):
        t0 = time.perf_counter()
        rows = _track_tail(state, extra_frames, frame_id, base_world, cfg)
        raw.extend(rows)
        corrected.extend(rows)
        timer("tail", t0)

    while not done and frame_id < limit:
        batch_props = (cfg.ra_batch_size_bootstrap if num_batches == 0
                       else cfg.ra_batch_size)
        # the bootstrap batch starts at frame 1, whose first interval is
        # K-1 frames, so it takes one frame less than batch_props * K
        first = frame_id == 1
        want = batch_props * K - (1 if first else 0)
        buf: List[np.ndarray] = []
        while len(buf) < want and frame_id + len(buf) < limit:
            try:
                buf.append(np.asarray(next(it)))
            except StopIteration:
                done = True
                break
        usable = (max(((len(buf) + 1) // K) * K - 1, 0) if first
                  else (len(buf) // K) * K)
        extra_frames = buf[usable:]
        buf = buf[:usable]
        if usable == 0:
            # less than one interval left: tail frames only, no batch
            if extra_frames:
                track_tail(extra_frames)
            break

        start_id = frame_id
        t0 = time.perf_counter()
        state, rec = _track_batch(state, buf, start_id, cfg, closer,
                                  base_world=base_world, timer=timer)
        t0 = timer("track", t0)
        frame_id += len(buf)
        num_batches += 1
        raw_world = _compose_batch([row[2:8] for row in rec.pose_rows],
                                   base_world, device)
        raw += [(int(row[0]), w) for row, w in zip(rec.pose_rows, raw_world)]

        out = _rotation_average_batch(rec, cfg, device)
        # rows are w.r.t. the transition frame: compose them onto its
        # corrected world pose (small_batch_rotavg.m:43-50)
        cor_world = _compose_batch(out[:, 1:7], base_world, device)
        end_fid = start_id + len(buf)     # the batch's last keyframe
        end_world = None
        for r, w in zip(out, cor_world):
            # the transition row was emitted as the previous batch's last
            # keyframe, and frame 1 gets no pose line (main.cpp writes
            # from frame 2 on)
            if int(r[0]) != start_id:
                corrected.append((int(r[0]), w))
            if int(r[0]) == end_fid:
                end_world = w
        assert end_world is not None, \
            f"RA output is missing the transition keyframe {end_fid}"
        t0 = timer("ra", t0)

        if not done and frame_id < limit:
            # replay the batch from the saved transition depth with the
            # corrected rotations as initialization
            replay_state = pipeline.init_from_depth(
                rec.start_image, rec.start_depth, rec.start_var,
                torch.zeros(6), replay_cfg, device)
            by_id = {int(r[0]): r[1:7] for r in out}
            init_rots = np.asarray(
                [by_id.get(start_id + 1 + i, np.zeros(6))
                 for i in range(len(buf))], np.float32)
            state, _ = _track_batch(replay_state, buf, start_id, replay_cfg,
                                    None, replay=True,
                                    init_rotations=init_rots)
            # the next batch chains from the corrected end-of-batch
            # keyframe; the replayed state's keyframe pose is relative to
            # the replay origin, so rebase it to zero, and give the
            # keyframe the empty weight accumulators the window reads
            base_world = end_world
            state = dataclasses.replace(state, kf=state.kf.replace(
                world_pose=torch.zeros(6, device=device),
                weight_acc=tuple(torch.zeros_like(i)
                                 for i in state.kf.images)))
            timer("replay", t0)

        if extra_frames:
            # end-of-stream frames short of an interval: tracked against
            # the last keyframe, no new keyframe, no RA
            done = True
            track_tail(extra_frames)
            frame_id += len(extra_frames)

    if out_dir:
        with ellc_io.PoseWriter(os.path.join(out_dir, "poses_corrected.txt")
                                ) as w:
            for fid, p in corrected:
                w.write(fid, 0, p, 1.0, 0.0)

    return LCResult(world_poses=np.asarray([p for _, p in corrected]),
                    frame_ids=np.asarray([f for f, _ in corrected], np.int64),
                    raw_world_poses=np.asarray([p for _, p in raw]),
                    num_batches=num_batches,
                    num_loop_edges=len(closer.edges),
                    loop_edges=list(closer.edges))
