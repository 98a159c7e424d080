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
against the last keyframe without a new keyframe or RA.  With
``do_sim3_refine`` the corrected trajectory is then refined once more:
a Sim(3) pose graph over its keyframes, the odometry chain and the loop
edges, solved by ``graph/ba.py`` (:func:`_sim3_refine_trajectory`).

Two faults of the JAX package are not copied: a stream that ends exactly
on a batch boundary does not call the tail tracker with no frames (which
trips its assertion there), and the replay without rotations passes None,
not zero rotations.
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
    # Sim(3)-refined world poses (cfg.do_sim3_refine), else None
    sim3_world_poses: Optional[np.ndarray] = None


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
    keyframe.  Every interval replays its captured graph on a CUDA
    state, and the batch's poses are read back once, at its end, as the
    JAX package reads its batch dispatches.  A batch starting at frame 1
    tracks K-1 frames in its first interval, so keyframes land on
    multiples of K (main.cpp:404).  With a
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
    kf_id = start_frame_id
    b = 0
    kf_ids, outs = [], []
    while b < len(frames):
        size = (K - 1) if (first and b == 0) else K
        rots = (None if init_rotations is None
                else init_rotations[b:b + size])
        state, out, snapshot = pipeline.process_interval(
            state, frames[b:b + size], cfg, replay, rots)
        outs.append(out)
        kf_ids += [kf_id] * size
        if closer is not None:
            # the push reads the gates back: wait for the interval's
            # replays here, so that their time counts as tracking
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            world_global = lie.compose(
                snapshot.world_pose,
                torch.as_tensor(base_world, device=dev))
            edges = closer.push_keyframe(
                kf_id, snapshot.image, snapshot.kf_levels,
                snapshot.weight_levels, world_global, snapshot.rescale,
                snapshot.seeds, depth_state=snapshot.depth_state)
            rec.loop_rows += [[e.frame_id, e.matched_kf_id,
                               *e.pose_wrt_matched] for e in edges]
            timer("window", t0)
        kf_id += size
        b += size
    # the batch's poses, read back once
    world = torch.cat([o.pose_wrt_world for o in outs]).cpu().numpy()
    rel = torch.cat([o.pose_wrt_kf for o in outs]).cpu().numpy()
    for j, kid in enumerate(kf_ids):
        fid = start_frame_id + 1 + j
        rec.pose_rows.append([fid, kid, *world[j]])
        rec.odometry_rows.append([fid, kid, *rel[j]])
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
    keyframe pushes: gates and rematches), ``ra``, ``replay``, ``tail``
    and ``sim3``.  Writes ``poses_corrected.txt`` to ``out_dir``, and
    ``poses_sim3.txt`` with ``cfg.do_sim3_refine``."""
    timer = _Timer(stats)
    cfg = cfg.replace(do_loop_closure=True)
    # the replay feeds no loop window, so it accumulates no weights
    replay_cfg = cfg.replace(do_loop_closure=False,
                             restore_connection=False)
    device = torch.device(device)
    it = pipeline.undistort_source(frames, cfg, device)
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
        buf: List[torch.Tensor] = []
        while len(buf) < want and frame_id + len(buf) < limit:
            try:
                buf.append(next(it))
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

    ids = np.asarray([f for f, _ in corrected], np.int64)
    poses = np.asarray([p for _, p in corrected])
    sim3_poses = None
    if cfg.do_sim3_refine and len(ids) > K:
        t0 = time.perf_counter()
        sim3_poses = _sim3_refine_trajectory(ids, poses, closer.edges, cfg,
                                             device)
        timer("sim3", t0)
    if out_dir:
        files = [("poses_corrected.txt", poses)]
        if sim3_poses is not None:
            files.append(("poses_sim3.txt", sim3_poses))
        for name, ps in files:
            with ellc_io.PoseWriter(os.path.join(out_dir, name)) as w:
                for fid, p in zip(ids, ps):
                    w.write(int(fid), 0, p, 1.0, 0.0)

    return LCResult(world_poses=poses, frame_ids=ids,
                    raw_world_poses=np.asarray([p for _, p in raw]),
                    num_batches=num_batches,
                    num_loop_edges=len(closer.edges),
                    loop_edges=list(closer.edges),
                    sim3_world_poses=sim3_poses)


def _sim3_refine_trajectory(ids: np.ndarray, poses: np.ndarray,
                            loop_edges, cfg: ELLCConfig, device
                            ) -> Optional[np.ndarray]:
    """The final Sim(3) refinement of a corrected trajectory: a pose graph
    over the keyframes (ids divisible by K, main.cpp:404), with the
    odometry chain and the loop edges between keyframes that are in it,
    solved by ``ba.refine`` (``cfg.sim3_iters`` Gauss-Newton iterations)
    on ``device``; every other frame then rides rigidly on the keyframe
    before it, all in one batched compose.  None with fewer than three
    keyframes.  One host read, at the end."""
    from egomotion_with_local_loop_closures_tpu_torch.graph import ba, sim3

    kf_mask = ids % cfg.keyframe_interval == 0
    kf_idx = np.nonzero(kf_mask)[0]
    if len(kf_idx) < 3:
        return None
    id2node = {int(f): k for k, f in enumerate(ids[kf_idx])}
    # edge measurement: X_j = rel * X_i, rel = pose of frame j w.r.t. the
    # matched keyframe i
    lc = [(id2node[int(e.matched_kf_id)], id2node[int(e.frame_id)],
           np.asarray(e.pose_wrt_matched, np.float32)) for e in loop_edges
          if int(e.matched_kf_id) in id2node and int(e.frame_id) in id2node]
    g = sim3.graph_from_trajectory(poses[kf_idx], np.ones(len(kf_idx)),
                                   loop_edges=lc, device=device)
    refined = ba.refine(g, num_iters=cfg.sim3_iters).nodes

    src = torch.as_tensor(np.asarray(poses, np.float32), device=device)
    kf_t = torch.as_tensor(kf_idx, device=device)
    out = src.index_copy(0, kf_t, refined[:, :6])
    # the keyframe each frame rides on: the last one at or before it
    anchor = np.maximum.accumulate(np.where(kf_mask, np.arange(len(ids)), -1))
    ride = np.nonzero(~kf_mask & (anchor >= 0))[0]
    if len(ride):
        r_t = torch.as_tensor(ride, device=device)
        a_t = torch.as_tensor(anchor[ride], device=device)
        out = out.index_copy(0, r_t, lie.compose(
            lie.relative(src[r_t], src[a_t]), out[a_t]))
    return out.cpu().numpy()
