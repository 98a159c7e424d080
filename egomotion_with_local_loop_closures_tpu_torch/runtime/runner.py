"""Sequence runner: drives the pipeline over a frame source and writes the
reference-format output files.

Port of ``run_sequence`` from
``egomotion_with_local_loop_closures_tpu/runtime/runner.py`` (the
reference binary's default mode, ``src/main.cpp:76-79``): per-frame world
poses go to ``poses_orig.txt`` and per-keyframe odometry edges to
``matchframes.txt``.  With ``cfg.do_loop_closure`` each finalized
keyframe is pushed to the loop window and the loop-closure edges go to
``matchframes_globalopt.txt``.  With ``cfg.restore_connection`` a frame
whose depth map has died is re-localized against the loop window.  The
alternating GN / rotation-averaging mode lives in ``runtime/ellc_lc.py``.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass, field
from typing import Iterable, List, Optional

import numpy as np
import torch

from egomotion_with_local_loop_closures_tpu_torch.config import ELLCConfig
from egomotion_with_local_loop_closures_tpu_torch.depth import state as dstate
from egomotion_with_local_loop_closures_tpu_torch.loop import closure, recovery
from egomotion_with_local_loop_closures_tpu_torch.runtime import (
    checkpoint, io as ellc_io, pipeline)

# the frame source of both runners, under the JAX package's name for it
# (runtime/runner.py there): the frames as float32 tensors on a device,
# undistorted when cfg.do_undistortion is set
undistort_source = pipeline.undistort_source


@dataclass
class RunResult:
    world_poses: np.ndarray        # (N, 6) poseWrtWorld per tracked frame
    frame_ids: np.ndarray          # (N,)
    kf_ids: np.ndarray             # (N,)
    rescales: np.ndarray           # (N,)
    seeds: np.ndarray              # (N,)
    # "block_times": (frames emitted so far, time.perf_counter()) after
    # each block's outputs reached the host
    extra: dict = field(default_factory=dict)


def run_sequence(frames: Iterable[np.ndarray], cfg: ELLCConfig, device,
                 out_dir: Optional[str] = None,
                 seed: int = 0,
                 max_frames: Optional[int] = None,
                 checkpoint_dir: Optional[str] = None,
                 checkpoint_every: int = 4,
                 resume: bool = False,
                 intervals_per_dispatch: int = 4) -> RunResult:
    """Track a sequence on ``device`` with keyframing every
    ``cfg.keyframe_interval`` frames.  ``frames`` yields (H, W) float32
    grayscale images in [0, 255], undistorted first when
    ``cfg.do_undistortion`` is set.

    Frames run one at a time.  Keyframe ids follow the reference's
    ``frame_counter % K == 0`` rule (main.cpp:404), through recoveries
    too: the first interval tracks frames 2..K against frame 1, later
    intervals K frames each, and a tail shorter than an interval has no
    final keyframe.  On a CUDA device every frame step replays its
    captured graph (``runtime/graphs.py``), so nothing waits for the
    device until the outputs are read back.  Without the loop window and
    without recovery nothing needs them earlier: they are read once after
    the first interval and then once every ``intervals_per_dispatch``
    intervals, as the JAX runner reads each ``process_intervals``
    dispatch.  With the loop window (``do_loop_closure``) or
    ``restore_connection`` they are read once per interval (and at a
    recovery).  ``extra["block_times"]`` holds one entry per read.
    ``max_frames`` stops the source as the JAX runner does: the frame
    that reaches the limit is still tracked, except with
    ``cfg.restore_connection``, whose JAX loop stops on it.  With
    ``cfg.bootstrap_rng == "jax"`` the random depth init is drawn from a
    CPU ``torch.Generator`` seeded with ``seed``; it cannot reproduce the
    JAX package's bits for that seed.

    With ``cfg.do_loop_closure`` the loop edges are returned in
    ``extra["loop_edges"]``.  With ``cfg.restore_connection`` the depth
    map's seeds are read before each frame (main.cpp:252-324); when
    tracking is lost the frame is re-localized against the loop window
    (``loop.recovery.find_connection``) and, on success, becomes a
    keyframe carrying the matched candidate's propagated depth map, with
    ``global_scale`` multiplied by its rescale.  A frame that cannot be
    re-localized is dropped with no pose line (main.cpp:317-323).
    ``extra["recoveries"]`` holds (frame id, matched keyframe, recovered
    pose w.r.t. it, seeds%) and ``extra["dropped_frames"]`` the dropped
    ids.

    With ``checkpoint_dir``, the pipeline state is saved after every
    ``checkpoint_every`` keyframe intervals (``runtime/checkpoint.py``),
    so always on a keyframe of the K grid, with the outputs up to it
    read and written first; ``resume=True`` restores the newest snapshot
    and skips the source's frames up to it, as the reference's batch
    restart skips the video to BATCH_START_ID (main.cpp:156-166).  The
    loop window starts empty after a resume, as after the reference's
    process restart."""
    device = torch.device(device)
    it = pipeline.undistort_source(frames, cfg, device)
    gen = torch.Generator().manual_seed(seed)
    state = pipeline.init_pipeline(next(it), cfg, device, generator=gen)

    frame_id = 1      # reference frame ids start at 1 (Frame.cpp:37)
    kf_id = 1
    ckpt = None
    if checkpoint_dir is not None:
        ckpt = checkpoint.CheckpointManager(checkpoint_dir)
        if resume and ckpt.latest_step() is not None:
            state, meta = ckpt.restore(cfg, device)
            frame_id, kf_id = int(meta["frame_id"]), int(meta["kf_id"])
            for _ in range(frame_id - 1):
                next(it)

    pose_w = match_w = loop_w = None
    if out_dir:
        pose_w = ellc_io.PoseWriter(os.path.join(out_dir, "poses_orig.txt"))
        match_w = ellc_io.PoseWriter(os.path.join(out_dir, "matchframes.txt"),
                                     kind="match")
        if cfg.do_loop_closure:
            loop_w = ellc_io.PoseWriter(
                os.path.join(out_dir, "matchframes_globalopt.txt"),
                kind="match")
    # the window is fed even without loop-closure edges: recovery needs
    # its candidates
    closer = closure.LoopCloser(cfg) if pipeline._needs_window(cfg) else None

    ids: List[int] = []
    kfids: List[int] = []
    poses: List[np.ndarray] = []
    rescales: List[float] = []
    seeds_l: List[float] = []
    recoveries: List[dict] = []
    dropped: List[int] = []
    block_times = []
    # (frame id, keyframe id, keyframe step?, FrameOutput) not read yet
    pending: List[tuple] = []
    # intervals a read: without the loop window and recovery nothing needs
    # the outputs before the run's end
    per_read = (max(1, intervals_per_dispatch)
                if closer is None and not cfg.restore_connection else 1)

    limit = max_frames if max_frames is not None else cfg.max_frames
    last = limit if cfg.restore_connection else limit + 1
    K = cfg.keyframe_interval
    intervals = 0

    def record(fid: int, kid: int, world, rescale, seeds) -> None:
        ids.append(fid)
        kfids.append(kid)
        poses.append(world)
        rescales.append(float(rescale))
        seeds_l.append(float(seeds))
        if pose_w:
            pose_w.write(fid, kid, world, rescale, seeds)

    def flush() -> None:
        """Read the pending frames' outputs back and write their lines."""
        if not pending:
            return
        o = {k: v.cpu().numpy() for k, v in vars(pipeline.stack_outputs(
            [p[3] for p in pending])).items()}
        for j, (fid, kid, is_kf, _) in enumerate(pending):
            record(fid, kid, o["pose_wrt_world"][j], o["rescale"][j],
                   o["seeds"][j])
            if match_w and is_kf:
                match_w.write(fid, kid, o["pose_wrt_kf"][j], o["rescale"][j],
                              o["seeds"][j])
        pending.clear()
        block_times.append((len(ids), time.perf_counter()))

    try:
        for image in it:
            if frame_id >= last:
                break
            frame_id += 1
            if cfg.restore_connection and recovery.check_connection(
                    float(dstate.seeds_percent(state.depth)), cfg):
                rec = recovery.find_connection(closer, frame_id, image, cfg)
                if rec is None:
                    dropped.append(frame_id)     # connection still lost
                    continue
                # the stray frame becomes a keyframe with the propagated
                # depth map (main.cpp:262-315)
                kf, st = pipeline.make_keyframe(image, rec.depth_state,
                                                rec.world_pose, rec.rescale,
                                                cfg)
                state = pipeline.PipelineState(
                    kf=kf, depth=st, prev_wrt_kf=torch.zeros(6, device=device),
                    global_scale=state.global_scale * rec.rescale)
                recoveries.append({
                    "frame_id": frame_id, "matched_kf_id": rec.matched_kf_id,
                    "pose_wrt_matched": rec.pose_wrt_matched.cpu().numpy(),
                    "seeds": rec.seeds})
                flush()
                record(frame_id, kf_id, rec.world_pose.cpu().numpy(),
                       float(rec.rescale), rec.seeds)
                block_times.append((len(ids), time.perf_counter()))
                kf_id = frame_id
                continue

            if frame_id % K:
                state, out = pipeline.track_refine_step(state, image, cfg)
                pending.append((frame_id, kf_id, False, out))
                continue
            state, out, snap = pipeline.keyframe_step(state, image, cfg)
            if closer is not None:
                # push the finalized OLD keyframe (pushToArray,
                # main.cpp:452-465) and write its loop edges
                edges = closer.push_keyframe(
                    kf_id, snap.image, snap.kf_levels, snap.weight_levels,
                    snap.world_pose, snap.rescale, snap.seeds,
                    depth_state=snap.depth_state, match=cfg.do_loop_closure)
                for e in (edges if loop_w else ()):
                    _write_edge(loop_w, e)
            pending.append((frame_id, kf_id, True, out))
            kf_id = frame_id
            intervals += 1
            # the first interval alone, then per_read intervals a read
            if (intervals - 1) % per_read == 0:
                flush()
            if ckpt is not None and intervals % checkpoint_every == 0:
                flush()
                ckpt.save(frame_id, state,
                          meta={"frame_id": frame_id, "kf_id": kf_id})
        flush()
    finally:
        for w in (pose_w, match_w, loop_w):
            if w:
                w.close()

    extra = {"block_times": block_times}
    if closer is not None:
        extra["loop_edges"] = closer.edges
    if cfg.restore_connection:
        extra["recoveries"] = recoveries
        extra["dropped_frames"] = dropped
    return RunResult(world_poses=np.asarray(poses),
                     frame_ids=np.asarray(ids, dtype=np.int64),
                     kf_ids=np.asarray(kfids, dtype=np.int64),
                     rescales=np.asarray(rescales),
                     seeds=np.asarray(seeds_l), extra=extra)


def _write_edge(writer: ellc_io.PoseWriter, e) -> None:
    """One matchframes_globalopt.txt line (GlobalOptimize.cpp:574-582)."""
    writer.write(e.frame_id, e.matched_kf_id, e.pose_wrt_matched, e.rescale,
                 e.seeds, extras=(e.match_value, e.rms_error, e.view_angle))
