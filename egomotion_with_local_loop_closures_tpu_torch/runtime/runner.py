"""Sequence runner: drives the pipeline over a frame source and writes the
reference-format output files.

Port of ``run_sequence`` from
``egomotion_with_local_loop_closures_tpu/runtime/runner.py`` (the
reference binary's default mode, ``src/main.cpp:76-79``): per-frame world
poses go to ``poses_orig.txt`` and per-keyframe odometry edges to
``matchframes.txt``.  With ``cfg.do_loop_closure`` each finalized
keyframe is pushed to the loop window and the loop-closure edges go to
``matchframes_globalopt.txt``.  The alternating GN / rotation-averaging
mode lives in ``runtime/ellc_lc.py``.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass, field
from typing import Iterable, List, Optional

import numpy as np
import torch

from egomotion_with_local_loop_closures_tpu_torch.config import ELLCConfig
from egomotion_with_local_loop_closures_tpu_torch.runtime import io as ellc_io
from egomotion_with_local_loop_closures_tpu_torch.runtime import pipeline


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
                 checkpoint_dir: Optional[str] = None) -> RunResult:
    """Track a sequence on ``device`` with keyframing every
    ``cfg.keyframe_interval`` frames.  ``frames`` yields (H, W) float32
    grayscale images in [0, 255].

    Keyframe ids follow the reference's ``frame_counter % K == 0`` rule
    (main.cpp:404): the first interval tracks frames 2..K against frame 1,
    later intervals K frames each, and a tail shorter than an interval runs
    frame by frame with no final keyframe.  ``max_frames`` stops the
    source as the JAX runner does.  With ``cfg.bootstrap_rng == "jax"`` the
    random depth init is drawn from a CPU ``torch.Generator`` seeded with
    ``seed``; it cannot reproduce the JAX package's bits for that seed.
    With ``cfg.do_loop_closure`` the loop edges are returned in
    ``extra["loop_edges"]``.  Checkpoints are not ported yet."""
    if checkpoint_dir is not None:
        raise NotImplementedError("checkpoints are not ported to PyTorch yet")
    pipeline.check_supported(cfg)
    device = torch.device(device)
    it = iter(frames)
    gen = torch.Generator().manual_seed(seed)
    state = pipeline.init_pipeline(next(it), cfg, device, generator=gen)

    pose_w = match_w = loop_w = closer = None
    if out_dir:
        pose_w = ellc_io.PoseWriter(os.path.join(out_dir, "poses_orig.txt"))
        match_w = ellc_io.PoseWriter(os.path.join(out_dir, "matchframes.txt"),
                                     kind="match")
    if cfg.do_loop_closure:
        from egomotion_with_local_loop_closures_tpu_torch.loop import closure
        closer = closure.LoopCloser(cfg)
        if out_dir:
            loop_w = ellc_io.PoseWriter(
                os.path.join(out_dir, "matchframes_globalopt.txt"),
                kind="match")

    ids: List[int] = []
    kfids: List[int] = []
    poses: List[np.ndarray] = []
    rescales: List[float] = []
    seeds_l: List[float] = []
    block_times = []

    frame_id = 1      # reference frame ids start at 1 (Frame.cpp:37)
    kf_id = 1
    limit = max_frames if max_frames is not None else cfg.max_frames
    K = cfg.keyframe_interval

    def emit(outs: pipeline.FrameOutput, kf_eligible: bool) -> None:
        nonlocal frame_id, kf_id
        o = {k: v.cpu().numpy() for k, v in vars(outs).items()}
        for j in range(len(o["seeds"])):
            frame_id += 1
            ids.append(frame_id)
            kfids.append(kf_id)
            poses.append(o["pose_wrt_world"][j])
            rescales.append(float(o["rescale"][j]))
            seeds_l.append(float(o["seeds"][j]))
            if pose_w:
                pose_w.write(frame_id, kf_id, o["pose_wrt_world"][j],
                             o["rescale"][j], o["seeds"][j])
            is_kf = kf_eligible and frame_id % K == 0
            if match_w and is_kf:
                match_w.write(frame_id, kf_id, o["pose_wrt_kf"][j],
                              o["rescale"][j], o["seeds"][j])
            if is_kf:
                kf_id = frame_id
        block_times.append((len(ids), time.perf_counter()))

    try:
        done = False
        while not done:
            want = K - 1 if frame_id == 1 else K
            buf: List[np.ndarray] = []
            while len(buf) < want:
                try:
                    buf.append(np.asarray(next(it)))
                except StopIteration:
                    done = True
                    break
                if frame_id + len(buf) - 1 >= limit:
                    done = True
                    break
            if not buf:
                break
            if len(buf) == want:
                state, outs, snap = pipeline.process_interval(state, buf, cfg)
                if closer is not None:
                    # push the finalized OLD keyframe (pushToArray,
                    # main.cpp:452-465) and write its loop edges
                    edges = closer.push_keyframe(
                        kf_id, snap.image, snap.kf_levels,
                        snap.weight_levels, snap.world_pose, snap.rescale,
                        snap.seeds)
                    for e in (edges if loop_w else ()):
                        loop_w.write(e.frame_id, e.matched_kf_id,
                                     e.pose_wrt_matched, e.rescale, e.seeds,
                                     extras=(e.match_value, e.rms_error,
                                             e.view_angle))
                emit(outs, kf_eligible=True)
            else:
                outs = []
                for img in buf:
                    state, o = pipeline.track_refine_step(state, img, cfg)
                    outs.append(o)
                emit(pipeline.stack_outputs(outs), kf_eligible=False)
    finally:
        for w in (pose_w, match_w, loop_w):
            if w:
                w.close()

    extra = {"block_times": block_times}
    if closer is not None:
        extra["loop_edges"] = closer.edges
    return RunResult(world_poses=np.asarray(poses),
                     frame_ids=np.asarray(ids, dtype=np.int64),
                     kf_ids=np.asarray(kfids, dtype=np.int64),
                     rescales=np.asarray(rescales),
                     seeds=np.asarray(seeds_l), extra=extra)
