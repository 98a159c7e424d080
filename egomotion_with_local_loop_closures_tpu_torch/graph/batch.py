"""Per-batch pose-graph correction: the MATLAB batch scripts, in-process.

Port of ``egomotion_with_local_loop_closures_tpu/graph/batch.py``
(``matlab_scripts/small_batch_rotavg{,_bootstrap}.m`` +
``perform_rotation_averaging_transition1.m``): assemble keyframe-to-
keyframe odometry edges and loop-closure edges, run robust rotation
averaging over the batch, keep the odometry translations, and
re-concatenate non-keyframe poses onto the averaged keyframe rotations.
The bookkeeping is host numpy; the Lie algebra and the solvers run in
float32 torch on the caller's device.

Array formats mirror the reference files:
- pose rows: ``frame_id kf_id wx wy wz vx vy vz ...``
- edges carry the pose of ``frame_id`` w.r.t. ``kf_id``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from egomotion_with_local_loop_closures_tpu_torch.geom import lie
from egomotion_with_local_loop_closures_tpu_torch.graph import (
    rotation_averaging as ra)


def _f32(a, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, np.float32), device=device)


def perform_rotation_averaging(odometry: np.ndarray,
                               extra: Optional[np.ndarray],
                               pose_abs: np.ndarray,
                               transition_id: int,
                               device,
                               kf_interval: int = 8,
                               sigma_deg: float = 5.0,
                               l1_iters: int = 10, irls_iters: int = 100,
                               tol: float = 1e-3) -> np.ndarray:
    """Port of perform_rotation_averaging_transition1.m.

    Args:
      odometry: (N, >=8) rows ``frame_id kf_id pose6``, the per-frame
        odometry edges of the batch.
      extra: (K, >=8) loop-closure edges or None.
      pose_abs: (M, >=8) rows ``frame_id transition_id pose6``, world
        poses of all batch frames w.r.t. the transition frame, including
        the transition frame itself as an identity row.
      transition_id: the batch's anchor frame id.
      device: where the Lie algebra and the solvers run.

    Returns:
      (M, 7) rows ``frame_id pose6``: corrected poses w.r.t. the transition
      frame (averaged rotations for keyframes, original translations;
      non-keyframe poses re-concatenated onto their keyframe).
    """
    device = torch.device(device)
    odometry = np.asarray(odometry, dtype=np.float64)
    pose_abs = np.asarray(pose_abs, dtype=np.float64)

    # keep only KF->KF odometry edges (id gap >= kf_interval, :23-29)
    kf_edges = odometry[odometry[:, 0] - odometry[:, 1] >= kf_interval]
    delim = np.zeros((1, odometry.shape[1]))
    delim[0, 0] = delim[0, 1] = transition_id
    parts = [delim, kf_edges]
    if extra is not None and len(extra):
        parts.append(np.asarray(extra, dtype=np.float64)[:, :odometry.shape[1]])
    edges = np.concatenate(parts, axis=0)
    edges = edges[np.argsort(edges[:, 0], kind="stable")]

    # dense node reindex (:53-62); from = keyframe, to = frame
    node_ids = np.unique(np.concatenate([edges[:, 0], edges[:, 1]]))
    idx_of = {int(f): i for i, f in enumerate(node_ids)}
    I = np.asarray([[idx_of[int(k)] for k in edges[:, 1]],
                    [idx_of[int(f)] for f in edges[:, 0]]], np.int64)
    RR = lie.exp_se3(_f32(edges[:, 2:8], device))[:, :3, :3]

    R_avg = ra.average_so3_graph(RR.cpu().numpy(), I, device,
                                 sigma_deg=sigma_deg, l1_iters=l1_iters,
                                 irls_iters=irls_iters, tol=tol)

    # averaged log-rotations + ORIGINAL translations of the KF world poses
    # (:79-82); keyframes are the transition frame plus the ids divisible
    # by kf_interval, the union of the bootstrap and steady-state branches
    # (:39-46)
    kf_mask = ((pose_abs[:, 0] == transition_id)
               | (np.mod(pose_abs[:, 0], kf_interval) == 0))
    kf_rows = pose_abs[kf_mask]
    ws = lie.log_so3(_f32(R_avg, device)).cpu().numpy()
    so3 = np.zeros((len(node_ids), 7))
    for i, f in enumerate(node_ids):
        row = kf_rows[kf_rows[:, 0] == f]
        trans = row[0, 5:8] if len(row) else np.zeros(3)
        so3[i] = [f, *ws[i], *trans]

    # re-concatenate non-KF poses onto the averaged keyframe poses
    # (:88-98): the host picks each row's relative pose and anchor
    # keyframe, then one batched compose does the Lie algebra
    out = np.zeros((len(pose_abs), 7))
    odo_of = {int(r[0]): r for r in odometry}
    so3_of = {int(r[0]): r for r in so3}
    last_kf = so3[0]
    rel6_all = np.zeros((len(pose_abs), 6), np.float32)
    base_all = np.zeros((len(pose_abs), 6), np.float32)
    is_cat = np.zeros(len(pose_abs), bool)
    for i, row in enumerate(pose_abs):
        f = int(row[0])
        out[i, 0] = f
        if f in so3_of:
            last_kf = so3_of[f]
            out[i, 1:7] = last_kf[1:7]
        else:
            rel = odo_of.get(f, None)
            rel6_all[i] = rel[2:8] if rel is not None else row[2:8]
            base_all[i] = last_kf[1:7]
            is_cat[i] = True
    if is_cat.any():
        out[is_cat, 1:7] = lie.compose(
            _f32(rel6_all[is_cat], device),
            _f32(base_all[is_cat], device)).cpu().numpy()
    return out


def batch_edges_from_files(matchframes: np.ndarray,
                           globalopt: Optional[np.ndarray],
                           transition_id: int
                           ) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """Filter edge files to the current batch (small_batch_rotavg.m:69-79):
    keep rows whose frame AND keyframe ids are >= the transition frame."""
    mf = matchframes[(matchframes[:, 0] >= transition_id)
                     & (matchframes[:, 1] >= transition_id)]
    go = None
    if globalopt is not None and len(globalopt):
        go = globalopt[(globalopt[:, 0] >= transition_id)
                       & (globalopt[:, 1] >= transition_id)]
        if not len(go):
            go = None
    return mf, go
