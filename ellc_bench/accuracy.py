"""Trajectory accuracy against the renderer's ground truth: a frozen copy
of the port's ``utils/metrics.py::ate_rmse`` (the absolute trajectory
error after a similarity alignment).  Printed beside each run, never
compared for ``correct``."""

from __future__ import annotations

import torch

from ellc_bench.reference.geom import lie


def _centers(poses: torch.Tensor) -> torch.Tensor:
    """Camera centres -R^T t of world->camera twists (N, 6)."""
    T = lie.exp_se3(poses)
    return -torch.einsum("nji,nj->ni", T[..., :3, :3], T[..., :3, 3])


def ate_rmse(poses_est: torch.Tensor, poses_gt: torch.Tensor,
             align_scale: bool = True) -> torch.Tensor:
    """Absolute trajectory error (RMSE of camera-centre distances) after a
    similarity alignment (Umeyama, with the reflection fix).  Poses are
    (N, 6) twists in the pipeline's poseWrtWorld convention; camera
    centres are ``-R^T t``.  Float32, like the JAX package."""
    X = _centers(poses_est.to(torch.float32))
    Y = _centers(poses_gt.to(torch.float32))
    mx, my = X.mean(0), Y.mean(0)
    Xc, Yc = X - mx, Y - my
    # Umeyama: s, R, t minimizing ||Y - (s R X + t)||
    cov = Yc.T @ Xc / X.shape[0]
    U, S, Vt = torch.linalg.svd(cov)
    d = torch.sign(torch.linalg.det(U @ Vt))
    D = torch.stack([torch.ones_like(d), torch.ones_like(d), d])
    R = U @ torch.diag(D) @ Vt
    if align_scale:
        var_x = torch.mean(torch.sum(Xc * Xc, dim=1))
        s = torch.sum(S * D) / torch.clamp_min(var_x, 1e-12)
    else:
        s = 1.0
    err = torch.linalg.vector_norm(s * Xc @ R.T + my - Y, dim=1)
    return torch.sqrt(torch.mean(err * err))
