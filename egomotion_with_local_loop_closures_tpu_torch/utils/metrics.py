"""Trajectory and rotation-graph accuracy metrics.

Port of ``egomotion_with_local_loop_closures_tpu/utils/metrics.py``: the
reference's ``matlab_scripts/SO3GraphAveraging/CompareRotations.m`` (mean,
median, RMS and max angle in degrees between two rotation sets after
anchoring both at their first element), the Umeyama-aligned ATE-RMSE, and
the dense reprojection check that stands in for the reference's
``Tests::calculateReprojectionError`` (``src/Tests.h:21-206``).

Medians average the two middle values of an even count, as ``jnp.median``
does (``torch.median`` would return the lower one).  Every result is a
0-d tensor on the inputs' device.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from egomotion_with_local_loop_closures_tpu_torch.geom import camera, lie


def _median(x: torch.Tensor) -> torch.Tensor:
    """Median of the non-NaN values, the two middle ones averaged for an
    even count (``jnp.nanmedian``); NaN when there is none."""
    x = x.reshape(-1)
    x = torch.sort(x[~torch.isnan(x)]).values
    n = x.numel()
    if n == 0:
        return torch.full((), float("nan"), dtype=x.dtype, device=x.device)
    return 0.5 * (x[(n - 1) // 2] + x[n // 2])


def compare_rotations(R1: torch.Tensor, R2: torch.Tensor
                      ) -> Dict[str, torch.Tensor]:
    """Angular errors (deg) between rotation sets (N, 3, 3) after
    anchoring both at their first element, ``R2 R2(1)' R1(1)``
    (CompareRotations.m:4-17)."""
    align = R2[0].transpose(-1, -2) @ R1[0]
    e = lie.rotation_angle_deg(R1, R2 @ align)
    return {
        "mean_deg": torch.mean(e),
        "median_deg": _median(e),
        "rms_deg": torch.sqrt(torch.mean(e * e)),
        "max_deg": torch.max(e),
    }


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


def reprojection_error(pose_est: torch.Tensor, depth_ref: torch.Tensor,
                       pose_true: torch.Tensor,
                       fx: float, fy: float, cx: float, cy: float,
                       grad_mask: Optional[torch.Tensor] = None
                       ) -> Dict[str, torch.Tensor]:
    """Pose accuracy by dense point reprojection: every reference pixel
    with known depth is back-projected, moved by the estimated and by the
    true relative pose and projected into the second view; returns the
    pixel distance between the two projections (mean, median, max and sum
    over the valid pixels, and their count).  ``grad_mask`` optionally
    restricts it to high-gradient pixels, like the reference's keypoint
    selection."""
    H, W = depth_ref.shape
    x, y = camera.pixel_grid(H, W, device=depth_ref.device,
                             dtype=depth_ref.dtype)
    valid = depth_ref > 0
    if grad_mask is not None:
        valid = valid & grad_mask
    P = camera.backproject(x, y, torch.where(valid, depth_ref, 1.0),
                           fx, fy, cx, cy)

    def proj(pose):
        T = lie.exp_se3(pose)
        Pt = torch.einsum("ij,hwj->hwi", T[:3, :3], P) + T[:3, 3]
        return camera.project(Pt, fx, fy, cx, cy, eps=1e-10)

    ue, ve, ze = proj(pose_est)
    ut, vt, zt = proj(pose_true)
    ok = valid & (ze > 1e-6) & (zt > 1e-6)
    d = torch.where(ok, torch.sqrt((ue - ut) ** 2 + (ve - vt) ** 2),
                    float("nan"))
    n = torch.clamp_min(torch.sum(ok), 1)
    return {
        "mean_px": torch.nansum(d) / n,
        "median_px": _median(d),
        "max_px": torch.max(torch.where(ok, d, float("-inf"))),
        "sum_px": torch.nansum(d),
        "num_points": torch.sum(ok),
    }
