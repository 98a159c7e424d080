"""Multi-scale Gauss-Newton direct image alignment (the tracking core).

Port of the gather path (``window=None``) of
``egomotion_with_local_loop_closures_tpu/track/alignment.py``
(``src/PixelWisePyramid.cpp:58-491``, ``src/ImageFunc.cpp:49-315``):

- the Jacobian at the template pixel with gradients sampled from the
  current image at the warped point (PixelWisePyramid.cpp:289-320);
- residual = warped(current) - keyframe, hence the negated step;
- weight = Huber(delta=3 on the sqrt(w_p)-normalized residual) x
  1/(CAMERA_PIXEL_NOISE_2 + sigma_d^2 (dr/dd)^2) (:341-358);
- pose update xi <- log(exp(-H^-1 g) exp(xi)); the reference's
  ``weightedPose < 1`` early-out (ImageFunc.cpp:251-252) is a freeze mask
  kept on the device with ``torch.where``, so :func:`align` never waits
  for the host.

The linearize-and-reduce of :func:`_gn_quantities` is plain PyTorch here;
it is the next kernel to write by hand (K1).
"""

from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple

import torch

from egomotion_with_local_loop_closures_tpu_torch.config import ELLCConfig
from egomotion_with_local_loop_closures_tpu_torch.geom import (camera, lie,
                                                              linear)
from egomotion_with_local_loop_closures_tpu_torch.image import (interp,
                                                                pyramid)


class KeyframeLevel(NamedTuple):
    """Per-level keyframe data consumed by the aligner."""
    image: torch.Tensor   # (H, W) float32, 0..255
    depth: torch.Tensor   # (H, W) depth, 0 where invalid
    var: torch.Tensor     # (H, W) inverse-depth variance, -1 where invalid


class CurrentLevel(NamedTuple):
    """Per-level current-frame data: image + its gradients."""
    image: torch.Tensor
    gradx: torch.Tensor
    grady: torch.Tensor


class AlignDiagnostics(NamedTuple):
    weighted_pose: torch.Tensor   # termination metric after the last iter
    iters_used: torch.Tensor      # per level, number of applied updates
    final_energy: torch.Tensor    # sum of weighted squared residuals (finest)
    valid_fraction: torch.Tensor  # fraction of template pixels used (finest)
    oow_fraction: torch.Tensor    # always 0: the port samples exactly


def make_current_levels(images: Sequence[torch.Tensor]
                        ) -> Tuple[CurrentLevel, ...]:
    """Gradients per pyramid level (Frame.cpp:316-327)."""
    return tuple(CurrentLevel(img, *pyramid.gradients(img)) for img in images)


def _gn_quantities(kf: KeyframeLevel, cur: CurrentLevel, pose: torch.Tensor,
                   intr: Tuple[float, float, float, float],
                   cfg: ELLCConfig):
    """One linearization: returns (H 6x6, g 6, energy, valid_count)."""
    fx, fy, cx, cy = intr
    Hh, Ww = kf.image.shape
    x, y = camera.pixel_grid(Hh, Ww, device=kf.image.device)
    mask = kf.depth > 0.0

    T = lie.exp_se3(pose)
    P = camera.backproject(x, y, kf.depth, fx, fy, cx, cy)
    Pt = P @ T[:3, :3].T + T[:3, 3]
    wx, wy, _ = camera.project(Pt, fx, fy, cx, cy, eps=1e-10)

    warped, in_bounds = interp.bilinear(cur.image, wx, wy)
    gradx = interp.bilinear_fill(cur.gradx, wx, wy)
    grady = interp.bilinear_fill(cur.grady, wx, wy)

    # steepest-descent rows at the template pixel (u, v) = (x-cx, y-cy)
    u = x - cx
    v = y - cy
    d = torch.where(mask, kf.depth, 1.0)
    inv_d = 1.0 / d
    sd0 = gradx * (-(v * u) / fy) + grady * (-(fy + (v * v) / fy))
    sd1 = gradx * (fx + (u * u) / fx) + grady * ((v * u) / fx)
    sd2 = gradx * (-(fx * v) / fy) + grady * ((fy * u) / fx)
    sd3 = gradx * (fx * inv_d)
    sd4 = grady * (fy * inv_d)
    sd5 = gradx * (-u * inv_d) + grady * (-v * inv_d)
    J = torch.stack([sd0, sd1, sd2, sd3, sd4, sd5], dim=-1).reshape(-1, 6)

    residual = torch.where(in_bounds, warped - kf.image, 0.0)

    # variance-propagated weights (PixelWisePyramid.cpp:341-358)
    px, py, pz = Pt[..., 0], Pt[..., 1], Pt[..., 2]
    tx, ty, tz = T[0, 3], T[1, 3], T[2, 3]
    gxs = fx * gradx
    gys = fy * grady
    pz2d = torch.where(mask, pz * pz * inv_d, 1.0)
    g0 = (tx * pz - tz * px) / pz2d
    g1 = (ty * pz - tz * py) / pz2d
    drpdd = gxs * g0 + gys * g1
    s = torch.clamp_min(kf.var, 0.0)
    w_p = 1.0 / (cfg.camera_pixel_noise_2 + s * drpdd * drpdd)
    weighted_rp = torch.abs(residual * torch.sqrt(w_p))
    half_huber = cfg.huber_d / 2.0
    wh = torch.where(weighted_rp < half_huber, 1.0,
                     half_huber / torch.clamp_min(weighted_rp, 1e-12))
    used = mask & in_bounds
    weight = torch.where(used, wh * w_p, 0.0).reshape(-1)

    r = residual.reshape(-1)
    Jw = J * weight[:, None]
    Hmat = Jw.T @ J
    g = Jw.T @ r
    energy = torch.sum(weight * r * r)
    valid = torch.sum(used.to(torch.float32))
    return Hmat, g, energy, valid


def gn_level(kf: KeyframeLevel, cur: CurrentLevel, pose0: torch.Tensor,
             level: int, cfg: ELLCConfig, num_iters: int):
    """``num_iters`` GN updates at one level with the reference's early-out
    as a freeze mask: every iteration linearizes, and a converged (or
    failed) state keeps its values.  Returns (pose, weighted_pose,
    iters_used, (energy, valid_count)) from the last live linearization."""
    intr = cfg.level_intrinsics(level)
    dev = pose0.device
    term_w = torch.tensor(cfg.termination_weights, dtype=pose0.dtype,
                          device=dev)
    eye = 1e-12 * torch.eye(6, dtype=pose0.dtype, device=dev)
    pose = pose0
    done = torch.zeros((), dtype=torch.bool, device=dev)
    wp_last = torch.full((), float("inf"), dtype=pose0.dtype, device=dev)
    iters = torch.zeros((), dtype=torch.int32, device=dev)
    energy = torch.zeros((), dtype=pose0.dtype, device=dev)
    valid = torch.zeros((), dtype=pose0.dtype, device=dev)
    for _ in range(num_iters):
        Hmat, g, e, n = _gn_quantities(kf, cur, pose, intr, cfg)
        delta = -linear.solve_spd(Hmat + eye, g)
        # a singular system gives NaN, a near-singular one an astronomical
        # step; OpenCV's inv() returns zero there (PixelWisePyramid.cpp:451),
        # so the reference applies a zero update
        ok = torch.all(torch.isfinite(delta)) & (torch.max(torch.abs(delta))
                                                 < 1e3)
        delta = torch.where(ok, delta, 0.0)
        new_pose = lie.compose(delta, pose)
        wp = torch.sum(torch.abs(delta * term_w))
        pose = torch.where(done, pose, new_pose)
        wp_last = torch.where(done, wp_last, wp)
        iters = torch.where(done, iters, iters + 1)
        energy = torch.where(done, energy, e)
        valid = torch.where(done, valid, n)
        done = done | (wp < 1.0) | ~ok
    return pose, wp_last, iters, (energy, valid)


def align(kf_levels: Tuple[KeyframeLevel, ...],
          cur_levels: Tuple[CurrentLevel, ...],
          pose0: torch.Tensor,
          cfg: ELLCConfig,
          max_iters: Tuple[int, ...] | None = None
          ) -> Tuple[torch.Tensor, AlignDiagnostics]:
    """Coarse-to-fine alignment of the current frame against the keyframe
    (GetImagePoseEstimate, ImageFunc.cpp:150-299).  ``pose0`` is the
    initial guess of the current frame w.r.t. the keyframe.  Diagnostics
    come from the finest level's last live linearization."""
    if max_iters is None:
        max_iters = cfg.max_iters
    pose = pose0
    wp = None
    iters_used = []
    stats0 = None
    for level in range(cfg.num_levels - 1, -1, -1):
        pose, wp, it, stats = gn_level(kf_levels[level], cur_levels[level],
                                       pose, level, cfg,
                                       int(max_iters[level]))
        iters_used.append(it)
        if level == 0:
            stats0 = stats
    energy, valid = stats0
    diag = AlignDiagnostics(
        weighted_pose=wp,
        iters_used=torch.stack(iters_used[::-1]),
        final_energy=energy,
        valid_fraction=valid / kf_levels[0].image.numel(),
        oow_fraction=torch.zeros_like(energy),
    )
    return pose, diag
