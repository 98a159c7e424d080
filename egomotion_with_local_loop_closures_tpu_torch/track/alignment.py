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

The loop-closure rematch uses the constant-weight (inverse-compositional)
aligner, :func:`align_const_weight`, batched over a leading candidate
axis in place of the JAX package's ``vmap``.  :func:`align` likewise
tracks V videos at once (the batched pipeline, ``parallel/sharded.py``):
keyframe and current levels (V, H, W), poses (V, 6), one 6x6 system and
one freeze mask per video.

On the card, :func:`gn_level` (so :func:`align`) runs a level's
iterations, each the linearize-and-reduce of :func:`_gn_quantities` and
the solve, pose update and freeze mask of :func:`_gn_update`, in the
hand-written CUDA kernels of K1 (``ops/gn_kernel.py``,
``csrc/gn_kernel.cu``): a small level in one thread-block-cluster
launch, a larger one a launch an iteration.  Here those functions are K1's plain twin, which runs
on the CPU and against which the kernels are held.  The constant-weight
iteration of :func:`gn_level_const_weight` (K5, the same warp and
reduction with fixed weights) and :func:`weight_image` are plain PyTorch
on every device.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple, Sequence, Tuple

import torch

from egomotion_with_local_loop_closures_tpu_torch.config import ELLCConfig
from egomotion_with_local_loop_closures_tpu_torch.depth import fusion
from egomotion_with_local_loop_closures_tpu_torch.geom import (camera, lie,
                                                              linear)
from egomotion_with_local_loop_closures_tpu_torch.image import (interp,
                                                                pyramid)
from egomotion_with_local_loop_closures_tpu_torch.utils import profiling


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


def make_keyframe_levels(image: torch.Tensor, depth0: torch.Tensor,
                         var0: torch.Tensor, cfg: ELLCConfig
                         ) -> Tuple[KeyframeLevel, ...]:
    """The full keyframe pyramid: the Gaussian image pyramid and the
    inverse-variance-fused depth/var pyramid (DepthPropagation.cpp:1637-1719).
    The pipeline keeps these planes in its ``Keyframe`` and builds its
    levels from them (``runtime/pipeline.py::_kf_levels``)."""
    imgs = pyramid.build_pyramid(image, cfg.num_levels)
    depths, vars_ = fusion.build_depth_var_pyramid(depth0, var0,
                                                   cfg.num_levels)
    return tuple(KeyframeLevel(i, d, v)
                 for i, d, v in zip(imgs, depths, vars_))


def make_current_levels(images: Sequence[torch.Tensor]
                        ) -> Tuple[CurrentLevel, ...]:
    """Gradients per pyramid level (Frame.cpp:316-327)."""
    return tuple(CurrentLevel(img, *pyramid.gradients(img)) for img in images)


def current_levels(levels: pyramid.Levels) -> Tuple[CurrentLevel, ...]:
    """The current levels of a frame's ``pyramid.build_levels`` (its
    pyramid and every level's gradients, one kernel launch on the
    card)."""
    return tuple(CurrentLevel(*lv) for lv in zip(
        levels.images, levels.gradx, levels.grady))


def _pixel_terms(kf: KeyframeLevel, cur: CurrentLevel, pose: torch.Tensor,
                 intr: Tuple[float, float, float, float], cfg: ELLCConfig,
                 y_offset: int = 0):
    """Warp every template pixel into the current frame at ``pose``:
    returns the current gradients sampled there, the residual, the GN
    weight, the used-pixel mask and the template terms (u, v, 1/d).

    For V videos at once every level field is (V, H, W) and ``pose`` is
    (V, 6): each video's pose moves its own template.  ``y_offset`` shifts
    the template's row coordinates: a block of rows starting at that row
    of the full template (``parallel/sharded.py``)."""
    fx, fy, cx, cy = intr
    Hh, Ww = kf.image.shape[-2:]
    x, y = camera.pixel_grid(Hh, Ww, device=kf.image.device)
    if y_offset:
        y = y + y_offset
    mask = kf.depth > 0.0

    T = lie.exp_se3(pose)
    P = camera.backproject(x, y, kf.depth, fx, fy, cx, cy)
    # P R^T + t, one (H*W, 3) x (3, 3) product per video
    Pt = (P.reshape(pose.shape[:-1] + (-1, 3))
          @ T[..., :3, :3].transpose(-1, -2)
          + T[..., None, :3, 3]).reshape(P.shape)
    wx, wy, _ = camera.project(Pt, fx, fy, cx, cy, eps=1e-10)

    warped, in_bounds = interp.bilinear(cur.image, wx, wy)
    gradx = interp.bilinear_fill(cur.gradx, wx, wy)
    grady = interp.bilinear_fill(cur.grady, wx, wy)

    u = x - cx
    v = y - cy
    inv_d = 1.0 / torch.where(mask, kf.depth, 1.0)
    residual = torch.where(in_bounds, warped - kf.image, 0.0)

    # variance-propagated weights (PixelWisePyramid.cpp:341-358)
    px, py, pz = Pt[..., 0], Pt[..., 1], Pt[..., 2]
    tx, ty, tz = (T[..., i, 3, None, None] for i in range(3))
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
    weight = torch.where(used, wh * w_p, 0.0)
    return gradx, grady, residual, weight, used, (u, v, inv_d)


def _steepest_descent(gradx, grady, u, v, inv_d, fx, fy) -> torch.Tensor:
    """The six steepest-descent rows at the template pixel (u, v) =
    (x-cx, y-cy), (..., H, W, 6) (PixelWisePyramid.cpp:296-320)."""
    sd0 = gradx * (-(v * u) / fy) + grady * (-(fy + (v * v) / fy))
    sd1 = gradx * (fx + (u * u) / fx) + grady * ((v * u) / fx)
    sd2 = gradx * (-(fx * v) / fy) + grady * ((fy * u) / fx)
    sd3 = gradx * (fx * inv_d)
    sd4 = grady * (fy * inv_d)
    sd5 = gradx * (-u * inv_d) + grady * (-v * inv_d)
    return torch.stack([sd0, sd1, sd2, sd3, sd4, sd5], dim=-1)


def _gn_quantities(kf: KeyframeLevel, cur: CurrentLevel, pose: torch.Tensor,
                   intr: Tuple[float, float, float, float],
                   cfg: ELLCConfig, y_offset: int = 0):
    """One linearization: returns (H 6x6, g 6, energy, valid_count), each
    with the pose's leading axes (one system per video).  ``y_offset``:
    the template holds the rows of the full template from that row on (a
    rank's block of rows, ``parallel/sharded.py``); the current level is
    whole."""
    fx, fy = intr[0], intr[1]
    lead = pose.shape[:-1]
    gradx, grady, residual, weight, used, (u, v, inv_d) = _pixel_terms(
        kf, cur, pose, intr, cfg, y_offset)
    J = _steepest_descent(gradx, grady, u, v, inv_d, fx, fy).reshape(
        lead + (-1, 6))
    weight = weight.reshape(lead + (-1,))
    r = residual.reshape(lead + (-1,))
    # H = J^T w J and g = J^T w r as elementwise products summed over the
    # pixel axis, the last and contiguous one: each video's 42 sums are
    # reduced in an order set by the pixel count alone, so a video of a
    # batch gets the bits it gets alone.  (A (6, N) x (N, 7) product would
    # leave the order to BLAS, whose batched and single kernels round
    # differently on some CPUs.)
    A = (J * weight[..., None]).transpose(-1, -2)          # (..., 6, N)
    Jr = torch.cat([J, r[..., None]], dim=-1).transpose(-1, -2)
    M = torch.sum(A[..., :, None, :] * Jr[..., None, :, :], dim=-1)
    energy = torch.sum(weight * r * r, dim=-1)
    valid = torch.sum(used.to(torch.float32), dim=(-2, -1))
    return M[..., :6], M[..., 6], energy, valid


def weight_image(kf: KeyframeLevel, cur: CurrentLevel, pose: torch.Tensor,
                 level: int, cfg: ELLCConfig) -> torch.Tensor:
    """The per-template-pixel GN weight image at ``pose``: what the
    reference saves at the final iteration of each level for the
    constant-weight rematch (PixelWisePyramid::saveWeights,
    PixelWisePyramid.cpp:544-551)."""
    return _pixel_terms(kf, cur, pose, cfg.level_intrinsics(level), cfg)[3]


def _template_jacobian(kf: KeyframeLevel, level: int, cfg: ELLCConfig
                       ) -> torch.Tensor:
    """Steepest-descent rows from the TEMPLATE (keyframe) gradients and
    depth, zero where the depth is invalid: the inverse-compositional
    precomputation (PixelWisePyramid.cpp:561-680).  ``kf`` fields are
    (..., H, W); returns (..., H, W, 6)."""
    fx, fy, cx, cy = cfg.level_intrinsics(level)
    Hh, Ww = kf.image.shape[-2:]
    x, y = camera.pixel_grid(Hh, Ww, device=kf.image.device)
    mask = kf.depth > 0.0
    gradx, grady = pyramid.gradients(kf.image)
    inv_d = 1.0 / torch.where(mask, kf.depth, 1.0)
    J = _steepest_descent(gradx, grady, x - cx, y - cy, inv_d, fx, fy)
    return torch.where(mask[..., None], J, 0.0)


@functools.lru_cache(maxsize=None)
def _termination_weights(weights: Tuple[float, ...], dtype: torch.dtype,
                         device: torch.device) -> torch.Tensor:
    """``cfg.termination_weights`` as a tensor, made once per dtype and
    device (callers only read it), so that a step captured in a CUDA graph
    copies no host data to the card."""
    return torch.tensor(weights, dtype=dtype, device=device)


def gn_level_const_weight(kf: KeyframeLevel, weights: torch.Tensor,
                          cur: CurrentLevel, pose0: torch.Tensor,
                          level: int, cfg: ELLCConfig, num_iters: int):
    """Inverse-compositional constant-weight GN at one level for B
    candidates at once (PixelWisePyramid.cpp:917-974): J and the 6x6
    Hessian are precomputed from each template with its saved weights;
    each iteration only warps and reduces J^T w r.

    ``kf`` fields and ``weights`` are (B, H, W), ``pose0`` is (B, 6); the
    current level is shared.  The freeze mask is per candidate, so one
    candidate's convergence never stops another, and it stays on the
    device.  Returns (pose (B, 6), weighted_pose (B,), iters (B,))."""
    fx, fy, cx, cy = cfg.level_intrinsics(level)
    B = pose0.shape[0]
    dev, dt = pose0.device, pose0.dtype
    term_w = _termination_weights(cfg.termination_weights, dt, dev)
    J = _template_jacobian(kf, level, cfg).reshape(B, -1, 6)
    w = weights.reshape(B, -1)
    Hmat = (J * w[..., None]).transpose(1, 2) @ J
    Hinv_ok = torch.isfinite(Hmat).all(dim=-1).all(dim=-1)
    Hmat = Hmat + 1e-12 * torch.eye(6, dtype=dt, device=dev)
    Hh, Ww = kf.image.shape[-2:]
    x, y = camera.pixel_grid(Hh, Ww, device=dev)
    mask = kf.depth > 0.0
    P = camera.backproject(x, y, kf.depth, fx, fy, cx, cy).reshape(B, -1, 3)

    pose = pose0
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    wp_last = torch.full((B,), float("inf"), dtype=dt, device=dev)
    iters = torch.zeros(B, dtype=torch.int32, device=dev)
    for _ in range(num_iters):
        T = lie.exp_se3(pose)
        Pt = (P @ T[:, :3, :3].transpose(1, 2)
              + T[:, None, :3, 3]).reshape(B, Hh, Ww, 3)
        wx, wy, _ = camera.project(Pt, fx, fy, cx, cy)
        warped, in_bounds = interp.bilinear(cur.image, wx, wy)
        residual = torch.where(in_bounds & mask, warped - kf.image, 0.0)
        g = (J.transpose(1, 2) @ (residual.reshape(B, -1) * w)[..., None]
             ).squeeze(-1)
        delta = -linear.solve_spd(Hmat, g)
        # zero the update on a singular or near-singular system (OpenCV
        # inv() semantics, PixelWisePyramid.cpp:939)
        ok = (torch.isfinite(delta).all(dim=-1) & Hinv_ok
              & (torch.abs(delta).amax(dim=-1) < 1e3))
        delta = torch.where(ok[:, None], delta, 0.0)
        new_pose = lie.compose(delta, pose)
        wp = torch.sum(torch.abs(delta * term_w), dim=-1)
        pose = torch.where(done[:, None], pose, new_pose)
        wp_last = torch.where(done, wp_last, wp)
        iters = torch.where(done, iters, iters + 1)
        done = done | (wp < 1.0) | ~ok
    return pose, wp_last, iters


def align_const_weight(kf_levels: Tuple[KeyframeLevel, ...],
                       weight_levels: Tuple[torch.Tensor, ...],
                       cur_levels: Tuple[CurrentLevel, ...],
                       pose0: torch.Tensor,
                       cfg: ELLCConfig
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Coarse-to-fine constant-weight alignment of the current frame
    against B keyframe candidates (the loop-closure rematch path of
    GetImagePoseEstimate, ImageFunc.cpp:241-243).  Each keyframe level and
    weight image carries a leading candidate axis B, ``pose0`` is (B, 6)
    and the current levels are shared.  Returns (poses (B, 6),
    weighted_pose (B,))."""
    pose = pose0
    wp = None
    for level in range(cfg.num_levels - 1, -1, -1):
        pose, wp, _ = gn_level_const_weight(
            kf_levels[level], weight_levels[level], cur_levels[level],
            pose, level, cfg, int(cfg.max_iters[level]))
    return pose, wp


def _gn_update(Hmat, g, e, n, pose, done, wp_last, iters, energy, valid,
               term_w):
    """The rest of one GN iteration after its linearization (H, g, energy
    e, used count n): solve, zero a failed step, compose it onto ``pose``,
    and freeze where ``done`` (bool) was set.  Returns the new (pose, done,
    wp_last, iters, energy, valid)."""
    eye = 1e-12 * torch.eye(6, dtype=pose.dtype, device=pose.device)
    delta = -linear.solve_spd(Hmat + eye, g)
    # a singular system gives NaN, a near-singular one an astronomical
    # step; OpenCV's inv() returns zero there (PixelWisePyramid.cpp:451),
    # so the reference applies a zero update.  Reduced over each video's
    # own step only.
    ok = (torch.all(torch.isfinite(delta), dim=-1)
          & (torch.amax(torch.abs(delta), dim=-1) < 1e3))
    delta = torch.where(ok[..., None], delta, 0.0)
    new_pose = lie.compose(delta, pose)
    wp = torch.sum(torch.abs(delta * term_w), dim=-1)
    return (torch.where(done[..., None], pose, new_pose),
            done | (wp < 1.0) | ~ok,
            torch.where(done, wp_last, wp),
            torch.where(done, iters, iters + 1),
            torch.where(done, energy, e),
            torch.where(done, valid, n))


def gn_level(kf: KeyframeLevel, cur: CurrentLevel, pose0: torch.Tensor,
             level: int, cfg: ELLCConfig, num_iters: int):
    """``num_iters`` GN updates at one level with the reference's early-out
    as a freeze mask: every iteration linearizes, and a converged (or
    failed) state keeps its values.  Returns (pose, weighted_pose,
    iters_used, (energy, valid_count)) from the last live linearization.

    ``pose0`` is (6,), or (V, 6) for V videos whose level fields are
    (V, H, W); each video has its own freeze mask, so one video's
    convergence or failed step never stops another.  On a CUDA tensor the
    level runs in K1's kernels (``ops/gn_kernel.py``: one cluster launch
    for a small level, one launch an iteration for a larger one); on the
    CPU it is the plain twin below.  Both count the videos live at the
    start of each iteration into the level's row of
    ``utils/profiling``'s ``k1_live`` table."""
    if pose0.device.type != "cpu":
        # imported here: ops.gn_kernel imports this module
        from egomotion_with_local_loop_closures_tpu_torch.ops import (
            gn_kernel)
        return gn_kernel.gn_level(kf, cur, pose0, level, cfg, num_iters)
    intr = cfg.level_intrinsics(level)
    dev = pose0.device
    lead = pose0.shape[:-1]
    term_w = _termination_weights(cfg.termination_weights, pose0.dtype, dev)
    pose = pose0
    done = torch.zeros(lead, dtype=torch.bool, device=dev)
    wp_last = torch.full(lead, float("inf"), dtype=pose0.dtype, device=dev)
    iters = torch.zeros(lead, dtype=torch.int32, device=dev)
    energy = torch.zeros(lead, dtype=pose0.dtype, device=dev)
    valid = torch.zeros(lead, dtype=pose0.dtype, device=dev)
    live = profiling.k1_live(dev, cfg.num_levels,
                             max(num_iters, *cfg.max_iters))[level]
    for i in range(num_iters):
        live[i].add_(torch.sum(~done))
        Hmat, g, e, n = _gn_quantities(kf, cur, pose, intr, cfg)
        pose, done, wp_last, iters, energy, valid = _gn_update(
            Hmat, g, e, n, pose, done, wp_last, iters, energy, valid, term_w)
    return pose, wp_last, iters, (energy, valid)


def align(kf_levels: Tuple[KeyframeLevel, ...],
          cur_levels: Tuple[CurrentLevel, ...],
          pose0: torch.Tensor,
          cfg: ELLCConfig,
          max_iters: Tuple[int, ...] | None = None
          ) -> Tuple[torch.Tensor, AlignDiagnostics]:
    """Coarse-to-fine alignment of the current frame against the keyframe
    (GetImagePoseEstimate, ImageFunc.cpp:150-299).  ``pose0`` is the
    initial guess of the current frame w.r.t. the keyframe, (6,), or (V, 6)
    for V videos whose levels are (V, H, W).  Diagnostics come from the
    finest level's last live linearization, one per video."""
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
        iters_used=torch.stack(iters_used[::-1], dim=-1),
        final_energy=energy,
        valid_fraction=valid / math.prod(kf_levels[0].image.shape[-2:]),
        oow_fraction=torch.zeros_like(energy),
    )
    return pose, diag
