"""Keyframe depth propagation, hole filling, and regularization.

Port of ``egomotion_with_local_loop_closures_tpu/depth/propagate.py``
(``src/DepthPropagation.cpp``):

- :func:`propagate` -- ``propagateDepth`` (:1003-1157), with the JAX
  package's merge: per target cell the nearest (largest inverse depth)
  candidate wins, and every candidate compatible with it is fused by
  inverse variance (``ops/propagate_kernel.py``).
- :func:`fill_holes` -- ``fillDepthHoles`` (:1317-1432), with the
  reference's row-prefix validity score.
- :func:`regularize` -- ``regularizeDepthMap`` (:1436-1543).
- :func:`do_regularization` -- both, in that order (:1627-1635).

``fill_holes``, ``regularize`` and ``do_regularization`` here are the
plain PyTorch version of the CUDA kernel in ``ops/reg_kernel.py``: the
pipeline calls the kernel's wrappers, which use these functions only for
tensors on the CPU.  The per-tap expressions below are the ones the
kernel evaluates, in the same order (dy outer, dx inner, -2..2).

Every function here also takes a batch of states, planes (B, H, W): the
connection-recovery trials, one per loop-window candidate, or the videos
of the batched pipeline.  The shifts
move only the last two dimensions, and :func:`propagate` merges each
candidate into its own B-th of one flat (B*H*W) target space, so a batch
gives each candidate what it would give alone.

The merge sums each cell's compatible candidates in ascending source
index, on the CPU (the plain twin) and on the card (the kernels of
``ops/propagate_kernel.py``) alike, so :func:`propagate` gives the same
bits on both and from run to run.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

from egomotion_with_local_loop_closures_tpu_torch.config import ELLCConfig
from egomotion_with_local_loop_closures_tpu_torch.depth.state import (
    DepthMapState)
from egomotion_with_local_loop_closures_tpu_torch.geom import camera, lie
from egomotion_with_local_loop_closures_tpu_torch.image import interp
from egomotion_with_local_loop_closures_tpu_torch.ops import propagate_kernel


def propagate(state: DepthMapState,
              old_kf_image: torch.Tensor,
              new_kf_image: torch.Tensor,
              new_kf_maxgrad: torch.Tensor,
              pose_new_wrt_old: torch.Tensor,
              cfg: ELLCConfig) -> DepthMapState:
    """Propagate hypotheses from the old KF into the new KF's pixel grid;
    ``pose_new_wrt_old``: P_new = exp(xi) P_old (DepthPropagation.cpp:1020).

    For B states at once, ``state`` and ``old_kf_image`` are (B, H, W)
    and ``pose_new_wrt_old`` is (B, 6).  The new keyframe
    (``new_kf_image``, ``new_kf_maxgrad``) is either shared, (H, W), as
    for connection recovery's candidates, or one per state, (B, H, W), as
    for the videos of the batched pipeline.

    :func:`candidates` reprojects and gates; the merge is
    ``ops/propagate_kernel.py::merge``: its CUDA kernels for CUDA
    tensors, its plain twin for CPU tensors."""
    return propagate_kernel.merge(
        *candidates(state, old_kf_image, new_kf_image, new_kf_maxgrad,
                    pose_new_wrt_old, cfg), state.idepth.shape, cfg)


def candidates(state: DepthMapState, old_kf_image: torch.Tensor,
               new_kf_image: torch.Tensor, new_kf_maxgrad: torch.Tensor,
               pose_new_wrt_old: torch.Tensor, cfg: ELLCConfig
               ) -> Tuple[torch.Tensor, ...]:
    """The front half of :func:`propagate` (DepthPropagation.cpp:1040-1086):
    every source pixel's flat target cell (int64, candidate b's cells from
    b*H*W on), whether it is a candidate (valid, in the image, passing the
    photometric and gradient gates), its inverse depth and inflated
    variance in the new keyframe, and its validity; each flat (N,)."""
    H, W = old_kf_image.shape[-2:]
    lead = old_kf_image.shape[:-2]
    dev = old_kf_image.device
    fx, fy, cx, cy = cfg.fx, cfg.fy, cfg.cx, cfg.cy
    T = lie.exp_se3(pose_new_wrt_old)          # new <- old
    # each candidate's rotation and translation, (..., 1, 1) against the
    # (H, W) grid
    R, t = T[..., :3, :3, None, None], T[..., :3, 3, None, None]
    R = [[R[..., i, j, :, :] for j in range(3)] for i in range(3)]
    t = [t[..., i, :, :] for i in range(3)]

    x, y = camera.pixel_grid(H, W, device=dev)
    src_valid = state.valid
    ids = torch.where(torch.abs(state.idepth_smoothed) > 1e-12,
                      state.idepth_smoothed, 1e-12)
    # pn = R * Kinv p / idepth_smoothed + t   (:1047)
    rx = (x - cx) / fx
    ry = (y - cy) / fy
    px = (R[0][0] * rx + R[0][1] * ry + R[0][2]) / ids + t[0]
    py = (R[1][0] * rx + R[1][1] * ry + R[1][2]) / ids + t[1]
    pz = (R[2][0] * rx + R[2][1] * ry + R[2][2]) / ids + t[2]
    pz_safe = torch.where(torch.abs(pz) > 1e-12, pz, 1e-12)
    new_idepth = 1.0 / pz_safe
    u = px * new_idepth * fx + cx
    v = py * new_idepth * fy + cy

    in_img = (u > 2.1) & (v > 2.1) & (u < W - 3.1) & (v < H - 3.1)  # (:1059)
    # truncating casts, clipped after the cast; the float clamp before it
    # only keeps huge or NaN values defined (cand masks them anyway)
    tx = torch.clamp(u + 0.5, -1.0, float(W)).to(torch.int32).clamp(0, W - 1)
    ty = torch.clamp(v + 0.5, -1.0, float(H)).to(torch.int32).clamp(0, H - 1)
    # candidate b's targets are b*H*W onwards
    first = (torch.arange(math.prod(lead), device=dev, dtype=torch.int64)
             .reshape(lead + (1, 1)) * (H * W))
    tgt = (first + ty * W + tx).reshape(-1)

    # photometric consistency; the reference samples the new KF's
    # max-gradient at the SOURCE pixel (DepthPropagation.cpp:1066)
    dest_grad = new_kf_maxgrad
    dest_color = interp.bilinear_fill(new_kf_image, u, v)
    residual = dest_color - old_kf_image
    photo_ok = (residual * residual /
                (cfg.max_diff_constant
                 + cfg.max_diff_grad_mult * dest_grad * dest_grad) <= 1.0)
    grad_ok = dest_grad >= cfg.min_abs_grad_decrease
    cand = src_valid & in_img & photo_ok & grad_ok

    # variance inflation idepth_ratio^4 times source invDepth (:1082-1086)
    ratio = new_idepth / ids
    ratio4 = (ratio * ratio) * (ratio * ratio)
    new_var = ratio4 * state.idepth
    return (tgt, cand.reshape(-1), new_idepth.reshape(-1),
            new_var.reshape(-1), state.validity.reshape(-1))


def _shift(a: torch.Tensor, dy: int, dx: int, fill=0.0) -> torch.Tensor:
    """a shifted so that out[..., y, x] = a[..., y+dy, x+dx], ``fill``
    outside."""
    H, W = a.shape[-2:]
    out = torch.full_like(a, fill)
    y0, y1 = max(0, -dy), H - max(0, dy)
    x0, x1 = max(0, -dx), W - max(0, dx)
    out[..., y0:y1, x0:x1] = a[..., y0 + dy:y1 + dy, x0 + dx:x1 + dx]
    return out


def _region_mask(H: int, W: int, y0: int, y1: int, x0: int, x1: int,
                 device) -> torch.Tensor:
    m = torch.zeros((H, W), dtype=torch.bool, device=device)
    m[y0:y1, x0:x1].fill_(True)
    return m


def fill_holes(state: DepthMapState, kf_maxgrad: torch.Tensor,
               cfg: ELLCConfig) -> DepthMapState:
    """Create hypotheses in high-validity holes (fillDepthHoles,
    DepthPropagation.cpp:1317-1432).  A fill whose 5x5 window holds no
    valid neighbour is skipped instead of writing NaN (the JAX package's
    documented deviation from :1379)."""
    z = torch.zeros_like(state.var)
    acc = (z, z, z)
    sv = state.valid.to(torch.float32)
    for dy in range(-2, 3):
        for dx in range(-2, 3):
            acc = fill_tap(_shift(sv, dy, dx),
                           _shift(state.var, dy, dx, fill=1.0),
                           _shift(state.idepth, dy, dx), acc)
    return fill_finish(state, fill_val(state, cfg), acc, kf_maxgrad, cfg)


def fill_val(state: DepthMapState, cfg: ELLCConfig) -> torch.Tensor:
    """The validity score of fillDepthHoles.  The reference's prefix buffer
    is reset every row (:1414-1429), so the score is
    rowsum(y+2, x-2..x+2) - rowsum(y-3, x-2..x+2), not a 5x5 box sum;
    ``cfg.lsd_correct_hole_fill`` restores LSD-SLAM's box sum."""
    v_row = torch.where(state.valid, state.validity, 0.0)
    win5 = sum(_shift(v_row, 0, dx) for dx in range(-2, 3))
    if cfg.lsd_correct_hole_fill:
        return sum(_shift(win5, dy, 0) for dy in range(-2, 3))
    return _shift(win5, 2, 0) - _shift(win5, -3, 0)


def fill_tap(sv, svar, sid, acc):
    """One 5x5 tap of the inverse-variance mean (:1361-1377)."""
    sum_iv, sum_id, num = acc
    iv = torch.where(sv > 0, 1.0 / torch.where(torch.abs(svar) > 1e-12,
                                               svar, 1e-12), 0.0)
    return (sum_iv + iv, sum_id + iv * sid, num + sv)


def fill_finish(state: DepthMapState, val, acc, kf_maxgrad,
                cfg: ELLCConfig) -> DepthMapState:
    """Gate + write-back of fillDepthHoles (:1340-1359, :1379-1393), over
    rows 3..H-4 and columns 3..W-3."""
    H, W = state.valid.shape[-2:]
    sum_iv, sum_id, num = acc
    region = _region_mask(H, W, 3, H - 3, 3, W - 2, state.valid.device)
    cond = (region & ~state.valid
            & (kf_maxgrad >= cfg.min_abs_grad_decrease)
            & (((state.blacklisted >= cfg.min_blacklist)
                & (val > cfg.val_sum_min_for_create))
               | (val > cfg.val_sum_min_for_unblacklist))
            & (num > 0))
    fill_id = sum_id / torch.where(sum_iv > 0, sum_iv, 1.0)
    fill_id = torch.where(torch.abs(fill_id) < 1e-10,
                          torch.where(fill_id < 0, -1e-10, 1e-10), fill_id)
    return DepthMapState(
        idepth=torch.where(cond, fill_id, state.idepth),
        var=torch.where(cond, cfg.var_random_init, state.var),
        idepth_smoothed=torch.where(cond, -1.0, state.idepth_smoothed),
        var_smoothed=torch.where(cond, -1.0, state.var_smoothed),
        validity=torch.where(cond, 0.0, state.validity),
        blacklisted=torch.where(cond, 0, state.blacklisted),
        valid=state.valid | cond)


def regularize(state: DepthMapState, cfg: ELLCConfig,
               remove_occlusions: bool = False) -> DepthMapState:
    """5x5 inverse-variance smoothing (regularizeDepthMap,
    DepthPropagation.cpp:1436-1543)."""
    z = torch.zeros_like(state.var)
    acc = (z, z, z, z, z)
    sv = state.valid.to(torch.float32)
    for dy in range(-2, 3):
        for dx in range(-2, 3):
            acc = reg_tap(state,
                          _shift(sv, dy, dx),
                          _shift(state.idepth, dy, dx),
                          _shift(state.var, dy, dx, fill=1.0),
                          _shift(state.validity, dy, dx),
                          float(dy * dy + dx * dx), acc, cfg)
    return reg_finish(state, acc, cfg, remove_occlusions)


def reg_tap(state: DepthMapState, svf, sid, svar, svalc, dist2: float, acc,
            cfg: ELLCConfig):
    """One 5x5 tap of regularizeDepthMap's smoothing (:1460-1500);
    ``dist2`` is dy^2 + dx^2."""
    sum_w, sum_id, val_sum, n_occ, n_not = acc
    sv = svf > 0
    diff = sid - state.idepth
    compat = cfg.diff_fac_smoothing * diff * diff <= svar + state.var
    use = sv & compat
    n_occ = n_occ + torch.where(sv & ~compat & (sid > state.idepth), 1.0, 0.0)
    n_not = n_not + torch.where(use, 1.0, 0.0)
    # the float32 product dist2 * reg_dist_var, as the kernel computes it
    dist_fac = float(np.float32(dist2) * np.float32(cfg.reg_dist_var))
    iv = torch.where(use, 1.0 / (torch.clamp_min(svar, 0.0) + dist_fac), 0.0)
    return (sum_w + iv, sum_id + iv * sid,
            val_sum + torch.where(use, svalc, 0.0), n_occ, n_not)


def reg_finish(state: DepthMapState, acc, cfg: ELLCConfig,
               remove_occlusions: bool) -> DepthMapState:
    """Drop gates + smoothed write-back of regularizeDepthMap (:1502-1543),
    over rows 3..H-4 and columns 2..W-3."""
    H, W = state.valid.shape[-2:]
    sum_w, sum_id, val_sum, n_occ, n_not = acc
    region = _region_mask(H, W, 3, H - 3, 2, W - 2, state.valid.device)
    touched = region & state.valid
    drop_val = touched & (val_sum < cfg.val_sum_min_for_keep)
    dropped = drop_val
    if remove_occlusions:
        dropped = dropped | (touched & (n_occ > n_not))
    smooth = sum_id / torch.where(sum_w > 0, sum_w, 1.0)
    smooth = torch.where(torch.abs(smooth) < 1e-10,
                         torch.where(smooth < 0, -1e-10, 1e-10), smooth)
    write = touched & ~dropped
    return DepthMapState(
        idepth=state.idepth,
        var=state.var,
        idepth_smoothed=torch.where(write, smooth, state.idepth_smoothed),
        var_smoothed=torch.where(
            write, 1.0 / torch.where(sum_w > 0, sum_w, 1.0),
            state.var_smoothed),
        validity=state.validity,
        blacklisted=torch.where(drop_val, state.blacklisted - 1,
                                state.blacklisted),
        valid=state.valid & ~dropped)


def do_regularization(state: DepthMapState, kf_maxgrad: torch.Tensor,
                      cfg: ELLCConfig,
                      remove_occlusions: bool = False) -> DepthMapState:
    """fillDepthHoles + regularizeDepthMap (doRegularization,
    DepthPropagation.cpp:1627-1635): the plain version of the fused CUDA
    kernel ``ops/reg_kernel.py::do_regularization``."""
    state = fill_holes(state, kf_maxgrad, cfg)
    return regularize(state, cfg, remove_occlusions)
