"""Epipolar line-stereo depth observation, dense over the pixel grid.

Port of the dense path of
``egomotion_with_local_loop_closures_tpu/depth/stereo.py``
(``depthMap::observeDepthRow`` / ``observeDepthCreate`` /
``observeDepthUpdate`` / ``makeAndCheckEPL`` / ``doLineStereo``,
``src/DepthPropagation.cpp:191-999``): every pixel walks a fixed
``stereo_max_steps``-step scan along its epipolar segment (steps past the
segment end masked off), with 5-tap SSD, masked argmin (ties go to the
first step), parabola subpixel refinement and the LSD-SLAM variance model,
then the EKF create/update rules as dense selects.

The TPU layouts have no counterpart: the walk is dense (no capacity
pools) and samples the float current image exactly (on integer-valued
frames the JAX package's u16 packing is exact, so the two agree).  The
walk is plain PyTorch here; it is the second kernel to write by hand (K2).

Error codes (DepthPropagation.cpp:395-396): 0 success, -1 out of bounds,
-2 not found / ambiguous / negative depth, -3 error too big, -4 invalid
epipolar geometry.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from egomotion_with_local_loop_closures_tpu_torch.config import ELLCConfig
from egomotion_with_local_loop_closures_tpu_torch.depth.state import (
    DepthMapState)
from egomotion_with_local_loop_closures_tpu_torch.geom import camera, lie
from egomotion_with_local_loop_closures_tpu_torch.image import interp


class StereoResult(NamedTuple):
    code: torch.Tensor       # int32 error code (0 = success)
    idepth: torch.Tensor     # triangulated inverse depth (KF frame)
    var: torch.Tensor        # observation variance
    err: torch.Tensor        # best SSD error


def _set_code(code: torch.Tensor, cond: torch.Tensor, val: int
              ) -> torch.Tensor:
    """First failure wins: only overwrite where still 0."""
    return torch.where((code == 0) & cond, val, code)


def epl_direction(kf_image: torch.Tensor, t_kf_from_cur: torch.Tensor,
                  cfg: ELLCConfig
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Normalized epipolar direction per KF pixel + pass mask
    (makeAndCheckEPL, DepthPropagation.cpp:311-384), with the raw +-1
    gradient (no 0.5 factor, :347-348)."""
    H, W = kf_image.shape
    x, y = camera.pixel_grid(H, W, device=kf_image.device)
    epx = -cfg.fx * t_kf_from_cur[0] + t_kf_from_cur[2] * (x - cfg.cx)
    epy = -cfg.fy * t_kf_from_cur[1] + t_kf_from_cur[2] * (y - cfg.cy)
    ok = ~torch.isnan(epx + epy)
    len2 = epx * epx + epy * epy
    ok = ok & (len2 >= cfg.min_epl_length_squared)
    gx = torch.zeros_like(kf_image)
    gx[:, 1:-1] = kf_image[:, 2:] - kf_image[:, :-2]
    gy = torch.zeros_like(kf_image)
    gy[1:-1, :] = kf_image[2:, :] - kf_image[:-2, :]
    dot = gx * epx + gy * epy
    grad2 = dot * dot / torch.where(len2 > 0, len2, 1.0)
    ok = ok & (grad2 >= cfg.min_epl_grad_squared)
    g2 = gx * gx + gy * gy
    ok = ok & (grad2 / torch.where(g2 > 0, g2, 1e-12)
               >= cfg.min_epl_angle_squared)
    fac = cfg.gradient_sample_dist / torch.sqrt(torch.where(len2 > 0, len2,
                                                            1.0))
    return epx * fac, epy * fac, ok


def _pose_blocks(pose_cur_wrt_kf: torch.Tensor, cfg: ELLCConfig):
    T = lie.exp_se3(pose_cur_wrt_kf)
    R, t = T[:3, :3], T[:3, 3]                    # cur <- kf
    K = camera.intrinsics_matrix(cfg.fx, cfg.fy, cfg.cx, cfg.cy,
                                 device=T.device)
    return R, t, K @ R, K @ t


def _pinf_rescale(x, y, prior_idepth, KR, Kt, cfg):
    """The infinity point of each pixel's ray in the current image and the
    reference's 'rescale' (doLineStereo :401-405)."""
    kx = (x - cfg.cx) / cfg.fx
    ky = (y - cfg.cy) / cfg.fy
    pinf = torch.stack([KR[0, 0] * kx + KR[0, 1] * ky + KR[0, 2],
                        KR[1, 0] * kx + KR[1, 1] * ky + KR[1, 2],
                        KR[2, 0] * kx + KR[2, 1] * ky + KR[2, 2]], dim=0)
    prior_safe = torch.where(torch.abs(prior_idepth) > 1e-12, prior_idepth,
                             1e-12)
    preal_z = pinf[2] / prior_safe + Kt[2]
    rescale = preal_z * prior_idepth              # (:405)
    return kx, ky, pinf, rescale


class SegmentSetup(NamedTuple):
    """Per-pixel epipolar segment endpoints, step increment and pre-check
    error code (DepthPropagation.cpp:397-553)."""
    code: torch.Tensor
    pfar_x: torch.Tensor
    pfar_y: torch.Tensor
    incx: torch.Tensor
    incy: torch.Tensor
    pclose_x: torch.Tensor
    pclose_y: torch.Tensor
    rescale: torch.Tensor


def _segment_setup(x, y, epxn, epyn, min_idepth, prior_idepth, max_idepth,
                   pose_cur_wrt_kf, H: int, W: int,
                   cfg: ELLCConfig) -> SegmentSetup:
    """Segment construction + pre-checks of doLineStereo (:397-553)."""
    P = x.shape
    _, _, KR, Kt = _pose_blocks(pose_cur_wrt_kf, cfg)
    code = torch.zeros(P, dtype=torch.int32, device=x.device)

    kx, ky, pinf, rescale = _pinf_rescale(x, y, prior_idepth, KR, Kt, cfg)

    first_x = x - 2.0 * epxn * rescale
    first_y = y - 2.0 * epyn * rescale
    last_x = x + 2.0 * epxn * rescale
    last_y = y + 2.0 * epyn * rescale
    oob = ((first_x <= 0) | (first_x >= W - 2) | (first_y <= 0)
           | (first_y >= H - 2) | (last_x <= 0) | (last_x >= W - 2)
           | (last_y <= 0) | (last_y >= H - 2))
    code = _set_code(code, oob, -1)               # (:414-421)
    code = _set_code(code, ~((rescale > 0.7) & (rescale < 1.4)), -1)  # (:424)

    # close / far endpoints in the current image (:438-458)
    kt = Kt.reshape((3,) + (1,) * len(P))
    pclose = pinf + kt * max_idepth
    fix = pclose[2] < 0.001
    max_id2 = torch.where(fix, (0.001 - pinf[2]) / torch.where(
        torch.abs(Kt[2]) > 1e-12, Kt[2], 1e-12), max_idepth)
    pclose = pinf + kt * max_id2
    pclose_z = torch.where(torch.abs(pclose[2]) > 1e-12, pclose[2], 1e-12)
    pclose = pclose / pclose_z

    pfar = pinf + kt * min_idepth
    code = _set_code(code, (pfar[2] < 0.001) | (max_id2 < min_idepth), -1)
    pfar_z = torch.where(torch.abs(pfar[2]) > 1e-12, pfar[2], 1e-12)
    pfar = pfar / pfar_z

    code = _set_code(code, torch.isnan(pfar[0] + pclose[0]), -4)   # (:462)

    incx = pclose[0] - pfar[0]
    incy = pclose[1] - pfar[1]
    epl_len = torch.sqrt(incx * incx + incy * incy)
    code = _set_code(code, ~(epl_len > 0) | torch.isinf(epl_len), -4)  # (:472)

    # crop to MAX_EPL_LENGTH_CROP (:479-483)
    crop = epl_len > cfg.max_epl_length_crop
    safe_len = torch.where(epl_len > 0, epl_len, 1.0)
    pclose_x = torch.where(
        crop, pfar[0] + incx * cfg.max_epl_length_crop / safe_len, pclose[0])
    pclose_y = torch.where(
        crop, pfar[1] + incy * cfg.max_epl_length_crop / safe_len, pclose[1])
    incx = incx * cfg.gradient_sample_dist / safe_len
    incy = incy * cfg.gradient_sample_dist / safe_len

    pfar_x = pfar[0] - incx
    pfar_y = pfar[1] - incy
    pclose_x = pclose_x + incx
    pclose_y = pclose_y + incy

    # pad to MIN_EPL_LENGTH_CROP (:497-505)
    pad = torch.where(epl_len < cfg.min_epl_length_crop,
                      (cfg.min_epl_length_crop - epl_len) / 2.0, 0.0)
    pfar_x = pfar_x - incx * pad
    pfar_y = pfar_y - incy * pad
    pclose_x = pclose_x + incx * pad
    pclose_y = pclose_y + incy * pad

    # far point outside image -> skip (:508-516)
    b = cfg.sample_point_to_border
    code = _set_code(code, (pfar_x <= b) | (pfar_x >= W - b)
                     | (pfar_y <= b) | (pfar_y >= H - b), -1)

    # near point outside -> clamp along the line: x-low / x-high, then
    # y-low / y-high on the updated values (:519-549)
    lo_x = pclose_x <= b
    hi_x = pclose_x >= W - b
    inc_safe_x = torch.where(torch.abs(incx) > 1e-12, incx, 1e-12)
    add_x = torch.where(lo_x, (b - pclose_x) / inc_safe_x,
                        torch.where(hi_x, (W - b - pclose_x) / inc_safe_x,
                                    0.0))
    pclose_x = pclose_x + add_x * incx
    pclose_y = pclose_y + add_x * incy
    lo_y = pclose_y <= b
    hi_y = pclose_y >= H - b
    inc_safe_y = torch.where(torch.abs(incy) > 1e-12, incy, 1e-12)
    add_y = torch.where(lo_y, (b - pclose_y) / inc_safe_y,
                        torch.where(hi_y, (H - b - pclose_y) / inc_safe_y,
                                    0.0))
    pclose_x = pclose_x + add_y * incx
    pclose_y = pclose_y + add_y * incy
    fincx = pclose_x - pfar_x
    fincy = pclose_y - pfar_y
    new_len = torch.sqrt(fincx * fincx + fincy * fincy)
    still_out = ((pclose_x <= b) | (pclose_x >= W - b)
                 | (pclose_y <= b) | (pclose_y >= H - b))
    clamped = lo_x | hi_x | lo_y | hi_y
    code = _set_code(code, clamped & (still_out | (new_len < 8.0)), -1)

    return SegmentSetup(code=code, pfar_x=pfar_x, pfar_y=pfar_y,
                        incx=incx, incy=incy,
                        pclose_x=pclose_x, pclose_y=pclose_y,
                        rescale=rescale)


def _step_cond(seg: SegmentSetup, S: int) -> torch.Tensor:
    """The walk's continuation test (DepthPropagation.cpp:628) for steps
    0..S-1, shape (S,) + P; step 0 always runs."""
    P = seg.pfar_x.shape
    ks = torch.arange(S, dtype=seg.pfar_x.dtype, device=seg.pfar_x.device
                      ).reshape((S,) + (1,) * len(P))
    posx = seg.pfar_x[None] + ks * seg.incx[None]
    posy = seg.pfar_y[None] + ks * seg.incy[None]
    cond = (((seg.incx[None] < 0) == (posx > seg.pclose_x[None]))
            & ((seg.incy[None] < 0) == (posy > seg.pclose_y[None])))
    cond[0] = True
    return cond


def _take(a: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """a[k[p], p] for a of shape (S,) + P and k of shape P."""
    return torch.gather(a, 0, k[None].long())[0]


def _walk(x, y, real, epxn, epyn, gix, giy, seg: SegmentSetup,
          cur_image, pose_cur_wrt_kf, S: int, H: int, W: int,
          cfg: ELLCConfig) -> StereoResult:
    """The sampling walk + subpixel + triangulation + variance model of
    doLineStereo (DepthPropagation.cpp:611-885) over ``S`` steps; ``real``
    is the 5-tap KF descriptor of shape (5,) + P."""
    fx, fy, cx, cy = cfg.fx, cfg.fy, cfg.cx, cfg.cy
    eps = cfg.division_eps
    P = x.shape
    dev = x.device
    R, t, _, _ = _pose_blocks(pose_cur_wrt_kf, cfg)
    kx = (x - cx) / fx
    ky = (y - cy) / fy
    code = seg.code
    pfar_x, pfar_y = seg.pfar_x, seg.pfar_y
    incx, incy = seg.incx, seg.incy
    rescale = seg.rescale

    # ---- fixed-trip epipolar walk (:611-710) ----
    # samples of the current image at pFar + o*inc for o in [-2, S+1]
    offs = torch.arange(-2, S + 2, dtype=x.dtype, device=dev).reshape(
        (S + 4,) + (1,) * len(P))
    sx = pfar_x[None] + offs * incx[None]
    sy = pfar_y[None] + offs * incy[None]
    bad = code != 0
    sx = torch.where(bad[None], 0.0, sx)
    sy = torch.where(bad[None], 0.0, sy)
    samples = interp.bilinear_fill(cur_image, sx, sy)

    # e_j(k) = samples[k+2+j] - real[2+j], j in -2..2; ee = sum_j e_j^2
    e = [samples[j:j + S] - real[j][None] for j in range(5)]
    ee = e[0] * e[0]
    for j in range(1, 5):
        ee = ee + e[j] * e[j]
    # ecorr[k] = sum_j e_j(k) e_j(k-1), NaN at k = 0 (:670, 684)
    ecorr = e[0][1:] * e[0][:-1]
    for j in range(1, 5):
        ecorr = ecorr + e[j][1:] * e[j][:-1]
    ecorr = torch.cat([torch.full((1,) + P, float("nan"), device=dev),
                       ecorr], dim=0)

    step_valid = torch.cumprod(_step_cond(seg, S).to(torch.int32),
                               dim=0).bool()
    ee_masked = torch.where(step_valid, ee, float("inf"))
    kbest = torch.argmin(ee_masked, dim=0)
    best = _take(ee_masked, kbest)
    karange = torch.arange(S, device=dev).reshape((S,) + (1,) * len(P))
    ee2 = torch.where(karange == kbest[None], float("inf"), ee_masked)
    ksecond = torch.argmin(ee2, dim=0)
    second = _take(ee2, ksecond)

    num_steps = torch.sum(step_valid, dim=0)
    err_pre = torch.where(kbest >= 1, _take(ee, torch.clamp_min(kbest - 1, 0)),
                          -1.0)
    has_post = (kbest + 1) < num_steps
    err_post = torch.where(has_post,
                           _take(ee, torch.clamp_max(kbest + 1, S - 1)), -1.0)
    diff_pre = _take(ecorr, kbest)
    diff_post = _take(ecorr, torch.clamp_max(kbest + 1, S - 1))

    code = _set_code(code, best > 4.0 * cfg.max_error_stereo, -3)   # (:713)
    ambiguous = ((torch.abs(kbest - ksecond) > 1)
                 & (cfg.min_distance_error_stereo * best > second))
    code = _set_code(code, ambiguous, -2)                           # (:721)

    # ---- subpixel refinement (:727-803) ----
    grad_pre_pre = -(err_pre - diff_pre)
    grad_pre_this = best - diff_pre
    grad_post_this = -(best - diff_post)
    grad_post_post = err_post - diff_post
    has_both = (err_pre >= 0) & (err_post >= 0)
    zc_pre = (grad_pre_pre < 0) ^ (grad_pre_this < 0)
    zc_post = (grad_post_post < 0) ^ (grad_post_this < 0)
    interp_pre = has_both & zc_pre & ~zc_post
    interp_post = has_both & ~zc_pre & zc_post
    d_pre = grad_pre_this / torch.where(
        torch.abs(grad_pre_this - grad_pre_pre) > 1e-12,
        grad_pre_this - grad_pre_pre, 1e-12)
    d_post = grad_post_this / torch.where(
        torch.abs(grad_post_this - grad_post_post) > 1e-12,
        grad_post_this - grad_post_post, 1e-12)
    kf = kbest.to(x.dtype)
    best_x = pfar_x + kf * incx
    best_y = pfar_y + kf * incy
    best_x = torch.where(interp_pre, best_x - d_pre * incx,
                         torch.where(interp_post, best_x + d_post * incx,
                                     best_x))
    best_y = torch.where(interp_pre, best_y - d_pre * incy,
                         torch.where(interp_post, best_y + d_post * incy,
                                     best_y))
    best = torch.where(
        interp_pre,
        best - 2.0 * d_pre * grad_pre_this
        - (grad_pre_pre - grad_pre_this) * d_pre * d_pre,
        torch.where(
            interp_post,
            best + 2.0 * d_post * grad_post_this
            + (grad_post_post - grad_post_this) * d_post * d_post,
            best))
    did_subpixel = interp_pre | interp_post

    # ---- gradient along line + final error check (:806-821) ----
    sample_dist = cfg.gradient_sample_dist * rescale
    g_along = ((real[4] - real[3]) ** 2 + (real[3] - real[2]) ** 2
               + (real[2] - real[1]) ** 2 + (real[1] - real[0]) ** 2)
    g_along = g_along / torch.where(torch.abs(sample_dist) > 1e-12,
                                    sample_dist * sample_dist, 1e-12)
    code = _set_code(
        code, best > cfg.max_error_stereo + torch.sqrt(
            torch.clamp_min(g_along, 0.0)) * 20.0, -3)

    # ---- triangulation (:824-853) ----
    dot0 = R[0, 0] * kx + R[0, 1] * ky + R[0, 2]
    dot1 = R[1, 0] * kx + R[1, 1] * ky + R[1, 2]
    dot2 = R[2, 0] * kx + R[2, 1] * ky + R[2, 2]
    use_x = incx * incx > incy * incy
    old_x = best_x / fx - cx / fx
    old_y = best_y / fy - cy / fy
    nom_x = old_x * t[2] - t[0]
    nom_y = old_y * t[2] - t[1]
    nom = torch.where(use_x, nom_x, nom_y)
    nom_safe = torch.where(torch.abs(nom) > 1e-12, nom, 1e-12)
    idepth_x = (dot0 - old_x * dot2) / nom_safe
    idepth_y = (dot1 - old_y * dot2) / nom_safe
    idepth = torch.where(use_x, idepth_x, idepth_y)
    # the reference uses ORIG_FX_INV in BOTH branches (:839 and :851);
    # kept as-is
    alpha_x = incx * (1.0 / fx) * (dot0 * t[2] - dot2 * t[0]) / (
        nom_safe * nom_safe)
    alpha_y = incy * (1.0 / fx) * (dot1 * t[2] - dot2 * t[1]) / (
        nom_safe * nom_safe)
    alpha = torch.where(use_x, alpha_x, alpha_y)
    code = _set_code(code, idepth < 0, -2)                          # (:856)

    # ---- variance model (:861-878) ----
    photo = 4.0 * cfg.camera_pixel_noise / (g_along + eps)
    track_fac = 0.25
    geo_den = gix * epxn + giy * epyn + eps
    geo = track_fac * track_fac * (gix * gix + giy * giy) / (
        geo_den * geo_den)
    disc = torch.where(did_subpixel, 0.05, 0.5) * sample_dist * sample_dist
    var = alpha * alpha * (disc + geo + photo)

    return StereoResult(code=code, idepth=idepth, var=var, err=best)


def _kf_descriptor(kf_image: torch.Tensor, epxn, epyn, rescale,
                   H: int, W: int) -> torch.Tensor:
    """5-tap descriptor from the KF image (:432-436), sampled exactly
    (the JAX package's D=4 window sampler gives the same values wherever
    the taps stay inside its window, which the rescale gate guarantees)."""
    x, y = camera.pixel_grid(H, W, device=kf_image.device)

    def kf_sample(j):
        return interp.bilinear_fill(kf_image, x + j * epxn * rescale,
                                    y + j * epyn * rescale)
    return torch.stack([kf_sample(-2.0), kf_sample(-1.0), kf_image,
                        kf_sample(1.0), kf_sample(2.0)], dim=0)


def line_stereo(kf_image: torch.Tensor,
                kf_gradx: torch.Tensor, kf_grady: torch.Tensor,
                cur_image: torch.Tensor,
                epxn: torch.Tensor, epyn: torch.Tensor,
                min_idepth: torch.Tensor, prior_idepth: torch.Tensor,
                max_idepth: torch.Tensor,
                pose_cur_wrt_kf: torch.Tensor,
                cfg: ELLCConfig) -> StereoResult:
    """Dense doLineStereo (DepthPropagation.cpp:397-885) for every pixel;
    gating is the caller's job, failures are reported via ``code``."""
    H, W = kf_image.shape
    x, y = camera.pixel_grid(H, W, device=kf_image.device)
    seg = _segment_setup(x, y, epxn, epyn, min_idepth, prior_idepth,
                         max_idepth, pose_cur_wrt_kf, H, W, cfg)
    real = _kf_descriptor(kf_image, epxn, epyn, seg.rescale, H, W)
    return _walk(x, y, real, epxn, epyn, kf_gradx, kf_grady, seg,
                 cur_image, pose_cur_wrt_kf, cfg.stereo_max_steps,
                 H, W, cfg)


class ObserveResult(NamedTuple):
    state: DepthMapState
    num_created: torch.Tensor
    num_updated: torch.Tensor


def observe(state: DepthMapState,
            kf_image: torch.Tensor, kf_gradx: torch.Tensor,
            kf_grady: torch.Tensor, kf_maxgrad: torch.Tensor,
            cur_image: torch.Tensor,
            pose_cur_wrt_kf: torch.Tensor,
            cfg: ELLCConfig) -> ObserveResult:
    """One depth-refinement pass of the current frame against the keyframe
    (observeDepthRow + create/update, DepthPropagation.cpp:191-999)."""
    H, W = kf_image.shape
    dev = kf_image.device
    b = cfg.border
    x, y = camera.pixel_grid(H, W, device=dev)
    active = (x >= b) & (x < W - b) & (y >= b) & (y < H - b)

    has_hyp = state.valid
    # gate 1: valid but too-low gradient -> invalidate (:224-229)
    kill = active & has_hyp & (kf_maxgrad < cfg.min_abs_grad_decrease)
    valid = state.valid & ~kill
    # gate 2: skip entirely (:231-235)
    skip = ((kf_maxgrad < cfg.min_abs_grad_create)
            | (state.blacklisted < cfg.min_blacklist))
    do_pixel = active & ~kill & ~skip

    T = lie.exp_se3(pose_cur_wrt_kf)
    t_kf_from_cur = -T[:3, :3].T @ T[:3, 3]
    epxn, epyn, epl_ok = epl_direction(kf_image, t_kf_from_cur, cfg)
    run = do_pixel & epl_ok

    # stereo search band (create: :279-282; update: :898-904)
    sv = torch.sqrt(torch.clamp_min(state.var_smoothed, 0.0))
    upd_min = torch.clamp_min(
        state.idepth_smoothed - sv * cfg.stereo_epl_var_fac, 0.0)
    upd_max = torch.clamp_max(
        state.idepth_smoothed + sv * cfg.stereo_epl_var_fac,
        1.0 / cfg.min_depth)
    min_id = torch.where(has_hyp, upd_min, 0.0)
    prior = torch.where(has_hyp, state.idepth_smoothed, 1.0)
    max_id = torch.where(has_hyp, upd_max, 1.0 / cfg.min_depth)

    res = line_stereo(kf_image, kf_gradx, kf_grady, cur_image,
                      epxn, epyn, min_id, prior, max_id, pose_cur_wrt_kf, cfg)

    # ---------------- CREATE path (:267-308) ----------------
    create_px = run & ~has_hyp
    create_blacklist = create_px & ((res.code == -3) | (res.code == -2))
    create_ok = create_px & (res.code == 0) & (res.var <= cfg.max_var)
    new_idepth_c = torch.where(torch.abs(res.idepth) < 1e-10,
                               torch.where(res.idepth < 0, -1e-10, 1e-10),
                               res.idepth)

    # ---------------- UPDATE path (:888-999) ----------------
    upd_px = run & has_hyp
    diff = res.idepth - state.idepth_smoothed
    code = res.code
    u_notfound = upd_px & (code == -2)
    inconsistent = upd_px & (code == 0) & (
        cfg.diff_fac_observe * diff * diff > res.var + state.var_smoothed)
    u_success = upd_px & (code == 0) & ~inconsistent

    # -2: validity -= DEC (clamp 0), var *= FAIL; var > MAX -> invalid,
    #     blacklist-- (:925-939)
    validity = torch.where(
        u_notfound,
        torch.clamp_min(state.validity - cfg.validity_counter_dec, 0.0),
        state.validity)
    var = torch.where(u_notfound, state.var * cfg.fail_var_inc_fac,
                      state.var)
    nf_kill = u_notfound & (var > cfg.max_var)
    valid = valid & ~nf_kill
    blk = torch.where(nf_kill, state.blacklisted - 1, state.blacklisted)

    # inconsistent: var *= FAIL; var > MAX -> invalid (:956-962)
    var = torch.where(inconsistent, var * cfg.fail_var_inc_fac, var)
    valid = valid & ~(inconsistent & (var > cfg.max_var))

    # success: textbook EKF fuse (:966-996)
    id_var = state.var * cfg.succ_var_inc_fac
    w = res.var / (res.var + id_var)
    fused = (1.0 - w) * res.idepth + w * state.idepth
    fused = torch.where(torch.abs(fused) < 1e-10,
                        torch.where(fused < 0, -1e-10, 1e-10), fused)
    id_var_post = id_var * w
    new_idepth = torch.where(u_success, fused, state.idepth)
    var = torch.where(u_success & (id_var_post < var), id_var_post, var)
    validity = torch.where(u_success,
                           validity + cfg.validity_counter_inc, validity)
    vmax = cfg.validity_counter_max + kf_maxgrad * \
        cfg.validity_counter_max_variable / 255.0
    validity = torch.where(u_success & (validity > vmax), vmax, validity)

    # apply CREATE
    new_idepth = torch.where(create_ok, new_idepth_c, new_idepth)
    var = torch.where(create_ok, res.var, var)
    smoothed_i = torch.where(create_ok, -1.0, state.idepth_smoothed)
    smoothed_v = torch.where(create_ok, -1.0, state.var_smoothed)
    validity = torch.where(create_ok, cfg.validity_counter_initial_observe,
                           validity)
    valid = valid | create_ok
    blk = torch.where(create_blacklist & ~create_ok, blk - 1, blk)
    blk = torch.where(create_ok, 0, blk)

    out = DepthMapState(idepth=new_idepth, var=var,
                        idepth_smoothed=smoothed_i, var_smoothed=smoothed_v,
                        validity=validity, blacklisted=blk, valid=valid)
    return ObserveResult(state=out,
                         num_created=torch.sum(create_ok),
                         num_updated=torch.sum(u_success))
