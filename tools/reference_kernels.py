"""The path that the port's propagate kernels replaced, held beside them on
the card.

``csrc/propagate_kernel.cu`` does keyframe depth propagation's
reprojection, gates and merge in a memset and two launches.  Before it,
the port made the candidates in ATen (:func:`candidates`, kept here as
``depth/propagate.py::candidates`` was, its divisions by the focal
lengths ATen's) and merged them with the kernels of
``tools/reference_csrc/propagate_merge_lists.cu``, which is not on the
port's path.  chip_smoke.py's phase 3d holds the port's kernels bit for
bit against :func:`aten_propagate` and times the two in turns.

The merge is built by ``ops.build`` with the port's flags into the port's
ignored ``build/`` directory on first use.  Import this file by path
(``chip_smoke.load_tool("reference_kernels")``).
"""

from __future__ import annotations

import ctypes
import math
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from egomotion_with_local_loop_closures_tpu_torch import ops  # noqa: E402
from egomotion_with_local_loop_closures_tpu_torch.geom import (  # noqa: E402
    camera, lie)
from egomotion_with_local_loop_closures_tpu_torch.image import (  # noqa: E402
    interp)
from egomotion_with_local_loop_closures_tpu_torch.ops import (  # noqa: E402
    propagate_kernel)

MERGE_LISTS = ROOT / "tools" / "reference_csrc" / "propagate_merge_lists.cu"


def build_merge_lists() -> Path:
    return ops.build(MERGE_LISTS, "ellc_ref_merge_lists")


def bind_merge_lists(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declares the C signature of ``ellc_propagate_merge``."""
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.ellc_propagate_merge.argtypes = [p] * 14 + [i, f, f, p]
    lib.ellc_propagate_merge.restype = i
    return lib


def load_merge_lists(path: os.PathLike = None) -> ctypes.CDLL:
    return bind_merge_lists(ctypes.CDLL(str(path or build_merge_lists())))


def merge_lists(lib: ctypes.CDLL, tgt, cand, idepth, var, validity, shape,
                cfg, stream: int):
    """The merge of ``candidates()``' outputs (each (N,), one device) on
    ``stream``: a memset and two launches; returns the merged state."""
    n = tgt.numel()
    dev = tgt.device
    tgt, cand, idepth, var, validity = (
        t.contiguous() for t in (tgt, cand, idepth, var, validity))
    scratch = torch.empty((2, n), dtype=torch.int32, device=dev)
    out = (*(torch.empty(n, dtype=torch.float32, device=dev)
             for _ in range(5)),
           torch.empty(n, dtype=torch.int32, device=dev),
           torch.empty(n, dtype=torch.bool, device=dev))
    err = lib.ellc_propagate_merge(
        *[ctypes.c_void_p(t.data_ptr()) for t in
          (tgt, cand, idepth, var, validity, scratch[0], scratch[1], *out)],
        n, cfg.diff_fac_prop_merge, propagate_kernel.validity_cap(cfg),
        ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"reference merge launch failed: cudaError {err}")
    return propagate_kernel._state(out, shape)


def candidates(state, old_kf_image, new_kf_image, new_kf_maxgrad,
               pose_new_wrt_old, cfg):
    """The candidates as the port made them in ATen before its propagate
    kernels: every source pixel's flat target cell (int64), whether it is
    a candidate, its inverse depth and inflated variance in the new
    keyframe, and its validity; each flat (N,)."""
    H, W = old_kf_image.shape[-2:]
    lead = old_kf_image.shape[:-2]
    dev = old_kf_image.device
    fx, fy, cx, cy = cfg.fx, cfg.fy, cfg.cx, cfg.cy
    T = lie.exp_se3(pose_new_wrt_old)          # new <- old
    R, t = T[..., :3, :3, None, None], T[..., :3, 3, None, None]
    R = [[R[..., i, j, :, :] for j in range(3)] for i in range(3)]
    t = [t[..., i, :, :] for i in range(3)]

    x, y = camera.pixel_grid(H, W, device=dev)
    src_valid = state.valid
    ids = torch.where(torch.abs(state.idepth_smoothed) > 1e-12,
                      state.idepth_smoothed, 1e-12)
    rx = (x - cx) / fx
    ry = (y - cy) / fy
    px = (R[0][0] * rx + R[0][1] * ry + R[0][2]) / ids + t[0]
    py = (R[1][0] * rx + R[1][1] * ry + R[1][2]) / ids + t[1]
    pz = (R[2][0] * rx + R[2][1] * ry + R[2][2]) / ids + t[2]
    pz_safe = torch.where(torch.abs(pz) > 1e-12, pz, 1e-12)
    new_idepth = 1.0 / pz_safe
    u = px * new_idepth * fx + cx
    v = py * new_idepth * fy + cy

    in_img = (u > 2.1) & (v > 2.1) & (u < W - 3.1) & (v < H - 3.1)
    tx = torch.clamp(u + 0.5, -1.0, float(W)).to(torch.int32).clamp(0, W - 1)
    ty = torch.clamp(v + 0.5, -1.0, float(H)).to(torch.int32).clamp(0, H - 1)
    first = (torch.arange(math.prod(lead), device=dev, dtype=torch.int64)
             .reshape(lead + (1, 1)) * (H * W))
    tgt = (first + ty * W + tx).reshape(-1)

    dest_grad = new_kf_maxgrad
    dest_color = interp.bilinear_fill(new_kf_image, u, v)
    residual = dest_color - old_kf_image
    photo_ok = (residual * residual /
                (cfg.max_diff_constant
                 + cfg.max_diff_grad_mult * dest_grad * dest_grad) <= 1.0)
    grad_ok = dest_grad >= cfg.min_abs_grad_decrease
    cand = src_valid & in_img & photo_ok & grad_ok

    ratio = new_idepth / ids
    ratio4 = (ratio * ratio) * (ratio * ratio)
    new_var = ratio4 * state.idepth
    return (tgt, cand.reshape(-1), new_idepth.reshape(-1),
            new_var.reshape(-1), state.validity.reshape(-1))


def aten_propagate(lib: ctypes.CDLL, state, old_kf_image, new_kf_image,
                   new_kf_maxgrad, pose, cfg):
    """``propagate`` as ATen :func:`candidates` followed by the reference
    merge, on the current stream of the state's CUDA device."""
    with torch.cuda.device(state.idepth.device):
        return merge_lists(
            lib, *candidates(state, old_kf_image, new_kf_image,
                             new_kf_maxgrad, pose, cfg),
            tuple(state.idepth.shape), cfg,
            torch.cuda.current_stream().cuda_stream)
