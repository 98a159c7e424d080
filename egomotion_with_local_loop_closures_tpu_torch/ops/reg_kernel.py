"""Depth-map regularization as a hand-written CUDA kernel (K3).

Replaces the TPU kernel
``egomotion_with_local_loop_closures_tpu/ops/reg_kernel.py::do_regularization_pallas``
(fillDepthHoles + regularizeDepthMap fused in one Pallas call).  The CUDA
source is ``csrc/reg_kernel.cu``: one thread per pixel, a fill pass and a
smoothing pass.  What bounds it on the card and how it is laid out is
written at the top of that file.

Two wrappers, each with its launch count in :data:`launches`:

- :func:`do_regularization` -- both passes (two launches, counted once);
- :func:`regularize` -- the smoothing pass alone (the standalone
  regularizeDepthMap calls of the pipeline).

For a tensor on the CPU each wrapper runs the plain PyTorch version
(``depth/propagate.py``).  For a CUDA tensor it launches the kernel or
raises; it never falls back.

The kernel is compiled with ``nvcc`` on first use, from this checkout's
source, into ``egomotion_with_local_loop_closures_tpu_torch/build/``
(one shared library per source hash, loaded with ``ctypes``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Optional

import torch

from egomotion_with_local_loop_closures_tpu_torch.config import ELLCConfig
from egomotion_with_local_loop_closures_tpu_torch.depth import propagate
from egomotion_with_local_loop_closures_tpu_torch.depth.state import (
    FIELDS, DepthMapState)

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "reg_kernel.cu"
BUILD_DIR = _PKG / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-fmad=false", "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas=-v")

# Launches on the CUDA path since the last reset_launches(), per wrapper.
launches: Dict[str, int] = {"do_regularization": 0, "regularize": 0}

_lib: Optional[ctypes.CDLL] = None
build_log = ""      # nvcc's output of the build this process made, if any


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        nvcc = "/usr/local/cuda/bin/nvcc"
    if nvcc is None:
        raise RuntimeError("nvcc not found: the K3 CUDA kernel cannot be "
                           "built (install the CUDA toolkit or put nvcc on "
                           "PATH)")
    return nvcc


def build() -> Path:
    """Compile ``csrc/reg_kernel.cu`` unless a library of this exact source
    and flag set is already built; returns the library's path."""
    global build_log
    digest = hashlib.sha256(SOURCE.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    lib = BUILD_DIR / f"libellc_reg_{digest}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    proc = subprocess.run([_find_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                           str(SOURCE)], capture_output=True, text=True)
    build_log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {SOURCE}:\n{build_log}")
    os.replace(tmp, lib)
    return lib


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.ellc_reg_fill.argtypes = [p] * 15 + [i, i, f, i, f, f, f, i, p]
        lib.ellc_reg_fill.restype = i
        lib.ellc_reg_smooth.argtypes = [p] * 11 + [i, i, f, f, f, i, p]
        lib.ellc_reg_smooth.restype = i
        _lib = lib
    return _lib


_DTYPES = dict(idepth=torch.float32, var=torch.float32,
               idepth_smoothed=torch.float32, var_smoothed=torch.float32,
               validity=torch.float32, blacklisted=torch.int32,
               valid=torch.bool)


def _check(state: DepthMapState, maxgrad: Optional[torch.Tensor] = None):
    dev = state.idepth.device
    if dev.type != "cuda":
        raise ValueError(f"K3 runs on CUDA tensors or CPU tensors, not {dev}")
    shape = state.idepth.shape
    named = [(n, getattr(state, n), _DTYPES[n]) for n in FIELDS]
    if maxgrad is not None:
        named.append(("kf_maxgrad", maxgrad, torch.float32))
    for name, t, dtype in named:
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, expected {dev}")
        if t.dtype != dtype:
            raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
        if t.dim() != 2 or t.shape != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                             f"{tuple(shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} is not contiguous")


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")


def _fill(state: DepthMapState, maxgrad: torch.Tensor,
          cfg: ELLCConfig) -> DepthMapState:
    H, W = state.idepth.shape
    out = {n: torch.empty_like(getattr(state, n)) for n in FIELDS}
    stream = torch.cuda.current_stream(state.idepth.device).cuda_stream
    err = _library().ellc_reg_fill(
        *[_ptr(getattr(state, n)) for n in FIELDS], _ptr(maxgrad),
        *[_ptr(out[n]) for n in FIELDS], H, W,
        cfg.min_abs_grad_decrease, cfg.min_blacklist,
        cfg.val_sum_min_for_create, cfg.val_sum_min_for_unblacklist,
        cfg.var_random_init, int(cfg.lsd_correct_hole_fill),
        ctypes.c_void_p(stream))
    _raise_on(err, "ellc_reg_fill")
    return DepthMapState(**out)


def _smooth(state: DepthMapState, cfg: ELLCConfig,
            remove_occlusions: bool) -> DepthMapState:
    H, W = state.idepth.shape
    written = ("idepth_smoothed", "var_smoothed", "blacklisted", "valid")
    out = {n: torch.empty_like(getattr(state, n)) for n in written}
    stream = torch.cuda.current_stream(state.idepth.device).cuda_stream
    err = _library().ellc_reg_smooth(
        *[_ptr(getattr(state, n)) for n in FIELDS],
        *[_ptr(out[n]) for n in written], H, W,
        cfg.diff_fac_smoothing, cfg.reg_dist_var, cfg.val_sum_min_for_keep,
        int(remove_occlusions), ctypes.c_void_p(stream))
    _raise_on(err, "ellc_reg_smooth")
    return state.replace(**out)


def do_regularization(state: DepthMapState, kf_maxgrad: torch.Tensor,
                      cfg: ELLCConfig,
                      remove_occlusions: bool = False) -> DepthMapState:
    """fillDepthHoles + regularizeDepthMap: the CUDA kernel for CUDA
    tensors, ``propagate.do_regularization`` for CPU tensors."""
    if state.idepth.device.type == "cpu":
        return propagate.do_regularization(state, kf_maxgrad, cfg,
                                           remove_occlusions)
    _check(state, kf_maxgrad)
    with torch.cuda.device(state.idepth.device):
        out = _smooth(_fill(state, kf_maxgrad, cfg), cfg, remove_occlusions)
    launches["do_regularization"] += 1
    return out


def regularize(state: DepthMapState, cfg: ELLCConfig,
               remove_occlusions: bool = False) -> DepthMapState:
    """regularizeDepthMap alone: the kernel's smoothing pass for CUDA
    tensors, ``propagate.regularize`` for CPU tensors."""
    if state.idepth.device.type == "cpu":
        return propagate.regularize(state, cfg, remove_occlusions)
    _check(state)
    with torch.cuda.device(state.idepth.device):
        out = _smooth(state, cfg, remove_occlusions)
    launches["regularize"] += 1
    return out
