"""Depth-map regularization as a hand-written CUDA kernel (K3).

Replaces the TPU kernel
``egomotion_with_local_loop_closures_tpu/ops/reg_kernel.py::do_regularization_pallas``
(fillDepthHoles + regularizeDepthMap fused in one Pallas call).  The CUDA
source is ``csrc/reg_kernel.cu``: one launch per call, each block filling
and smoothing a 32x8 tile from shared memory.  What bounds it on the card
and how it is laid out is written at the top of that file.

Both wrappers take one state of (H, W) planes or a batch of B states of
(B, H, W) planes (the connection-recovery trials, one per loop-window
candidate, with ``kf_maxgrad`` (B, H, W) too).  Each makes one launch per
call, whatever B is, and counts it in :data:`launches` (a call made while
a CUDA graph captures launches nothing: ``runtime/graphs.py`` counts its
calls apart with :func:`counting_into` and adds the graph's K3 nodes to
:data:`launches` at each replay):

- :func:`do_regularization` -- the fill, then the smoothing;
- :func:`regularize` -- the smoothing alone (the standalone
  regularizeDepthMap calls of the pipeline).

For a tensor on the CPU each wrapper runs the plain PyTorch version
(``depth/propagate.py``).  For a CUDA tensor it launches the kernel or
raises; it never falls back.

The kernel is compiled with ``nvcc`` on first use, from this checkout's
source, into ``egomotion_with_local_loop_closures_tpu_torch/build/``
(one shared library per source hash, loaded with ``ctypes``).
"""

from __future__ import annotations

import contextlib
import ctypes
import re
from pathlib import Path
from typing import Dict, Iterator, Optional

import torch

from egomotion_with_local_loop_closures_tpu_torch.config import ELLCConfig
from egomotion_with_local_loop_closures_tpu_torch.depth import propagate
from egomotion_with_local_loop_closures_tpu_torch.depth.state import (
    FIELDS, DepthMapState)
from egomotion_with_local_loop_closures_tpu_torch import ops

SOURCE: Path = ops.CSRC / "reg_kernel.cu"
BUILD_DIR, NVCC_FLAGS = ops.BUILD_DIR, ops.NVCC_FLAGS
_find_nvcc = ops.find_nvcc

# Launches on the CUDA path since the last reset_launches(), per wrapper.
launches: Dict[str, int] = {"do_regularization": 0, "regularize": 0}
# Launches of the eager warm-ups before CUDA graph captures, kept apart
# from launches (runtime/graphs.py), since the last reset_launches().
warmup_launches: Dict[str, int] = {"do_regularization": 0, "regularize": 0}
# where the wrappers count their calls: launches, or counting_into's dict
_counts: Dict[str, int] = launches

_lib: Optional[ctypes.CDLL] = None


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0
        warmup_launches[k] = 0


def add_launches(counts: Dict[str, int]) -> None:
    """Count launches that no wrapper call makes: the K3 nodes of a CUDA
    graph, added at each of its replays (``runtime/graphs.py``)."""
    for k, n in counts.items():
        launches[k] += n


@contextlib.contextmanager
def counting_into(counts: Dict[str, int]) -> Iterator[Dict[str, int]]:
    """Count the wrappers' calls in ``counts`` instead of
    :data:`launches` while the block runs: a CUDA graph's warm-up, whose
    launches are reported apart, and its capture, whose calls launch
    nothing (``runtime/graphs.py``)."""
    global _counts
    prev, _counts = _counts, counts
    try:
        yield counts
    finally:
        _counts = prev


def wrapper_of(kernel_name: str) -> Optional[str]:
    """The wrapper that launches the CUDA function of this (mangled)
    name: ``reg_kernel<kFill, kOccl>`` with the fill is
    :func:`do_regularization`'s, without it :func:`regularize`'s; None
    for any other function."""
    m = re.search(r"reg_kernelILb([01])E", kernel_name)
    if m is None:
        return None
    return "do_regularization" if m.group(1) == "1" else "regularize"


def build() -> Path:
    """Compile ``csrc/reg_kernel.cu`` unless a library of this exact source
    and flag set is already built; returns the library's path."""
    return ops.build(SOURCE, "ellc_reg")


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declares the C signature of ``ellc_reg`` on a loaded library."""
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.ellc_reg.argtypes = [p] * 15 + [i, i, i, i, i, f, i, f, f, f, i,
                                        f, f, f, p]
    lib.ellc_reg.restype = i
    return lib


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        _lib = bind(ctypes.CDLL(str(build())))
    return _lib


_DTYPES = dict(idepth=torch.float32, var=torch.float32,
               idepth_smoothed=torch.float32, var_smoothed=torch.float32,
               validity=torch.float32, blacklisted=torch.int32,
               valid=torch.bool)


# a grid's z extent, which indexes the batch
_MAX_BATCH = 65535


def _check(state: DepthMapState, maxgrad: Optional[torch.Tensor] = None):
    dev = state.idepth.device
    if dev.type != "cuda":
        raise ValueError(f"K3 runs on CUDA tensors or CPU tensors, not {dev}")
    shape = state.idepth.shape
    if len(shape) == 3 and not 1 <= shape[0] <= _MAX_BATCH:
        raise ValueError(f"a batch of {shape[0]} states: K3 takes 1 to "
                         f"{_MAX_BATCH}")
    named = [(n, getattr(state, n), _DTYPES[n]) for n in FIELDS]
    if maxgrad is not None:
        named.append(("kf_maxgrad", maxgrad, torch.float32))
    for name, t, dtype in named:
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, expected {dev}")
        if t.dtype != dtype:
            raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
        if t.dim() not in (2, 3) or t.shape != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                             f"{tuple(shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} is not contiguous")


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")


# the planes that regularizeDepthMap alone writes
_SMOOTHED = ("idepth_smoothed", "var_smoothed", "blacklisted", "valid")


def _launch(lib: ctypes.CDLL, state: DepthMapState,
            kf_maxgrad: Optional[torch.Tensor], cfg: ELLCConfig,
            remove_occlusions: bool, stream: int) -> DepthMapState:
    """One launch of ``ellc_reg`` on ``stream`` over one state (H, W) or a
    batch (B, H, W): with the fill when ``kf_maxgrad`` is given (all seven
    planes written), else the smoothing alone (four planes written)."""
    fill = kf_maxgrad is not None
    out = {n: torch.empty_like(getattr(state, n))
           for n in (FIELDS if fill else _SMOOTHED)}
    B, H, W = (1, *state.idepth.shape) if state.idepth.dim() == 2 \
        else state.idepth.shape
    err = lib.ellc_reg(
        *[_ptr(getattr(state, n)) for n in FIELDS],
        _ptr(kf_maxgrad) if fill else None,
        *[_ptr(out[n]) if n in out else None for n in FIELDS],
        B, H, W, int(fill), int(remove_occlusions),
        cfg.min_abs_grad_decrease, cfg.min_blacklist,
        cfg.val_sum_min_for_create, cfg.val_sum_min_for_unblacklist,
        cfg.var_random_init, int(cfg.lsd_correct_hole_fill),
        cfg.diff_fac_smoothing, cfg.reg_dist_var, cfg.val_sum_min_for_keep,
        ctypes.c_void_p(stream))
    _raise_on(err, "ellc_reg")
    return state.replace(**out)


def _cuda(state: DepthMapState, kf_maxgrad: Optional[torch.Tensor],
          cfg: ELLCConfig, remove_occlusions: bool) -> DepthMapState:
    _check(state, kf_maxgrad)
    with torch.cuda.device(state.idepth.device):
        stream = torch.cuda.current_stream().cuda_stream
        return _launch(_library(), state, kf_maxgrad, cfg, remove_occlusions,
                       stream)


def do_regularization(state: DepthMapState, kf_maxgrad: torch.Tensor,
                      cfg: ELLCConfig,
                      remove_occlusions: bool = False) -> DepthMapState:
    """fillDepthHoles + regularizeDepthMap: the CUDA kernel for CUDA
    tensors, ``propagate.do_regularization`` for CPU tensors."""
    if state.idepth.device.type == "cpu":
        return propagate.do_regularization(state, kf_maxgrad, cfg,
                                           remove_occlusions)
    out = _cuda(state, kf_maxgrad, cfg, remove_occlusions)
    _counts["do_regularization"] += 1
    return out


def regularize(state: DepthMapState, cfg: ELLCConfig,
               remove_occlusions: bool = False) -> DepthMapState:
    """regularizeDepthMap alone: the kernel without the fill for CUDA
    tensors, ``propagate.regularize`` for CPU tensors."""
    if state.idepth.device.type == "cpu":
        return propagate.regularize(state, cfg, remove_occlusions)
    out = _cuda(state, None, cfg, remove_occlusions)
    _counts["regularize"] += 1
    return out
