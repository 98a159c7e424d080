"""The keyframe's depth-pyramid refresh as a hand-written CUDA kernel.

``depth/fusion.py::refresh_depth_pyramid`` (``runtime/pipeline.py``'s
``_refresh_kf_depth``, every frame step) calls :func:`refresh` for CUDA
states and runs its plain twin, ``depth/state.py::to_depth_image`` then
``depth/fusion.py::build_depth_var_pyramid``, for CPU states.  The CUDA
source is ``csrc/depth_refresh_kernel.cu``: one ``depth_refresh`` launch
writes the border-masked ``valid`` plane, level 0's depth and variance and
every fused level above it, for one state (H, W) or a batch (B, H, W); a
warp owns 4x32 pixels and fuses their levels in registers and shuffles.
It is bit-equal to the twin; what bounds it is written at the top of the
source.

:func:`refresh` launches the kernel or raises; it never falls back.  Its
launches are counted in :data:`launches`; a call made while a CUDA graph
captures launches nothing, so ``runtime/graphs.py`` counts those calls
apart with :func:`counting_into` and adds the graph's nodes of this
kernel at each replay.
"""

from __future__ import annotations

import contextlib
import ctypes
import re
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Tuple

import torch

from egomotion_with_local_loop_closures_tpu_torch import ops

SOURCE: Path = ops.CSRC / "depth_refresh_kernel.cu"
# the most levels a launch writes (csrc/depth_refresh_kernel.cu kMaxLevels)
MAX_LEVELS = 4

# Launches on the CUDA path since the last reset_launches(): one a call.
launches: Dict[str, int] = {"depth_refresh": 0}
# Launches of the eager warm-ups before CUDA graph captures, kept apart
# from launches (runtime/graphs.py), since the last reset_launches().
warmup_launches: Dict[str, int] = {"depth_refresh": 0}
# where the wrapper counts its calls: launches, or counting_into's dict
_counts: Dict[str, int] = launches

_lib: Optional[ctypes.CDLL] = None


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0
        warmup_launches[k] = 0


def add_launches(counts: Dict[str, int]) -> None:
    """Count launches that no wrapper call makes: the nodes of this
    kernel in a CUDA graph, added at each of its replays
    (``runtime/graphs.py``)."""
    for k, n in counts.items():
        launches[k] += n


@contextlib.contextmanager
def counting_into(counts: Dict[str, int]) -> Iterator[Dict[str, int]]:
    """Count the wrapper's launches in ``counts`` instead of
    :data:`launches` while the block runs (a CUDA graph's warm-up and
    capture, ``runtime/graphs.py``)."""
    global _counts
    prev, _counts = _counts, counts
    try:
        yield counts
    finally:
        _counts = prev


def wrapper_of(kernel_name: str) -> Optional[str]:
    """``depth_refresh`` for the CUDA function of this (mangled) name,
    None for any other function."""
    m = re.search(r"\d+(depth_refresh)E", kernel_name)
    return m.group(1) if m else None


def build() -> Path:
    """Compile ``csrc/depth_refresh_kernel.cu`` unless a library of this
    exact source, headers and flag set is already built; returns its
    path."""
    return ops.build(SOURCE, "ellc_depth_refresh")


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declares the C signature of ``ellc_depth_refresh`` on a loaded
    library."""
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.ellc_depth_refresh.argtypes = [p] * 6 + [i] * 5 + [p]
    lib.ellc_depth_refresh.restype = i
    return lib


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        _lib = bind(ctypes.CDLL(str(build())))
    return _lib


def refresh(valid: torch.Tensor, idepth_smoothed: torch.Tensor,
            var_smoothed: torch.Tensor, border: int, num_levels: int
            ) -> Tuple[torch.Tensor, List[torch.Tensor], List[torch.Tensor]]:
    """(valid masked to the interior ``border`` pixels in, depth levels,
    variance levels) of a state's planes (H, W) or (B, H, W) on the card:
    ``valid`` bool, the smoothed inverse depth and variance float32.  One
    launch."""
    named = dict(valid=valid, idepth_smoothed=idepth_smoothed,
                 var_smoothed=var_smoothed)
    dev = valid.device
    if dev.type != "cuda":
        raise ValueError(f"the refresh kernel takes CUDA tensors; valid is "
                         f"on {dev}")
    for name, t in named.items():
        want = torch.bool if name == "valid" else torch.float32
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, expected {dev}")
        if t.dtype != want:
            raise TypeError(f"{name} has dtype {t.dtype}, expected {want}")
        if t.shape != valid.shape or t.dim() < 2:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                             f"(..., H, W) as valid {tuple(valid.shape)}")
    if not 1 <= num_levels <= MAX_LEVELS:
        raise ValueError(f"{num_levels} levels: the kernel writes 1 to "
                         f"{MAX_LEVELS}")
    if valid.numel() >= 2 ** 31 or valid.numel() == 0:
        raise ValueError(f"{valid.numel()} pixels: the kernel takes 1 to "
                         f"2^31 - 1")
    with torch.cuda.device(dev):
        out = _launch(_library(), valid, idepth_smoothed, var_smoothed,
                      border, num_levels,
                      torch.cuda.current_stream().cuda_stream)
    _counts["depth_refresh"] += 1
    return out


def _empty(shape: Tuple[int, ...], dtype: torch.dtype,
           device: torch.device) -> torch.Tensor:
    """An output plane, written whole by the kernel."""
    return torch.empty(shape, dtype=dtype, device=device)


def _launch(lib: ctypes.CDLL, valid: torch.Tensor, idepth_smoothed:
            torch.Tensor, var_smoothed: torch.Tensor, border: int,
            num_levels: int, stream: int
            ) -> Tuple[torch.Tensor, List[torch.Tensor], List[torch.Tensor]]:
    """:func:`refresh`'s launch of ``lib`` on ``stream``, any device."""
    valid, ids, vs = (t.contiguous() for t in
                      (valid, idepth_smoothed, var_smoothed))
    dev = valid.device
    lead = valid.shape[:-2]
    H, W = valid.shape[-2:]
    shapes = [(H, W)]
    for _ in range(num_levels - 1):
        shapes.append((shapes[-1][0] // 2, shapes[-1][1] // 2))
    valid_out = _empty(valid.shape, torch.bool, dev)
    depths = [_empty(lead + s, torch.float32, dev) for s in shapes]
    vars_ = [_empty(lead + s, torch.float32, dev) for s in shapes]
    ptrs = ctypes.c_void_p * MAX_LEVELS
    err = lib.ellc_depth_refresh(
        ctypes.c_void_p(valid.data_ptr()), ctypes.c_void_p(ids.data_ptr()),
        ctypes.c_void_p(vs.data_ptr()), ctypes.c_void_p(valid_out.data_ptr()),
        ptrs(*(d.data_ptr() for d in depths)),
        ptrs(*(v.data_ptr() for v in vars_)),
        valid[..., 0, 0].numel(), H, W, num_levels, border,
        ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"depth refresh launch failed: cudaError {err}")
    return valid_out, depths, vars_
