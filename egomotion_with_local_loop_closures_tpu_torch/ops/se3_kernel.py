"""The SE(3) compose and relative pose as a hand-written CUDA kernel.

``geom/lie.py::compose`` and ``::relative`` call :func:`compose` for CUDA
tensors: one launch for any number of poses, in place of the ~270 ATen
kernels of the plain formulas (``lie.plain_compose`` and
``lie.plain_relative``, the twin, which runs for CPU tensors).  The CUDA
source is ``csrc/se3_kernel.cu``, one thread a pose, whose arithmetic is
``geom/lie.py``'s through ``csrc/ellc_device.cuh``; what bounds it and
where it parts from the twin is written at the top of that file.

:func:`compose` takes float32 CUDA tensors of shape (6,) or (..., 6),
broadcast against each other, and launches the kernel or raises; it
never falls back.  Its launches are counted in :data:`launches`; a call
made while a CUDA graph captures launches nothing, so
``runtime/graphs.py`` counts those calls apart with :func:`counting_into`
and adds the graph's nodes of this kernel at each replay.
"""

from __future__ import annotations

import contextlib
import ctypes
import re
from pathlib import Path
from typing import Dict, Iterator, Optional, Tuple

import torch

from egomotion_with_local_loop_closures_tpu_torch import ops

SOURCE: Path = ops.CSRC / "se3_kernel.cu"
# How near the kernel keeps to its twin, per pose: every component within
# COMPOSE_TOL of the twin, or no farther from the float64 compose than the
# twin is, plus COMPOSE_TOL (float32 itself lies up to a few 1e-6 from
# float64 at translations of a few units; see agreement()).
COMPOSE_TOL = 1e-6

# Launches on the CUDA path since the last reset_launches(): one a call.
launches: Dict[str, int] = {"se3_compose": 0}
# Launches of the eager warm-ups before CUDA graph captures, kept apart
# from launches (runtime/graphs.py), since the last reset_launches().
warmup_launches: Dict[str, int] = {"se3_compose": 0}
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
    """``se3_compose`` for the CUDA function of this (mangled) name, None
    for any other function."""
    m = re.search(r"\d+(se3_compose)E", kernel_name)
    return m.group(1) if m else None


def build() -> Path:
    """Compile ``csrc/se3_kernel.cu`` unless a library of this exact
    source, headers and flag set is already built; returns its path."""
    return ops.build(SOURCE, "ellc_se3")


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declares the C signature of ``ellc_se3_compose`` on a loaded
    library."""
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.ellc_se3_compose.argtypes = [p, p, p, i, i, p]
    lib.ellc_se3_compose.restype = i
    return lib


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        _lib = bind(ctypes.CDLL(str(build())))
    return _lib


def compose(a: torch.Tensor, b: torch.Tensor,
            invert_b: bool = False) -> torch.Tensor:
    """log(exp(a) exp(b)), or with ``invert_b`` log(exp(a) exp(b)^-1), of
    float32 twists on one CUDA device, (6,) or (..., 6) broadcast against
    each other: one launch for all poses."""
    for name, t in (("a", a), ("b", b)):
        if t.device.type != "cuda":
            raise ValueError(f"the SE(3) kernel takes CUDA tensors; {name} "
                             f"is on {t.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"the SE(3) kernel takes float32 poses; {name} "
                            f"has dtype {t.dtype}")
        if t.dim() == 0 or t.shape[-1] != 6:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                             f"(..., 6)")
    if a.device != b.device:
        raise ValueError(f"a is on {a.device}, b on {b.device}")
    shape = torch.broadcast_shapes(a.shape, b.shape)
    if a.numel() // 6 >= 2 ** 31 or b.numel() // 6 >= 2 ** 31:
        raise ValueError("the kernel takes at most 2^31 - 1 poses")
    with torch.cuda.device(a.device):
        out = _launch(_library(), a.expand(shape), b.expand(shape),
                      invert_b, torch.cuda.current_stream().cuda_stream)
    _counts["se3_compose"] += 1
    return out


def _launch(lib: ctypes.CDLL, a: torch.Tensor, b: torch.Tensor,
            invert_b: bool, stream: int) -> torch.Tensor:
    """One ``ellc_se3_compose`` launch on ``stream`` over poses ``a`` and
    ``b`` of one shape (..., 6) on one device; returns the output."""
    a, b = a.contiguous(), b.contiguous()
    out = torch.empty(a.shape, dtype=torch.float32, device=a.device)
    n = out.numel() // 6
    if n == 0:
        return out
    err = lib.ellc_se3_compose(
        ctypes.c_void_p(a.data_ptr()), ctypes.c_void_p(b.data_ptr()),
        ctypes.c_void_p(out.data_ptr()), n, int(invert_b),
        ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"SE(3) compose launch failed: cudaError {err}")
    return out


def agreement(got: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
              invert_b: bool = False) -> Tuple[float, int]:
    """How far ``got``, the kernel's compose (or relative) of ``a`` and
    ``b``, lies from the twin run on the same device: (the largest
    component difference, the number of poses that break the rule of
    :data:`COMPOSE_TOL`).  The twin's quaternion norms are
    ``torch.linalg.vector_norm`` (a reduction in the library's own order)
    and its trigonometric functions the device library's, so the two round
    some last places apart."""
    from egomotion_with_local_loop_closures_tpu_torch.geom import lie
    twin = lie.plain_relative if invert_b else lie.plain_compose
    shape = torch.broadcast_shapes(a.shape, b.shape)
    a, b = a.expand(shape), b.expand(shape)
    want = twin(a, b)
    exact = twin(a.cpu().double(), b.cpu().double())
    diff = (got - want).abs().reshape(-1, 6).amax(-1).cpu()
    err = (got.cpu().double() - exact).abs().reshape(-1, 6).amax(-1)
    err_twin = (want.cpu().double() - exact).abs().reshape(-1, 6).amax(-1)
    ok = (diff <= COMPOSE_TOL) | (err <= err_twin + COMPOSE_TOL)
    return (float(diff.max()) if diff.numel() else 0.0,
            int((~ok).sum()))
