"""The image pyramid, its gradients and the dilated max-gradient map as a
hand-written CUDA kernel.

``image/pyramid.py`` calls this module for CUDA tensors
(``build_levels``, ``build_pyramid``, ``gradients``, ``max_abs_gradient``)
and runs its plain twins for CPU tensors.  The CUDA source is
``csrc/pyramid_kernel.cu``: one ``pyramid_level`` launch writes up to
:data:`MAX_LEVELS` levels, every level's gradients and, when asked, level
0's max-gradient map, for one image or a batch (B, H, W); a block owns a
tile at every level and recomputes its halos.  It is bit-equal to the
twin; what bounds it is written at the top of the source.

For CUDA tensors every function here launches the kernel or raises; it
never falls back.  Launches are counted in :data:`launches`; a call made
while a CUDA graph captures launches nothing, so ``runtime/graphs.py``
counts those calls apart with :func:`counting_into` and adds the graph's
nodes of this kernel at each replay.
"""

from __future__ import annotations

import contextlib
import ctypes
import re
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Tuple

import torch

from egomotion_with_local_loop_closures_tpu_torch import ops

SOURCE: Path = ops.CSRC / "pyramid_kernel.cu"
# the most levels a launch writes (csrc/pyramid_kernel.cu kMaxLevels)
MAX_LEVELS = 4

# Launches on the CUDA path since the last reset_launches(): one a
# build_levels call of up to MAX_LEVELS levels.
launches: Dict[str, int] = {"pyramid_level": 0}
# Launches of the eager warm-ups before CUDA graph captures, kept apart
# from launches (runtime/graphs.py), since the last reset_launches().
warmup_launches: Dict[str, int] = {"pyramid_level": 0}
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
    """``pyramid_level`` for the CUDA function of this (mangled) name,
    None for any other function."""
    m = re.search(r"\d+(pyramid_level)E", kernel_name)
    return m.group(1) if m else None


def build() -> Path:
    """Compile ``csrc/pyramid_kernel.cu`` unless a library of this exact
    source, headers and flag set is already built; returns its path."""
    return ops.build(SOURCE, "ellc_pyramid")


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declares the C signatures of the library's entry points."""
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.ellc_pyramid_levels.argtypes = [p] * 5 + [i, i, i, i, p]
    lib.ellc_pyramid_levels.restype = i
    lib.ellc_pyramid_maxgrad.argtypes = [p] * 3 + [i, i, i, p]
    lib.ellc_pyramid_maxgrad.restype = i
    return lib


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        _lib = bind(ctypes.CDLL(str(build())))
    return _lib


def _check(name: str, t: torch.Tensor) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"the pyramid kernel takes CUDA tensors; {name} is "
                         f"on {t.device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} has dtype {t.dtype}, expected float32")
    if t.dim() < 2 or t.shape[-2] < 2 or t.shape[-1] < 2:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"(..., H, W) with H, W >= 2")
    if t.numel() >= 2 ** 31:
        raise ValueError(f"{name} has {t.numel()} elements: the kernel "
                         f"takes fewer than 2^31")


def _ptr(t: Optional[torch.Tensor]) -> ctypes.c_void_p:
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def _raise_on(err: int) -> None:
    if err != 0:
        raise RuntimeError(f"pyramid kernel launch failed: cudaError {err}")


def build_levels(img: torch.Tensor, num_levels: int, grads: bool = True,
                 max_grad: bool = False
                 ) -> Tuple[List[torch.Tensor], List[torch.Tensor],
                            List[torch.Tensor], Optional[torch.Tensor]]:
    """The pyramid of ``img`` (H, W) or (..., H, W), float32 on the card:
    (images, gx, gy, max-gradient map of level 0), the gradients of every
    level when ``grads`` (else two empty lists) and the map when
    ``max_grad`` (else None).  One launch for up to :data:`MAX_LEVELS`
    levels (one more for each further three), none when there is nothing
    to write."""
    _check("img", img)
    with torch.cuda.device(img.device):
        out = _levels(_library(), img, num_levels, grads, max_grad,
                      torch.cuda.current_stream().cuda_stream)
    _counts["pyramid_level"] += out[-1]
    return out[:-1]


def _empty(shape: Tuple[int, ...], device: torch.device) -> torch.Tensor:
    """An output plane, written whole by the kernel."""
    return torch.empty(shape, dtype=torch.float32, device=device)


def _levels(lib: ctypes.CDLL, img: torch.Tensor, num_levels: int,
            grads: bool, max_grad: bool, stream: int):
    """:func:`build_levels`'s launches of ``lib`` on ``stream``, any
    device; returns its four results and the number of launches.  Past
    :data:`MAX_LEVELS` levels a launch starts from the last level of the
    one before, whose gradients it leaves alone."""
    if num_levels < 1:
        raise ValueError(f"num_levels {num_levels}: at least 1")
    img = img.contiguous()
    lead, dev = img.shape[:-2], img.device
    shapes = [tuple(img.shape[-2:])]
    for level in range(1, num_levels):
        H, W = shapes[-1][0] // 2, shapes[-1][1] // 2
        if H < 2 or W < 2:
            raise ValueError(f"level {level} of {tuple(img.shape)} would be "
                             f"{H}x{W}: the kernel takes levels of at least "
                             f"2x2")
        shapes.append((H, W))
    imgs = [img] + [_empty(lead + s, dev) for s in shapes[1:]]
    gxs = [_empty(lead + s, dev) for s in shapes] if grads else []
    gys = [_empty(lead + s, dev) for s in shapes] if grads else []
    mg = _empty(img.shape, dev) if max_grad else None
    if num_levels == 1 and not grads and not max_grad:
        return imgs, gxs, gys, mg, 0
    ptrs = ctypes.c_void_p * MAX_LEVELS
    B = img[..., 0, 0].numel()
    first, n = 0, 0
    while True:
        last = min(first + MAX_LEVELS, num_levels)
        chunk = range(first, last)
        own = [grads and (level > first or first == 0) for level in chunk]
        _raise_on(lib.ellc_pyramid_levels(
            _ptr(imgs[first]),
            ptrs(None, *(imgs[level].data_ptr() for level in chunk[1:])),
            ptrs(*(gxs[level].data_ptr() if g else None
                   for level, g in zip(chunk, own))),
            ptrs(*(gys[level].data_ptr() if g else None
                   for level, g in zip(chunk, own))),
            _ptr(mg if first == 0 else None), B, *shapes[first],
            last - first, ctypes.c_void_p(stream)))
        n += 1
        if last == num_levels:
            return imgs, gxs, gys, mg, n
        first = last - 1


def max_abs_gradient(gx: torch.Tensor, gy: torch.Tensor) -> torch.Tensor:
    """The dilated max-gradient map of gradient planes (H, W) or
    (..., H, W), float32 on the card: one launch of the same kernel."""
    _check("gx", gx)
    _check("gy", gy)
    if gx.shape != gy.shape or gx.device != gy.device:
        raise ValueError(f"gx {tuple(gx.shape)} on {gx.device}, gy "
                         f"{tuple(gy.shape)} on {gy.device}")
    with torch.cuda.device(gx.device):
        out = _maxgrad(_library(), gx, gy,
                       torch.cuda.current_stream().cuda_stream)
    _counts["pyramid_level"] += 1
    return out


def _maxgrad(lib: ctypes.CDLL, gx: torch.Tensor, gy: torch.Tensor,
             stream: int) -> torch.Tensor:
    """:func:`max_abs_gradient`'s launch of ``lib`` on ``stream``."""
    gx, gy = gx.contiguous(), gy.contiguous()
    out = _empty(gx.shape, gx.device)
    H, W = gx.shape[-2:]
    _raise_on(lib.ellc_pyramid_maxgrad(
        _ptr(gx), _ptr(gy), _ptr(out), gx[..., 0, 0].numel(), H, W,
        ctypes.c_void_p(stream)))
    return out
