"""Keyframe depth propagation as hand-written CUDA kernels: the
reprojection, the gates and the candidate merge, summed in a fixed order.

``depth/propagate.py::propagate`` calls :func:`propagate` for CUDA
tensors: every hypothesis of the old keyframe is reprojected into the new
keyframe's grid, gated, and each target cell keeps the nearest candidate
and fuses every candidate compatible with it by inverse variance (the JAX
package's ``depth/propagate.py:40-135``).  The CUDA source is
``csrc/propagate_kernel.cu``: a memset and two launches a call,
``propagate_candidates`` (a thread a source pixel: the reprojection, the
gates and the push onto its target's list) and ``propagate_merge`` (a
thread a target cell), for one state or a batch; what bounds it is
written at the top of that file.

The plain twin is ``depth/propagate.py::candidates`` followed by
:func:`plain_merge`, which runs for CPU tensors.  The sums run over each
cell's compatible candidates in ascending source index, from +0.0: the
order of the CPU's sequential ``index_add_`` and of the JAX package's
scatter on the CPU.  So :func:`propagate` gives the same bits on the card
as the twin, and two runs on the card give the same bits; float
``index_add_`` on CUDA adds in atomic order, and two runs differed.

:func:`propagate` launches the kernels or raises; it never falls back.
Its launches are counted in :data:`launches`, by kernel; a call made while
a CUDA graph captures launches nothing, so ``runtime/graphs.py`` counts
those calls apart with :func:`counting_into` and adds the graph's nodes
of these kernels at each replay.  Nothing here reads the card's values
back to the host, so a graph captures every call.
"""

from __future__ import annotations

import contextlib
import ctypes
import re
from pathlib import Path
from typing import Dict, Iterator, Optional, Tuple

import torch

from egomotion_with_local_loop_closures_tpu_torch import ops
from egomotion_with_local_loop_closures_tpu_torch.config import ELLCConfig
from egomotion_with_local_loop_closures_tpu_torch.depth.state import (
    FIELDS, DepthMapState)
from egomotion_with_local_loop_closures_tpu_torch.geom.camera import (
    division_reciprocal32)

SOURCE: Path = ops.CSRC / "propagate_kernel.cu"
KERNELS = ("propagate_candidates", "propagate_merge")

# Launches on the CUDA path since the last reset_launches(), by kernel:
# one of each a call.
launches: Dict[str, int] = dict.fromkeys(KERNELS, 0)
# Launches of the eager warm-ups before CUDA graph captures, kept apart
# from launches (runtime/graphs.py), since the last reset_launches().
warmup_launches: Dict[str, int] = dict.fromkeys(KERNELS, 0)
# where the wrapper counts its calls: launches, or counting_into's dict
_counts: Dict[str, int] = launches

_lib: Optional[ctypes.CDLL] = None


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0
        warmup_launches[k] = 0


def add_launches(counts: Dict[str, int]) -> None:
    """Count launches that no wrapper call makes: the nodes of these
    kernels in a CUDA graph, added at each of its replays
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
    """The counter of the CUDA function of this (mangled) name:
    ``propagate_candidates`` or ``propagate_merge``; None for any other
    function."""
    m = re.search(r"\d+(propagate_candidates|propagate_merge)E", kernel_name)
    return m.group(1) if m else None


def build() -> Path:
    """Compile ``csrc/propagate_kernel.cu`` unless a library of this exact
    source, headers and flag set is already built; returns its path."""
    return ops.build(SOURCE, "ellc_propagate")


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declares the C signature of ``ellc_propagate`` on a loaded
    library."""
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.ellc_propagate.argtypes = [p] * 17 + [i] * 5 + [f] * 13 + [p]
    lib.ellc_propagate.restype = i
    return lib


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        _lib = bind(ctypes.CDLL(str(build())))
    return _lib


def validity_cap(cfg: ELLCConfig) -> float:
    """The merged validity's upper clamp."""
    return cfg.validity_counter_max + cfg.validity_counter_max_variable


def _state(planes: Tuple[torch.Tensor, ...], shape) -> DepthMapState:
    return DepthMapState(*(p.reshape(shape) for p in planes))


def _inputs(state: DepthMapState, old_kf_image, new_kf_image,
            new_kf_maxgrad, pose) -> Tuple[Dict[str, torch.Tensor], int, int]:
    """The kernels' inputs by name, contiguous and checked, with the new
    keyframe's and the pose's strides (0: one for every state)."""
    shape = tuple(state.idepth.shape)
    if len(shape) not in (2, 3) or 0 in shape:
        raise ValueError(f"state planes of shape {shape}: (H, W) or "
                         f"(B, H, W) expected")
    H, W = shape[-2:]
    named = dict(idepth_smoothed=state.idepth_smoothed, idepth=state.idepth,
                 validity=state.validity, valid=state.valid,
                 old_kf_image=old_kf_image, new_kf_image=new_kf_image,
                 new_kf_maxgrad=new_kf_maxgrad, pose=pose)
    dev = state.idepth.device
    for name, t in named.items():
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, expected {dev}")
        want = torch.bool if name == "valid" else torch.float32
        if t.dtype != want:
            raise TypeError(f"{name} has dtype {t.dtype}, expected {want}")
        ok = {"pose": ((6,), shape[:-2] + (6,)),
              "new_kf_image": ((H, W), shape),
              "new_kf_maxgrad": ((H, W), shape)}.get(name, (shape,))
        if tuple(t.shape) not in ok:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                             f"one of {ok}")
    if new_kf_image.shape != new_kf_maxgrad.shape:
        raise ValueError("new_kf_image and new_kf_maxgrad differ in shape")
    if not 0 < state.idepth.numel() < 2 ** 31:
        raise ValueError(f"{state.idepth.numel()} cells: the kernels take "
                         f"1 to 2^31 - 1")
    new_stride = H * W if new_kf_image.dim() == len(shape) == 3 else 0
    pose_stride = 6 if pose.dim() == 2 else 0
    return ({k: t.contiguous() for k, t in named.items()}, new_stride,
            pose_stride)


def _launch(lib: ctypes.CDLL, state: DepthMapState, old_kf_image,
            new_kf_image, new_kf_maxgrad, pose, cfg: ELLCConfig,
            stream: int, out: Optional[DepthMapState] = None
            ) -> DepthMapState:
    """The memset and two launches of ``ellc_propagate`` on ``stream``
    over tensors of one device; returns the propagated state, written into
    ``out`` when given (contiguous planes of the state's shape)."""
    shape = tuple(state.idepth.shape)
    named, new_stride, pose_stride = _inputs(
        state, old_kf_image, new_kf_image, new_kf_maxgrad, pose)
    H, W = shape[-2:]
    B = state.idepth.numel() // (H * W)
    n = B * H * W
    dev = state.idepth.device
    head = torch.empty(n, dtype=torch.int32, device=dev)
    rec = torch.empty((n, 4), dtype=torch.float32, device=dev)
    if out is None:
        out = DepthMapState(
            *(torch.empty(shape, dtype=torch.float32, device=dev)
              for _ in range(5)),
            torch.empty(shape, dtype=torch.int32, device=dev),
            torch.empty(shape, dtype=torch.bool, device=dev))
    err = lib.ellc_propagate(
        *[ctypes.c_void_p(t.data_ptr()) for t in
          (*named.values(), head, rec,
           *(getattr(out, f) for f in FIELDS))],
        B, H, W, new_stride, pose_stride, cfg.fx, cfg.fy, cfg.cx, cfg.cy,
        division_reciprocal32(cfg.fx), division_reciprocal32(cfg.fy),
        W - 3.1, H - 3.1,
        cfg.max_diff_constant, cfg.max_diff_grad_mult,
        cfg.min_abs_grad_decrease, cfg.diff_fac_prop_merge,
        validity_cap(cfg), ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"propagate launch failed: cudaError {err}")
    return out


def propagate(state: DepthMapState, old_kf_image: torch.Tensor,
              new_kf_image: torch.Tensor, new_kf_maxgrad: torch.Tensor,
              pose_new_wrt_old: torch.Tensor, cfg: ELLCConfig
              ) -> DepthMapState:
    """``depth/propagate.py::propagate`` on CUDA tensors: one memset and
    two launches for one state (planes (H, W), pose (6,)) or a batch
    (planes and old keyframe images (B, H, W), poses (B, 6)), the new
    keyframe shared, (H, W), or one per state, (B, H, W)."""
    dev = state.idepth.device
    if dev.type != "cuda":
        raise ValueError(f"the propagate kernels take CUDA tensors, not "
                         f"{dev}")
    with torch.cuda.device(dev):
        out = _launch(_library(), state, old_kf_image, new_kf_image,
                      new_kf_maxgrad, pose_new_wrt_old, cfg,
                      torch.cuda.current_stream().cuda_stream)
    for k in KERNELS:
        _counts[k] += 1
    return out


def _winner(tgt, cand, idepth, var, n):
    """Per source: its cell's winning inverse depth and that winner's
    variance (the largest variance among the candidates equal to the
    winner, at least 0, NaN if one of them is NaN: torch's amax), and its
    ``flat_id`` (the inverse depth of a candidate, -inf otherwise)."""
    dev = tgt.device
    flat_id = torch.where(cand, idepth, float("-inf"))
    winner = torch.full((n,), float("-inf"), device=dev).scatter_reduce(
        0, tgt, flat_id, "amax", include_self=True)
    w_id = winner[tgt]
    at_w = flat_id == w_id
    # the NaN rule spelled out: amax's own NaN handling is the CPU's, and
    # the twin must give the same on the card
    w_var = torch.zeros((n,), device=dev).scatter_reduce(
        0, tgt, torch.where(at_w & ~var.isnan(), var, float("-inf")),
        "amax", include_self=True)
    nan_at_w = torch.zeros((n,), dtype=torch.int32, device=dev
                           ).scatter_reduce(0, tgt, (at_w & var.isnan()).to(
                               torch.int32), "amax", include_self=True)
    w_var = torch.where(nan_at_w > 0, float("nan"), w_var)
    return w_id, w_var[tgt], flat_id


def _compat(tgt, cand, idepth, var, cfg, n):
    w_id, w_var, flat_id = _winner(tgt, cand, idepth, var, n)
    diff = w_id - flat_id
    return cand & (cfg.diff_fac_prop_merge * diff * diff <= var + w_var)


def _terms(compat, idepth, var, validity):
    """The four summands of every source: 1/var, id/var, validity and 1
    where compatible, 0 elsewhere (the expressions of the merge before
    the kernel, so the CPU's bits)."""
    cvar = torch.where(torch.abs(var) > 1e-12, var, 1e-12)
    ivar = torch.where(compat, 1.0 / cvar, 0.0)
    safe_id = torch.where(compat, idepth, 0.0)
    return (ivar, ivar * safe_id, torch.where(compat, validity, 0.0),
            compat.to(torch.float32))


def _finish(sums, shape, cfg) -> DepthMapState:
    sum_ivar, sum_id, sum_validity, count = sums
    has = count > 0
    merged_id = torch.where(has, sum_id / torch.where(has, sum_ivar, 1.0),
                            0.0)
    merged_var = torch.where(has, 1.0 / torch.where(has, sum_ivar, 1.0), 0.0)
    merged_validity = torch.clamp_max(sum_validity, validity_cap(cfg))
    full = torch.full_like(merged_id, -1.0)
    return _state((merged_id, merged_var, full, full.clone(),
                   merged_validity, torch.zeros_like(sum_ivar,
                                                     dtype=torch.int32),
                   has), shape)


def plain_merge(tgt, cand, idepth, var, validity, shape,
                cfg: ELLCConfig) -> DepthMapState:
    """The plain twin of the merge, on any device: the same winner,
    compatibility and sums, each cell's compatible candidates added in
    ascending source index from +0.0.  On the CPU, ``index_add_`` adds
    that way (it runs sequentially), with no host read, so a step body
    stays capturable (``tests/test_torch_graphs.py``); on the card
    :func:`ranked_sums` does, the kernels' reference there."""
    n = tgt.numel()
    compat = _compat(tgt, cand, idepth, var, cfg, n)
    terms = _terms(compat, idepth, var, validity)
    if tgt.device.type == "cpu":
        sums = [torch.zeros((n,)).index_add_(0, tgt, t) for t in terms]
    else:
        sums = ranked_sums(tgt, compat, torch.stack(terms))
    return _finish(sums, shape, cfg)


def ranked_sums(tgt: torch.Tensor, compat: torch.Tensor,
                terms: torch.Tensor) -> torch.Tensor:
    """Per cell, the sums of ``terms`` (k, N) over its compatible sources
    in ascending source index, from +0.0, without a float atomic: the
    compatible sources are ranked within their cell (a stable sort by
    target), and rank 0, rank 1, ... of every cell are added one rank a
    step (within a rank every cell appears once, so no two adds meet).
    Reads the largest rank back to the host."""
    n = tgt.numel()
    src = compat.nonzero().squeeze(1)                   # ascending
    cell, order = torch.sort(tgt[src], stable=True)
    src = src[order]
    pos = torch.arange(src.numel(), device=tgt.device)
    starts = torch.ones_like(cell, dtype=torch.bool)
    starts[1:] = cell[1:] != cell[:-1]
    rank = pos - torch.where(starts, pos, 0).cummax(0).values
    sums = torch.zeros((terms.shape[0], n), device=tgt.device)
    for r in range(int(rank.max()) + 1 if src.numel() else 0):
        at = rank == r
        c = cell[at]
        sums[:, c] = sums[:, c] + terms[:, src[at]]
    return sums

