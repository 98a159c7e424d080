"""The candidate merge of keyframe depth propagation as hand-written CUDA
kernels, summed in a fixed order.

``depth/propagate.py::propagate`` reprojects every hypothesis of the old
keyframe into the new keyframe's grid (plain ATen code) and hands the
result here: each source pixel's flat target cell, whether it is a
candidate, and its propagated inverse depth, variance and validity.  The
merge (the JAX package's ``depth/propagate.py:100-135``) keeps, per cell,
the nearest candidate and fuses every candidate compatible with it by
inverse variance.  The CUDA source is ``csrc/propagate_kernel.cu``: a
memset and two launches a call, ``propagate_link`` (a thread a source)
and ``propagate_merge`` (a thread a target), for one state or a batch;
what bounds it is written at the top of that file.

The sums run over each cell's compatible candidates in ascending source
index, from +0.0: the order of the CPU's sequential ``index_add_`` and of
the JAX package's scatter on the CPU.  So :func:`merge` gives the same
bits on the card as :func:`plain_merge`, its plain twin, and two runs on
the card give the same bits; float ``index_add_`` on CUDA (the merge
before this kernel) adds in atomic order, and two runs differed.

:func:`merge` runs :func:`plain_merge` for tensors on the CPU.  For CUDA
tensors it launches the kernels or raises; it never falls back.  Its
launches are counted in :data:`launches`, by kernel; a call made while a
CUDA graph captures launches nothing, so ``runtime/graphs.py`` counts
those calls apart with :func:`counting_into` and adds the graph's nodes
of these kernels at each replay.  Nothing here reads the card's values
back to the host, so a graph captures every call.
"""

from __future__ import annotations

import contextlib
import ctypes
import math
import re
from pathlib import Path
from typing import Dict, Iterator, Optional, Tuple

import torch

from egomotion_with_local_loop_closures_tpu_torch import ops
from egomotion_with_local_loop_closures_tpu_torch.config import ELLCConfig
from egomotion_with_local_loop_closures_tpu_torch.depth.state import (
    DepthMapState)

SOURCE: Path = ops.CSRC / "propagate_kernel.cu"

# Launches on the CUDA path since the last reset_launches(), by kernel:
# one of each a call.
launches: Dict[str, int] = {"propagate_link": 0, "propagate_merge": 0}
# Launches of the eager warm-ups before CUDA graph captures, kept apart
# from launches (runtime/graphs.py), since the last reset_launches().
warmup_launches: Dict[str, int] = {"propagate_link": 0, "propagate_merge": 0}
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
    ``propagate_link`` or ``propagate_merge``; None for any other
    function."""
    m = re.search(r"\d+(propagate_link|propagate_merge)E", kernel_name)
    return m.group(1) if m else None


def build() -> Path:
    """Compile ``csrc/propagate_kernel.cu`` unless a library of this exact
    source, headers and flag set is already built; returns its path."""
    return ops.build(SOURCE, "ellc_propagate")


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declares the C signature of ``ellc_propagate_merge`` on a loaded
    library."""
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.ellc_propagate_merge.argtypes = [p] * 14 + [i, f, f, p]
    lib.ellc_propagate_merge.restype = i
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


def _launch(lib: ctypes.CDLL, tgt, cand, idepth, var, validity, shape,
            cfg: ELLCConfig, stream: int) -> DepthMapState:
    """The memset and two launches of ``ellc_propagate_merge`` on
    ``stream`` over contiguous (N,) tensors of one device; returns the
    merged state of shape ``shape`` (N cells)."""
    n = tgt.numel()
    dev = tgt.device
    scratch = torch.empty((2, n), dtype=torch.int32, device=dev)
    out = (*(torch.empty(n, dtype=torch.float32, device=dev)
             for _ in range(5)),
           torch.empty(n, dtype=torch.int32, device=dev),
           torch.empty(n, dtype=torch.bool, device=dev))
    err = lib.ellc_propagate_merge(
        *[ctypes.c_void_p(t.data_ptr()) for t in
          (tgt, cand, idepth, var, validity, scratch[0], scratch[1], *out)],
        n, cfg.diff_fac_prop_merge, validity_cap(cfg),
        ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"propagate merge launch failed: cudaError {err}")
    return _state(out, shape)


def _check(named: Dict[str, torch.Tensor], shape) -> None:
    n = math.prod(shape)
    dev = named["tgt"].device
    if dev.type != "cuda":
        raise ValueError(f"the merge runs on CUDA tensors or CPU tensors, "
                         f"not {dev}")
    if not 0 < n < 2 ** 31:
        raise ValueError(f"{n} cells: the kernel takes 1 to 2^31 - 1")
    dtypes = dict(tgt=torch.int64, cand=torch.bool)
    for name, t in named.items():
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, expected {dev}")
        if t.dtype != dtypes.get(name, torch.float32):
            raise TypeError(f"{name} has dtype {t.dtype}, expected "
                            f"{dtypes.get(name, torch.float32)}")
        if tuple(t.shape) != (n,):
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                             f"({n},)")


def merge(tgt: torch.Tensor, cand: torch.Tensor, idepth: torch.Tensor,
          var: torch.Tensor, validity: torch.Tensor, shape,
          cfg: ELLCConfig) -> DepthMapState:
    """The merged state (planes of ``shape``, (H, W) or (B, H, W)) of N =
    prod(shape) sources, each given as (N,): its flat target cell ``tgt``
    (int64, in 0..N-1), whether it is a candidate (``cand``), and its
    propagated inverse depth, variance and validity.  The kernels for
    CUDA tensors, :func:`plain_merge` for CPU tensors."""
    if tgt.device.type == "cpu":
        return plain_merge(tgt, cand, idepth, var, validity, shape, cfg)
    named = dict(tgt=tgt, cand=cand, idepth=idepth, var=var,
                 validity=validity)
    named = {k: t.contiguous() for k, t in named.items()}
    _check(named, tuple(shape))
    with torch.cuda.device(tgt.device):
        out = _launch(_library(), *named.values(), shape, cfg,
                      torch.cuda.current_stream().cuda_stream)
    _counts["propagate_link"] += 1
    _counts["propagate_merge"] += 1
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
    """The plain twin of the kernels, on any device: the same winner,
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

