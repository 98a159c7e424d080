"""Frozen copy of the plain twin of the port's keyframe-propagation merge
(``ops/propagate_kernel.py``): the winner, compatibility and sums, each
cell's compatible candidates added in ascending source index from +0.0.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ellc_bench.reference.config import ELLCConfig
from ellc_bench.reference.depth.state import DepthMapState


def validity_cap(cfg: ELLCConfig) -> float:
    """The merged validity's upper clamp."""
    return cfg.validity_counter_max + cfg.validity_counter_max_variable


def _state(planes: Tuple[torch.Tensor, ...], shape) -> DepthMapState:
    return DepthMapState(*(p.reshape(shape) for p in planes))


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

