"""Dense depth-hypothesis state (structure of arrays over the pixel grid).

Port of ``egomotion_with_local_loop_closures_tpu/depth/state.py``: the
reference's per-pixel ``depthhypothesis`` structs
(``src/DepthHypothesis.h:14-40``) as (H, W) tensors, or (B, H, W) for
a batch of states (the connection-recovery trials, or one state per
video of the batched pipeline).  States are treated
as immutable: every function returns new tensors and never writes into
its inputs, so two states may share a tensor.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence, Tuple, Union

import torch

from ellc_bench.reference.config import ELLCConfig


@dataclasses.dataclass(frozen=True)
class DepthMapState:
    idepth: torch.Tensor           # (H, W) float32 inverse depth
    var: torch.Tensor              # (H, W) float32 variance
    idepth_smoothed: torch.Tensor  # (H, W) float32, -1 where unset
    var_smoothed: torch.Tensor     # (H, W) float32, -1 where unset
    validity: torch.Tensor         # (H, W) float32 validity counter
    blacklisted: torch.Tensor      # (H, W) int32
    valid: torch.Tensor            # (H, W) bool

    def replace(self, **kw) -> "DepthMapState":
        return dataclasses.replace(self, **kw)


FIELDS = tuple(f.name for f in dataclasses.fields(DepthMapState))


def empty(shape: Tuple[int, int], device=None) -> DepthMapState:
    f = torch.zeros(shape, dtype=torch.float32, device=device)
    return DepthMapState(
        idepth=f, var=f, idepth_smoothed=f - 1.0, var_smoothed=f - 1.0,
        validity=f, blacklisted=torch.zeros(shape, dtype=torch.int32,
                                            device=device),
        valid=torch.zeros(shape, dtype=torch.bool, device=device))


def _interior(H: int, W: int, b: int, device) -> torch.Tensor:
    m = torch.zeros((H, W), dtype=torch.bool, device=device)
    m[b:H - b, b:W - b].fill_(True)
    return m


def initialize_random(generator: Union[None, torch.Generator,
                                      Sequence[torch.Generator]],
                      max_grad: torch.Tensor,
                      cfg: ELLCConfig) -> DepthMapState:
    """Gradient-gated random init: invDepth ~ U[0.5, 1.5], var 0.125,
    validity 20, borders excluded (depthMap::initializeRandomly,
    DepthPropagation.cpp:83-184).

    With ``cfg.bootstrap_rng == "glibc"`` the draws replicate the reference
    bit for bit: the k-th gated pixel in raster order takes the k-th glibc
    ``rand()`` draw, and ``generator`` is ignored.  Otherwise the draws
    come from ``generator``, a CPU ``torch.Generator``: the values are the
    same on every device, but they are not the JAX package's bits for the
    same seed (``jax.random`` and torch use different generators).

    ``max_grad`` may be a stack (V, H, W), one map per video: then each
    video is initialized as it would be alone, ``generator`` is a sequence
    of V generators (one per video, as the JAX package's keys), and under
    glibc every video's raster rank starts at its own first pixel."""
    H, W = max_grad.shape[-2:]
    lead = max_grad.shape[:-2]
    dev = max_grad.device
    valid = _interior(H, W, 1, dev) & (max_grad > cfg.min_abs_grad_create)
    if cfg.bootstrap_rng == "glibc":
        from ellc_bench.reference import (
            glibc_rand)
        vals = torch.from_numpy(glibc_rand.glibc_unit_floats(H * W)).to(dev)
        rank = torch.cumsum(valid.reshape(lead + (-1,)).to(torch.int32),
                            -1) - 1
        u = vals[rank.clamp(0, H * W - 1).long()].reshape(max_grad.shape)
    elif lead:
        # host-side draws, one CPU generator per video (torch's default
        # generator for each when none is given)
        gens = ([None] * math.prod(lead) if generator is None
                else list(generator))
        u = torch.stack([torch.rand((H, W), generator=g, dtype=torch.float32)
                         for g in gens]).reshape(max_grad.shape).to(dev)
    else:
        u = torch.rand((H, W), generator=generator,
                       dtype=torch.float32).to(dev)
    idepth = 0.5 + 1.0 * u
    var = torch.full(max_grad.shape, cfg.var_random_init,
                     dtype=torch.float32, device=dev)
    return DepthMapState(
        idepth=torch.where(valid, idepth, 0.0),
        var=torch.where(valid, var, 0.0),
        idepth_smoothed=torch.where(valid, idepth, -1.0),
        var_smoothed=torch.where(valid, var, -1.0),
        validity=torch.where(valid, 20.0, 0.0).to(torch.float32),
        blacklisted=torch.zeros(max_grad.shape, dtype=torch.int32,
                                device=dev),
        valid=valid)


def from_depth(depth: torch.Tensor, var: torch.Tensor) -> DepthMapState:
    """Initialize from a saved depth/variance map
    (FLAG_REPLICATE_NEW_DEPTH, DepthPropagation.cpp:114-137).  ``depth``
    and ``var`` are (..., H, W)."""
    H, W = depth.shape[-2:]
    valid = _interior(H, W, 1, depth.device) & (depth > 0.0)
    idepth = torch.where(valid, 1.0 / torch.where(depth > 0, depth, 1.0), 0.0)
    var = var.to(torch.float32)
    return DepthMapState(
        idepth=idepth,
        var=torch.where(valid, var, 0.0),
        idepth_smoothed=torch.where(valid, idepth, -1.0),
        var_smoothed=torch.where(valid, var, -1.0),
        validity=torch.where(valid, 20.0, 0.0).to(torch.float32),
        blacklisted=torch.zeros(depth.shape, dtype=torch.int32,
                                device=depth.device),
        valid=valid)


def to_depth_image(state: DepthMapState, cfg: ELLCConfig
                   ) -> Tuple[DepthMapState, torch.Tensor, torch.Tensor]:
    """The (depth, var) level-0 maps for the tracker, with the 3-pixel
    border invalidated (depthMap::updateDepthImage,
    DepthPropagation.cpp:1254-1308), for one state or a batch."""
    H, W = state.valid.shape[-2:]
    valid = state.valid & _interior(H, W, cfg.border, state.valid.device)
    state = state.replace(valid=valid)
    usable = valid & (state.idepth_smoothed >= -0.05)
    denom = torch.where(torch.abs(state.idepth_smoothed) > 1e-12,
                        state.idepth_smoothed, 1e-12)
    depth = torch.where(usable, 1.0 / denom, 0.0)
    var = torch.where(usable, state.var_smoothed, -1.0)
    return state, depth, var


_PLANE = (-2, -1)


def seeds_percent(state: DepthMapState) -> torch.Tensor:
    """Depth-map occupancy in percent (DepthPropagation.cpp:1804-1830), one
    value per state of a batch."""
    return 100.0 * torch.mean(state.valid.to(torch.float32), dim=_PLANE)


def make_idepth_one(state: DepthMapState
                    ) -> Tuple[DepthMapState, torch.Tensor]:
    """Normalize mean smoothed inverse depth to 1; returns (state, rescale)
    (depthMap::makeInvDepthOne, DepthPropagation.cpp:1546-1587), one
    rescale per state of a batch."""
    v = state.valid
    num = torch.sum(v.to(torch.float32), dim=_PLANE)
    s = torch.sum(torch.where(v, state.idepth_smoothed, 0.0), dim=_PLANE)
    rescale = torch.where(torch.abs(s) > 1e-12, num / s, 1.0)
    r2 = (rescale * rescale)[..., None, None]
    rescale_px = rescale[..., None, None]
    return state.replace(
        idepth=torch.where(v, state.idepth * rescale_px, state.idepth),
        idepth_smoothed=torch.where(v, state.idepth_smoothed * rescale_px,
                                    state.idepth_smoothed),
        var=torch.where(v, state.var * r2, state.var),
        var_smoothed=torch.where(v, state.var_smoothed * r2,
                                 state.var_smoothed),
    ), rescale
