"""Depth/variance pyramid fusion.

Port of ``egomotion_with_local_loop_closures_tpu/depth/fusion.py``
(``depthMap::buildInvVarDepth``, ``src/DepthPropagation.cpp:1637-1719``):
each coarse cell fuses its 2x2 children by inverse variance in
inverse-depth space; with no valid child it gets depth 0 / var -1.

:func:`refresh_depth_pyramid`, the keyframe's refresh of every frame step
(``state.to_depth_image`` then :func:`build_depth_var_pyramid`), launches
the hand-written CUDA kernel of ``ops/depth_refresh_kernel.py`` for a CUDA
state and runs that plain composition for a CPU state.
"""

from __future__ import annotations

from typing import List, Tuple

import torch

from ellc_bench.reference.config import ELLCConfig
from ellc_bench.reference.depth import state as dstate


def _sum4(t: torch.Tensor) -> torch.Tensor:
    """The 2x2 children of (..., H2, 2, W2, 2) summed in one fixed order,
    (c00 + c01) + (c10 + c11): the CPU's order for ``sum(dim=(-3, -1))``
    and the kernel's."""
    return ((t[..., 0, :, 0] + t[..., 0, :, 1])
            + (t[..., 1, :, 0] + t[..., 1, :, 1]))


def fuse_level(depth: torch.Tensor, var: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One fusion step: (..., H, W) -> (..., H//2, W//2)."""
    H, W = depth.shape[-2:]
    lead = depth.shape[:-2]
    H2, W2 = H // 2, W // 2
    d = depth[..., : H2 * 2, : W2 * 2].reshape(lead + (H2, 2, W2, 2))
    v = var[..., : H2 * 2, : W2 * 2].reshape(lead + (H2, 2, W2, 2))
    valid = v > 0.0
    ivar = torch.where(valid, 1.0 / torch.where(valid, v, 1.0), 0.0)
    inv_d = torch.where(
        valid, 1.0 / torch.where(torch.abs(d) > 1e-12, d, 1e-12), 0.0)
    ivar_sum = _sum4(ivar)
    idepth_sum = _sum4(ivar * inv_d)
    num = _sum4(valid.to(depth.dtype))
    any_valid = num > 0
    depth_out = torch.where(
        any_valid, ivar_sum / torch.where(any_valid, idepth_sum, 1.0), 0.0)
    var_out = torch.where(
        any_valid, num / torch.where(any_valid, ivar_sum, 1.0), -1.0)
    return depth_out, var_out


def build_depth_var_pyramid(depth0: torch.Tensor, var0: torch.Tensor,
                            num_levels: int
                            ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """Full pyramid [level0..levelN-1] of one map (H, W) or a stack
    (..., H, W); level 0 is passed through."""
    depths, vars_ = [depth0], [var0]
    for _ in range(num_levels - 1):
        d, v = fuse_level(depths[-1], vars_[-1])
        depths.append(d)
        vars_.append(v)
    return depths, vars_


def refresh_depth_pyramid(st: dstate.DepthMapState, cfg: ELLCConfig
                          ) -> Tuple[dstate.DepthMapState, List[torch.Tensor],
                                     List[torch.Tensor]]:
    """updateDepthImage for the tracker: the state with its border masked
    out of ``valid`` (``state.to_depth_image``) and the depth and
    variance pyramids of its level-0 maps, ``cfg.num_levels`` levels, for
    one state or a batch.  The CUDA kernel for a CUDA state (one launch),
    :func:`plain_refresh_depth_pyramid` for a CPU state."""
    return plain_refresh_depth_pyramid(st, cfg)


def plain_refresh_depth_pyramid(st: dstate.DepthMapState, cfg: ELLCConfig
                                ) -> Tuple[dstate.DepthMapState,
                                           List[torch.Tensor],
                                           List[torch.Tensor]]:
    """:func:`refresh_depth_pyramid` in plain PyTorch, on any device."""
    st, depth0, var0 = dstate.to_depth_image(st, cfg)
    depths, vars_ = build_depth_var_pyramid(depth0, var0, cfg.num_levels)
    return st, depths, vars_
