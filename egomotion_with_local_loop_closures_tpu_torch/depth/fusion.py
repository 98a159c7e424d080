"""Depth/variance pyramid fusion.

Port of ``egomotion_with_local_loop_closures_tpu/depth/fusion.py``
(``depthMap::buildInvVarDepth``, ``src/DepthPropagation.cpp:1637-1719``):
each coarse cell fuses its 2x2 children by inverse variance in
inverse-depth space; with no valid child it gets depth 0 / var -1.
"""

from __future__ import annotations

from typing import List, Tuple

import torch


def fuse_level(depth: torch.Tensor, var: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One fusion step: (H, W) -> (H//2, W//2)."""
    H, W = depth.shape
    H2, W2 = H // 2, W // 2
    d = depth[: H2 * 2, : W2 * 2].reshape(H2, 2, W2, 2)
    v = var[: H2 * 2, : W2 * 2].reshape(H2, 2, W2, 2)
    valid = v > 0.0
    ivar = torch.where(valid, 1.0 / torch.where(valid, v, 1.0), 0.0)
    inv_d = torch.where(
        valid, 1.0 / torch.where(torch.abs(d) > 1e-12, d, 1e-12), 0.0)
    ivar_sum = ivar.sum(dim=(1, 3))
    idepth_sum = (ivar * inv_d).sum(dim=(1, 3))
    num = valid.sum(dim=(1, 3)).to(depth.dtype)
    any_valid = num > 0
    depth_out = torch.where(
        any_valid, ivar_sum / torch.where(any_valid, idepth_sum, 1.0), 0.0)
    var_out = torch.where(
        any_valid, num / torch.where(any_valid, ivar_sum, 1.0), -1.0)
    return depth_out, var_out


def build_depth_var_pyramid(depth0: torch.Tensor, var0: torch.Tensor,
                            num_levels: int
                            ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """Full pyramid [level0..levelN-1]; level 0 is passed through."""
    depths, vars_ = [depth0], [var0]
    for _ in range(num_levels - 1):
        d, v = fuse_level(depths[-1], vars_[-1])
        depths.append(d)
        vars_.append(v)
    return depths, vars_
