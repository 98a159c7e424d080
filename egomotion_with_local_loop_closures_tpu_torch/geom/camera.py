"""Pinhole camera model: intrinsics, pixel grids, (back)projection.

Port of ``egomotion_with_local_loop_closures_tpu/geom/camera.py`` (the
undistortion map is outside the port's slice).
"""

from __future__ import annotations

from typing import Tuple

import torch


def intrinsics_matrix(fx: float, fy: float, cx: float, cy: float,
                      device=None, dtype=torch.float32) -> torch.Tensor:
    return torch.tensor([[fx, 0.0, cx], [0.0, fy, cy], [0.0, 0.0, 1.0]],
                        dtype=dtype, device=device)


def backproject(x: torch.Tensor, y: torch.Tensor, depth: torch.Tensor,
                fx: float, fy: float, cx: float, cy: float) -> torch.Tensor:
    """Pixel (x, y) + depth -> 3D point (..., 3) in the camera frame
    (PixelWisePyramid.cpp:236-238)."""
    X = (x - cx) * depth / fx
    Y = (y - cy) * depth / fy
    return torch.stack([X, Y, depth], dim=-1)


def project(p: torch.Tensor, fx: float, fy: float, cx: float, cy: float,
            eps: float = 1e-10
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """3D point (..., 3) -> pixel (x, y) and the unzeroed depth (the UNZERO
    macro, ExternVariable.h:232)."""
    z = p[..., 2]
    z = torch.where(torch.abs(z) < eps, torch.where(z < 0, -eps, eps), z)
    x = p[..., 0] / z * fx + cx
    y = p[..., 1] / z * fy + cy
    return x, y, z


def pixel_grid(rows: int, cols: int, device=None, dtype=torch.float32
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dense (x, y) coordinate grids of shape (rows, cols)."""
    y = torch.arange(rows, dtype=dtype, device=device)[:, None].expand(
        rows, cols)
    x = torch.arange(cols, dtype=dtype, device=device)[None, :].expand(
        rows, cols)
    return x, y
