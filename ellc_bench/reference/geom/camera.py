"""Pinhole camera model: intrinsics, pixel grids, (back)projection and
undistortion.

Port of ``egomotion_with_local_loop_closures_tpu/geom/camera.py``: the
OpenCV 5-parameter radial/tangential model that ``cv::undistort`` applies
in ``src/Frame.cpp:86-96``.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

from ellc_bench.reference.image import interp


def division_reciprocal32(c: float) -> float:
    """1/c in float64, rounded once to float32: what ATen's CUDA kernels
    multiply a float32 tensor by to divide it by the Python scalar c
    (``t / c``, measured with PyTorch 2.11 and CUDA 12.8), where the CPU
    divides.  It can differ from float32(1) / float32(c) in the last
    place (c = 410.601403, the parity config's fx, is one).  Propagate's
    twin and kernels multiply by it on every device, so they keep the
    bits that ``t / c`` gives on the card."""
    return float(np.float32(1.0 / c))


@functools.lru_cache(maxsize=None)
def intrinsics_matrix(fx: float, fy: float, cx: float, cy: float,
                      device=None, dtype=torch.float32) -> torch.Tensor:
    """K as a (3, 3) tensor, made once per arguments (callers only read
    it), so that a step captured in a CUDA graph copies no host data to
    the card."""
    return torch.tensor([[fx, 0.0, cx], [0.0, fy, cy], [0.0, 0.0, 1.0]],
                        dtype=dtype, device=device)


def backproject(x: torch.Tensor, y: torch.Tensor, depth: torch.Tensor,
                fx: float, fy: float, cx: float, cy: float) -> torch.Tensor:
    """Pixel (x, y) + depth -> 3D point (..., 3) in the camera frame
    (PixelWisePyramid.cpp:236-238); the shared (H, W) pixel grid broadcasts
    against a stack of depth maps (..., H, W)."""
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


def distort_normalized(xn: torch.Tensor, yn: torch.Tensor,
                       dist: Tuple[float, float, float, float, float]
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The OpenCV 5-parameter model (k1, k2, p1, p2, k3) on normalized
    coordinates: ideal -> distorted."""
    k1, k2, p1, p2, k3 = dist
    r2 = xn * xn + yn * yn
    radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
    xd = xn * radial + 2.0 * p1 * xn * yn + p2 * (r2 + 2.0 * xn * xn)
    yd = yn * radial + p1 * (r2 + 2.0 * yn * yn) + 2.0 * p2 * xn * yn
    return xd, yd


def undistort_map(rows: int, cols: int,
                  fx: float, fy: float, cx: float, cy: float,
                  dist: Tuple[float, float, float, float, float],
                  device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Source coordinates (x_src, y_src) to sample the raw image at for
    each pixel of the undistorted image: cv::initUndistortRectifyMap with
    the new camera matrix equal to K (the JAX package's choice; the
    reference's getOptimalNewCameraMatrix(alpha=0) moves only the crop)."""
    x, y = pixel_grid(rows, cols, device=device)
    xd, yd = distort_normalized((x - cx) / fx, (y - cy) / fy, dist)
    return xd * fx + cx, yd * fy + cy


def undistort_image(image: torch.Tensor,
                    fx: float, fy: float, cx: float, cy: float,
                    dist: Tuple[float, float, float, float, float]
                    ) -> torch.Tensor:
    """Undistort an (H, W) image by bilinear resampling at the distorted
    source coordinates (cv::undistort, Frame.cpp:86-96); samples outside
    the image are 0, cv::remap's default border."""
    H, W = image.shape
    xs, ys = undistort_map(H, W, fx, fy, cx, cy, dist, device=image.device)
    return interp.bilinear_fill(image, xs, ys)
