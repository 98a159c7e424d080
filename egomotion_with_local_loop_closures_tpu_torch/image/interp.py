"""Dense bilinear sampling with the reference's out-of-bounds semantics.

Port of ``bilinear`` and ``bilinear_fill`` from
``egomotion_with_local_loop_closures_tpu/image/interp.py``
(``frame::getInterpolatedElement``, ``src/Frame.h:181-394``): each corner
outside the image contributes 0, and a sample is out of bounds only when
all four corners are outside.  The TPU's window sampler and packed
gathers have no counterpart here: the port samples exactly.
"""

from __future__ import annotations

from typing import Tuple

import torch


def _to_index(v: torch.Tensor, n: int) -> torch.Tensor:
    """Integral float coordinate -> int32 index.  Clamping to [-1, n]
    first keeps every out-of-range (or NaN) value out of range without
    relying on what a float-to-int cast does past the int32 range."""
    return torch.clamp(v, -1.0, float(n)).to(torch.int32)


def bilinear(img: torch.Tensor, x: torch.Tensor, y: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sample ``img`` (H, W) at float coords ``x``, ``y`` (any shape).

    Returns ``(value, in_bounds)``; ``in_bounds`` is False only when all
    four corners are outside (Frame.h:267-270)."""
    H, W = img.shape
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    wx = x - x0
    wy = y - y0
    x0i = _to_index(x0, W)
    y0i = _to_index(y0, H)
    # the reference computes ceil(x): for integral x, ceil == floor
    x1i = _to_index(torch.ceil(x), W)
    y1i = _to_index(torch.ceil(y), H)
    flat = img.reshape(-1)

    def corner(xi, yi):
        ok = (xi >= 0) & (xi <= W - 1) & (yi >= 0) & (yi <= H - 1)
        idx = yi.clamp(0, H - 1) * W + xi.clamp(0, W - 1)
        v = flat[idx.reshape(-1).long()].reshape(idx.shape)
        return torch.where(ok, v, 0.0), ok

    v00, m00 = corner(x0i, y0i)
    v01, m01 = corner(x1i, y0i)
    v10, m10 = corner(x0i, y1i)
    v11, m11 = corner(x1i, y1i)

    top = (1.0 - wx) * v00 + wx * v01
    bottom = (1.0 - wx) * v10 + wx * v11
    value = (1.0 - wy) * top + wy * bottom
    return value, m00 | m01 | m10 | m11


def bilinear_fill(img: torch.Tensor, x: torch.Tensor, y: torch.Tensor
                  ) -> torch.Tensor:
    """Bilinear sample with zero-fill, no validity mask (Frame.h:283-394)."""
    return bilinear(img, x, y)[0]
