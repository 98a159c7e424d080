"""Image pyramids, gradients, and the dilated max-gradient map.

Port of ``egomotion_with_local_loop_closures_tpu/image/pyramid.py``
(``frame::constructImagePyramids`` / ``calculateGradient`` /
``buildMaxGradients``, ``src/Frame.cpp:170-285, 618-674``): a [1 4 6 4 1]/16
blur with edge replication, floor-halved level shapes, and one-sided
border gradients without the 0.5 factor.  Images are float32 in [0, 255],
(H, W) or a stack (..., H, W) (one image per video of a batched pipeline).
"""

from __future__ import annotations

from typing import List, Tuple

import torch

_G5 = (1.0 / 16.0, 4.0 / 16.0, 6.0 / 16.0, 4.0 / 16.0, 1.0 / 16.0)


def _sep_blur5(img: torch.Tensor) -> torch.Tensor:
    """Separable 5-tap Gaussian blur with edge replication over the last
    two axes."""
    k = _G5
    lead = img.shape[:-2]
    p = torch.cat([img[..., :1, :].expand(*lead, 2, -1), img,
                   img[..., -1:, :].expand(*lead, 2, -1)], dim=-2)
    img = (k[0] * p[..., :-4, :] + k[1] * p[..., 1:-3, :]
           + k[2] * p[..., 2:-2, :] + k[3] * p[..., 3:-1, :]
           + k[4] * p[..., 4:, :])
    p = torch.cat([img[..., :1].expand(*lead, -1, 2), img,
                   img[..., -1:].expand(*lead, -1, 2)], dim=-1)
    return (k[0] * p[..., :-4] + k[1] * p[..., 1:-3] + k[2] * p[..., 2:-2]
            + k[3] * p[..., 3:-1] + k[4] * p[..., 4:])


def pyr_down(img: torch.Tensor) -> torch.Tensor:
    """One pyramid level: Gaussian blur + 2x decimation, floor shapes."""
    H, W = img.shape[-2:]
    return _sep_blur5(img)[..., : (H // 2) * 2: 2,
                           : (W // 2) * 2: 2].contiguous()


def build_pyramid(img: torch.Tensor, num_levels: int) -> List[torch.Tensor]:
    """Image pyramid [level0 .. levelN-1] (Frame.cpp:170-182) of an (H, W)
    image or of a stack (..., H, W)."""
    out = [img]
    for _ in range(num_levels - 1):
        out.append(pyr_down(out[-1]))
    return out


def gradients(img: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Central differences 0.5*(I[x+1]-I[x-1]) inside; one-sided
    differences without the 0.5 factor on the first/last row and column
    (Frame.cpp:185-285).  ``img`` is (..., H, W)."""
    gx = torch.cat([img[..., 1:2] - img[..., 0:1],
                    0.5 * (img[..., 2:] - img[..., :-2]),
                    img[..., -1:] - img[..., -2:-1]], dim=-1)
    gy = torch.cat([img[..., 1:2, :] - img[..., 0:1, :],
                    0.5 * (img[..., 2:, :] - img[..., :-2, :]),
                    img[..., -1:, :] - img[..., -2:-1, :]], dim=-2)
    return gx, gy


def max_abs_gradient(gx: torch.Tensor, gy: torch.Tensor) -> torch.Tensor:
    """Gradient magnitude dilated by a 3x3 max over the interior; borders
    keep the raw magnitude (Frame.cpp:618-674).  ``gx``, ``gy`` are
    (..., H, W)."""
    mag = torch.sqrt(gx * gx + gy * gy)
    vert = torch.maximum(torch.maximum(mag[..., :-2, :], mag[..., 1:-1, :]),
                         mag[..., 2:, :])
    tmp = torch.cat([mag[..., :1, :], vert, mag[..., -1:, :]], dim=-2)
    horiz = torch.maximum(torch.maximum(tmp[..., :-2], tmp[..., 1:-1]),
                          tmp[..., 2:])
    out = mag.clone()
    out[..., 1:-1, 1:-1] = horiz[..., 1:-1, :]
    return out
