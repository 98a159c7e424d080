"""Image pyramids, gradients, and the dilated max-gradient map.

Port of ``egomotion_with_local_loop_closures_tpu/image/pyramid.py``
(``frame::constructImagePyramids`` / ``calculateGradient`` /
``buildMaxGradients``, ``src/Frame.cpp:170-285, 618-674``): a [1 4 6 4 1]/16
blur with edge replication, floor-halved level shapes, and one-sided
border gradients without the 0.5 factor.  Images are float32 in [0, 255],
(H, W) or a stack (..., H, W) (one image per video of a batched pipeline).
``rgb_to_gray`` and ``resize_quarter`` prepare a decoded frame as the
reference does (Frame.cpp:60-83).

For CUDA tensors :func:`build_levels`, :func:`build_pyramid`,
:func:`gradients` and :func:`max_abs_gradient` launch the hand-written
kernel of ``ops/pyramid_kernel.py`` (one launch for a frame's four
levels, bit-equal to the plain code); for CPU tensors they run their plain twins, the ``plain_*``
functions here.  :func:`build_levels` gives a frame's whole pyramid with
every level's gradients (and the level-0 max-gradient map) from one call.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

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


class Levels(NamedTuple):
    """A frame's pyramid with every level's gradients and, when asked,
    the level-0 max-gradient map."""
    images: Tuple[torch.Tensor, ...]
    gradx: Tuple[torch.Tensor, ...]
    grady: Tuple[torch.Tensor, ...]
    maxgrad: Optional[torch.Tensor]


def build_levels(img: torch.Tensor, num_levels: int,
                 max_grad: bool = False) -> Levels:
    """The pyramid of an (H, W) image or a stack (..., H, W), each level's
    gradients and, with ``max_grad``, level 0's max-gradient map: the CUDA
    kernel for a CUDA tensor (one launch), :func:`plain_build_levels`
    for a CPU tensor."""
    return plain_build_levels(img, num_levels, max_grad)


def plain_build_levels(img: torch.Tensor, num_levels: int,
                       max_grad: bool = False) -> Levels:
    """:func:`build_levels` in plain PyTorch, on any device."""
    imgs = plain_build_pyramid(img, num_levels)
    grads = [plain_gradients(i) for i in imgs]
    return Levels(tuple(imgs), tuple(g[0] for g in grads),
                  tuple(g[1] for g in grads),
                  plain_max_abs_gradient(*grads[0]) if max_grad else None)


def build_pyramid(img: torch.Tensor, num_levels: int) -> List[torch.Tensor]:
    """Image pyramid [level0 .. levelN-1] (Frame.cpp:170-182) of an (H, W)
    image or of a stack (..., H, W): the CUDA kernel for a CUDA tensor,
    :func:`plain_build_pyramid` for a CPU tensor."""
    return plain_build_pyramid(img, num_levels)


def plain_build_pyramid(img: torch.Tensor, num_levels: int
                        ) -> List[torch.Tensor]:
    """:func:`build_pyramid` in plain PyTorch, on any device."""
    out = [img]
    for _ in range(num_levels - 1):
        out.append(pyr_down(out[-1]))
    return out


def gradients(img: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Central differences 0.5*(I[x+1]-I[x-1]) inside; one-sided
    differences without the 0.5 factor on the first/last row and column
    (Frame.cpp:185-285).  ``img`` is (..., H, W).  The CUDA kernel for a
    CUDA tensor, :func:`plain_gradients` for a CPU tensor."""
    return plain_gradients(img)


def plain_gradients(img: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`gradients` in plain PyTorch, on any device."""
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
    (..., H, W).  The CUDA kernel for CUDA tensors,
    :func:`plain_max_abs_gradient` for CPU tensors."""
    return plain_max_abs_gradient(gx, gy)


def plain_max_abs_gradient(gx: torch.Tensor, gy: torch.Tensor
                           ) -> torch.Tensor:
    """:func:`max_abs_gradient` in plain PyTorch, on any device.  The
    square root is taken in float64 and rounded once: the correctly
    rounded float32 value, the kernel's ``sqrtf``, which the CPU's float32
    ``torch.sqrt`` does not always give."""
    mag = torch.sqrt((gx * gx + gy * gy).double()).to(gx.dtype)
    vert = torch.maximum(torch.maximum(mag[..., :-2, :], mag[..., 1:-1, :]),
                         mag[..., 2:, :])
    tmp = torch.cat([mag[..., :1, :], vert, mag[..., -1:, :]], dim=-2)
    horiz = torch.maximum(torch.maximum(tmp[..., :-2], tmp[..., 1:-1]),
                          tmp[..., 2:])
    out = mag.clone()
    out[..., 1:-1, 1:-1] = horiz[..., 1:-1, :]
    return out


def rgb_to_gray(rgb: torch.Tensor) -> torch.Tensor:
    """RGB (..., 3) in [0, 255] -> gray float32 with OpenCV's CV_BGR2GRAY
    weights (Frame.cpp:83), channels in RGB order."""
    w = torch.tensor([0.299, 0.587, 0.114], dtype=torch.float32,
                     device=rgb.device)
    return torch.tensordot(rgb.to(torch.float32), w, dims=([-1], [0]))


def resize_quarter(img: torch.Tensor) -> torch.Tensor:
    """4x area downsample of (H, W): the mean of each 4x4 block, rows and
    columns past a multiple of 4 dropped (the reference's 1920x1080 ->
    480x270 resize at scale 0.25)."""
    H, W = img.shape
    H4, W4 = (H // 4) * 4, (W // 4) * 4
    return img[:H4, :W4].reshape(H4 // 4, 4, W4 // 4, 4).mean(dim=(1, 3))
