"""Debug images: the reference's displayColourDepthMap and DisplayFunc
views, and its MATLAB trajectory plot, written as files.

Port of ``egomotion_with_local_loop_closures_tpu/utils/visualize.py``.
The reference renders (a) JET-coloured depth overlays
(``src/DepthPropagation.cpp:1160-1250``), (b) residual, warped and weight
views (``src/DisplayFunc.cpp:34-557``) and (c) trajectory plots
(``matlab_scripts/VisualizeTrajectory.m``), all with imshow/imwrite on the
host.  Here ``alignment_views`` warps on the tensors' device and only the
final arrays cross to the host; the colormap and the file output work on
numpy arrays.

The depth colormap follows the reference: ``uint8(depth*100)`` clamped at
255, JET applied, and the pixels of bucket 0 (JET(0), invalid depth)
replaced by the grayscale keyframe image (DepthPropagation.cpp:1176-1219).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from egomotion_with_local_loop_closures_tpu_torch.config import ELLCConfig
from egomotion_with_local_loop_closures_tpu_torch.geom import camera, lie
from egomotion_with_local_loop_closures_tpu_torch.image import interp


def jet_colormap(u8: np.ndarray) -> np.ndarray:
    """JET lookup for uint8 input, (...) -> (..., 3) RGB uint8: the
    piecewise-linear jet ramp that OpenCV's COLORMAP_JET interpolates
    (DepthPropagation.cpp:1189)."""
    x = np.asarray(u8, np.float32) / 255.0

    def ramp(c):
        return np.clip(1.5 - np.abs(4.0 * x - c), 0.0, 1.0)

    r, g, b = ramp(3.0), ramp(2.0), ramp(1.0)
    return (np.stack([r, g, b], axis=-1) * 255.0 + 0.5).astype(np.uint8)


def colour_depth_map(depth: np.ndarray, gray_image: np.ndarray) -> np.ndarray:
    """displayColourDepthMap (DepthPropagation.cpp:1160-1250): depth
    scaled by 100 into uint8, JET, and the invalid (bucket-0) pixels
    replaced by the grayscale keyframe image.  Returns (H, W, 3) RGB
    uint8."""
    d = np.asarray(depth, np.float32)
    u8 = np.minimum(d * 100.0, 255.0).astype(np.uint8)
    rgb = jet_colormap(u8)
    g = np.clip(np.asarray(gray_image, np.float32), 0, 255).astype(np.uint8)
    invalid = u8 == 0
    rgb[invalid] = np.stack([g, g, g], axis=-1)[invalid]
    return rgb


def normalize_view(img: np.ndarray, symmetric: bool = False) -> np.ndarray:
    """Scale a float image into uint8 for display (the reference's
    convertTo(..., 255/max) pattern, DisplayFunc.cpp)."""
    a = np.asarray(img, np.float32)
    if symmetric:
        m = max(float(np.abs(a).max()), 1e-12)
        return ((a / m) * 127.5 + 127.5).astype(np.uint8)
    lo, hi = float(a.min()), float(a.max())
    return ((a - lo) / max(hi - lo, 1e-12) * 255.0).astype(np.uint8)


def alignment_views(kf_image: torch.Tensor, kf_depth: torch.Tensor,
                    cur_image: torch.Tensor, pose: torch.Tensor,
                    cfg: ELLCConfig, level: int = 0
                    ) -> Dict[str, np.ndarray]:
    """Warped, residual and mask views of the current image against a
    keyframe at one pyramid level (DisplayFunc ``displayResidualImage`` /
    ``displayWarpedImage``, DisplayFunc.cpp:34-557), computed on the
    tensors' device.  Returns a dict of numpy arrays: "warped" (-1 where
    no sample), "residual" and "valid_mask"."""
    fx, fy, cx, cy = cfg.level_intrinsics(level)
    H, W = kf_image.shape
    x, y = camera.pixel_grid(H, W, device=kf_image.device)
    mask = kf_depth > 0.0
    T = lie.exp_se3(torch.as_tensor(pose, dtype=torch.float32,
                                    device=kf_image.device))
    P = camera.backproject(x, y, kf_depth, fx, fy, cx, cy)
    Pt = P @ T[:3, :3].T + T[:3, 3]
    wx, wy, _ = camera.project(Pt, fx, fy, cx, cy)
    warped, in_bounds = interp.bilinear(cur_image, wx, wy)
    valid = mask & in_bounds
    return {
        "warped": torch.where(valid, warped, -1.0).cpu().numpy(),
        "residual": torch.where(valid, warped - kf_image, 0.0).cpu().numpy(),
        "valid_mask": valid.cpu().numpy(),
    }


def save_image(path: str, img: np.ndarray) -> None:
    """Write a (H, W) grayscale or (H, W, 3) RGB image; a float image is
    scaled with ``normalize_view`` first."""
    from PIL import Image

    a = np.asarray(img)
    if a.dtype != np.uint8:
        a = normalize_view(a)
    Image.fromarray(a).save(path)


def plot_trajectory(world_poses: np.ndarray, path: str,
                    gt_poses: Optional[np.ndarray] = None,
                    quiver_every: int = 8) -> None:
    """Top-down trajectory plot: camera centres (-R^T t) and viewing
    directions, VisualizeTrajectory.m's scatter/quiver drawn with
    matplotlib (Agg, imported on first use)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    def centers_views(poses):
        T = lie.exp_se3(torch.as_tensor(np.asarray(poses, np.float32)))
        R, t = T[:, :3, :3], T[:, :3, 3]
        C = -torch.einsum("nji,nj->ni", R, t)
        return C.numpy(), R[:, 2, :].numpy()

    fig, ax = plt.subplots(figsize=(7, 6))
    C, V = centers_views(world_poses)
    ax.plot(C[:, 0], C[:, 2], "-", lw=1.2, label="estimate")
    ax.quiver(C[::quiver_every, 0], C[::quiver_every, 2],
              V[::quiver_every, 0], V[::quiver_every, 2],
              width=0.003, scale=25, alpha=0.6)
    if gt_poses is not None:
        G, _ = centers_views(gt_poses)
        ax.plot(G[:, 0], G[:, 2], "--", lw=1.0, label="ground truth")
    ax.set_xlabel("x")
    ax.set_ylabel("z")
    ax.set_aspect("equal", adjustable="datalim")
    ax.legend(loc="best")
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)


def dump_frame_debug(out_prefix: str, kf_image, kf_depth, cur_image,
                     pose, cfg: ELLCConfig) -> None:
    """One-call debug dump: the depth overlay, warped and residual PNGs,
    what the reference's FLAG_DISPLAY_* windows show, as files."""
    kf_image, kf_depth, cur_image = (
        torch.as_tensor(a, dtype=torch.float32)
        for a in (kf_image, kf_depth, cur_image))
    save_image(out_prefix + "_depth.png",
               colour_depth_map(kf_depth.cpu().numpy(),
                                kf_image.cpu().numpy()))
    views = alignment_views(kf_image, kf_depth, cur_image.to(kf_image.device),
                            pose, cfg)
    save_image(out_prefix + "_warped.png", normalize_view(views["warped"]))
    save_image(out_prefix + "_residual.png",
               normalize_view(views["residual"], symmetric=True))
