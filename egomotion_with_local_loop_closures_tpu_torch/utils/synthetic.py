"""Synthetic scenes with ground-truth poses and depth.

Port of ``egomotion_with_local_loop_closures_tpu/utils/synthetic.py``.
The world is a box room of textured planes (far wall, floor, ceiling and
side walls) rendered by casting one ray a pixel; the texture is a smooth
random Fourier series, so an image has no interpolation artefacts at any
resolution.  The scene, ``loop_trajectory`` and the velocities of
``trajectory`` come from numpy's ``default_rng`` and equal the JAX
package's bit for bit; the rendering and the pose chain run in PyTorch.

A pose ``xi`` is the se(3) twist ``poseWrtWorld`` of the rendered camera
(Frame.h:100-106): a point ``P`` of the world (camera 0's) frame is
``exp(xi) @ P`` in the rendered camera's frame.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from egomotion_with_local_loop_closures_tpu_torch.geom import camera, lie


class PlaneScene(NamedTuple):
    """K textured planes, host (numpy) arrays.  Plane k: points P with
    n_k . P = d_k in the world frame."""
    normals: np.ndarray    # (K, 3) unit normals
    offsets: np.ndarray    # (K,)   n.P = offset
    # texture per plane: value = mean + sum_m amp*cos(fu*u + fv*v + ph)
    tex_freq: np.ndarray   # (K, M, 2)
    tex_phase: np.ndarray  # (K, M)
    tex_amp: np.ndarray    # (K, M)
    tex_mean: np.ndarray   # (K,)
    tangent_u: np.ndarray  # (K, 3) texture axes in the world
    tangent_v: np.ndarray  # (K, 3)


def make_room_scene(seed: int = 0, num_harmonics: int = 24,
                    depth: float = 2.5, half_width: float = 3.0,
                    half_height: float = 2.0) -> PlaneScene:
    """A box room seen from inside: far wall at z=depth, floor and ceiling
    at y=±half_height, side walls at x=±half_width."""
    rng = np.random.default_rng(seed)
    normals = np.array(
        [[0.0, 0.0, 1.0],    # far wall
         [0.0, 1.0, 0.0],    # floor (y = +half_height; y is down in image)
         [0.0, -1.0, 0.0],   # ceiling
         [1.0, 0.0, 0.0],    # right wall
         [-1.0, 0.0, 0.0]],  # left wall
        np.float32)
    offsets = np.array([depth, half_height, half_height,
                        half_width, half_width], np.float32)
    K = len(normals)
    tangent_u = np.zeros((K, 3), np.float32)
    tangent_v = np.zeros((K, 3), np.float32)
    for k, n in enumerate(normals):
        a = np.array([1.0, 0.0, 0.0], np.float32)
        if abs(n[0]) > 0.9:
            a = np.array([0.0, 1.0, 0.0], np.float32)
        u = np.cross(n, a)
        u /= np.linalg.norm(u)
        tangent_u[k] = u
        tangent_v[k] = np.cross(n, u)
    # a natural-image-like 1/f spectrum: frequency magnitudes log-uniform
    # in [1.5, 55] rad per world unit with amplitude ~ f^-0.6
    fmag = np.exp(rng.uniform(np.log(1.5), np.log(55.0),
                              size=(K, num_harmonics))).astype(np.float32)
    ang = rng.uniform(0, 2 * np.pi, size=(K, num_harmonics)).astype(np.float32)
    freq = np.stack([fmag * np.cos(ang), fmag * np.sin(ang)], axis=-1)
    phase = rng.uniform(0, 2 * np.pi, size=(K, num_harmonics)).astype(np.float32)
    amp = (160.0 * fmag ** -0.6
           / np.sqrt(num_harmonics / 8.0)).astype(np.float32)
    mean = np.full((K,), 120.0, np.float32)
    return PlaneScene(normals, offsets, freq, phase, amp,
                      mean, tangent_u, tangent_v)


def render(scene: PlaneScene, pose_wrt_world: torch.Tensor,
           rows: int, cols: int,
           fx: float, fy: float, cx: float, cy: float
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Render (image, depth) seen by the camera at ``pose_wrt_world``
    (6,), or by a stack of cameras (..., 6) in one batched pass: images
    and depths (..., rows, cols) on the pose's device.

    Depth is the z-coordinate in the rendered camera's frame, the quantity
    the pipeline's inverse-depth filter estimates.  The nearest plane is
    the first of equal distances, as ``jnp.argmin`` takes it."""
    dev = pose_wrt_world.device
    pose = pose_wrt_world.to(torch.float32)

    def t(a):
        return torch.as_tensor(a, device=dev)

    T_cw = lie.exp_se3(pose)
    T_wc = lie.inv_se3_matrix(T_cw)                       # cam -> world
    R_wc = T_wc[..., None, None, :3, :3]                  # (..., 1, 1, 3, 3)
    o_world = T_wc[..., :3, 3]                            # (..., 3)
    x, y = camera.pixel_grid(rows, cols, device=dev)
    d_cam = torch.stack([(x - cx) / fx, (y - cy) / fy, torch.ones_like(x)],
                        -1)
    d_world = (R_wc @ d_cam[..., None])[..., 0]           # (..., H, W, 3)

    n = t(scene.normals)
    # intersect each plane: t = (offset - n.o) / (n.d), valid if t > eps
    denom = d_world @ n.T                                 # (..., H, W, K)
    num = t(scene.offsets) - o_world @ n.T                # (..., K)
    dist = num[..., None, None, :] / torch.where(torch.abs(denom) < 1e-9,
                                                 1e-9, denom)
    dist = torch.where(dist > 1e-4, dist, float("inf"))
    k_hit = torch.argmin(dist, dim=-1)                    # nearest plane
    t_hit = torch.gather(dist, -1, k_hit[..., None])[..., 0]
    P_world = o_world[..., None, None, :] + t_hit[..., None] * d_world

    # texture coordinates on the hit plane
    u = torch.sum(P_world * t(scene.tangent_u)[k_hit], dim=-1)
    v = torch.sum(P_world * t(scene.tangent_v)[k_hit], dim=-1)
    freq = t(scene.tex_freq)[k_hit]                       # (..., H, W, M, 2)
    arg = (freq[..., 0] * u[..., None] + freq[..., 1] * v[..., None]
           + t(scene.tex_phase)[k_hit])
    img = t(scene.tex_mean)[k_hit] + torch.sum(
        t(scene.tex_amp)[k_hit] * torch.cos(arg), dim=-1)
    img = torch.clamp(img, 0.0, 255.0)

    # depth: the z-coordinate of P in the rendered camera's frame
    z = (torch.sum(P_world * T_cw[..., None, None, 2, :3], dim=-1)
         + T_cw[..., 2, 3, None, None])
    return img, z


def trajectory(num_frames: int, seed: int = 0,
               rot_step: float = 0.004, trans_step: float = 0.02
               ) -> torch.Tensor:
    """A smooth random walk of poses (num_frames, 6) starting at identity,
    float32 on the CPU: the poseWrtWorld twist of each frame.  The
    velocities are a low-pass filtered numpy draw, chained with
    ``lie.compose``."""
    rng = np.random.default_rng(seed)
    vel = rng.normal(size=(num_frames, 6)).astype(np.float32)
    for i in range(1, num_frames):
        vel[i] = 0.9 * vel[i - 1] + 0.1 * vel[i]
    vel[:, :3] *= rot_step
    vel[:, 3:] *= trans_step
    poses = [torch.zeros(6)]
    for i in range(1, num_frames):
        poses.append(lie.compose(torch.from_numpy(vel[i]), poses[-1]))
    return torch.stack(poses)


def loop_trajectory(num_frames: int, seed: int = 0,
                    rot_amp: float = 0.10, trans_amp: float = 0.15,
                    base_period: float = 240.0) -> np.ndarray:
    """A bounded smooth trajectory for sequences of any length: a sum of
    low-frequency sinusoids at incommensurate periods per axis, so the
    camera oscillates inside the room and revisits earlier viewpoints.
    Returns (num_frames, 6) float32 poseWrtWorld twists starting at
    identity."""
    rng = np.random.default_rng(seed)
    t = np.arange(num_frames, dtype=np.float64)
    ratios = np.array([1.0, 1.37, 1.93, 2.41, 3.17, 3.89])
    phases = rng.uniform(0, 2 * np.pi, size=6)
    amps = np.array([rot_amp] * 3 + [trans_amp] * 3) \
        * rng.uniform(0.6, 1.0, size=6)
    w = 2 * np.pi * ratios / base_period
    xi = amps[None, :] * (np.sin(w[None, :] * t[:, None] + phases[None, :])
                          - np.sin(phases)[None, :])
    return xi.astype(np.float32)


def render_sequence(scene: PlaneScene, poses: torch.Tensor,
                    rows: int, cols: int,
                    fx: float, fy: float, cx: float, cy: float
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Every frame of a trajectory (N, 6) in one batched pass on the
    poses' device: (N, H, W) images and depths."""
    return render(scene, poses, rows, cols, fx, fy, cx, cy)
