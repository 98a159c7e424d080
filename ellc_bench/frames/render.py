"""The benchmark's frozen frame renderer: a box room of textured planes
seen from a camera on a random walk or a revisiting loop, with its
ground-truth poses.

A frozen copy of the port's ``utils/synthetic.py`` (the room, the
renderer, ``trajectory`` and ``loop_trajectory``) and of the scene kinds
of ``tools/make_reference_input.py`` (``build_scene_and_poses``), so that
later changes to the port cannot change the benchmark's traffic.  The
pose algebra is the plain reference's (``ellc_bench/reference/geom``).

A pose ``xi`` is the se(3) twist ``poseWrtWorld`` of the rendered camera:
a point ``P`` of the world (camera 0's) frame is ``exp(xi) @ P`` in the
rendered camera's frame.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from ellc_bench.reference.geom import camera, lie


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
                    half_height: float = 2.0,
                    freq_range: Tuple[float, float] = (1.5, 55.0),
                    contrast: float = 1.0) -> PlaneScene:
    """A box room seen from inside: far wall at z=depth, floor and ceiling
    at y=±half_height, side walls at x=±half_width.  ``freq_range`` (rad
    per world unit) and ``contrast`` (a factor on every amplitude) shape
    the texture; at their defaults the room is the port's."""
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
    # in freq_range ([1.5, 55] rad per world unit) with amplitude ~ f^-0.6
    fmag = np.exp(rng.uniform(np.log(freq_range[0]), np.log(freq_range[1]),
                              size=(K, num_harmonics))).astype(np.float32)
    ang = rng.uniform(0, 2 * np.pi, size=(K, num_harmonics)).astype(np.float32)
    freq = np.stack([fmag * np.cos(ang), fmag * np.sin(ang)], axis=-1)
    phase = rng.uniform(0, 2 * np.pi, size=(K, num_harmonics)).astype(np.float32)
    amp = (contrast * 160.0 * fmag ** -0.6
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


def trajectories(num_frames: int, seeds, rot_step: float = 0.004,
                 trans_step: float = 0.02) -> torch.Tensor:
    """``trajectory`` for each seed of ``seeds``, (len(seeds), num_frames,
    6), chained for all seeds at once: each video's poses are
    ``trajectory(num_frames, seed)``'s bit for bit (the compose works entry
    by entry), in a 256th of the calls for 256 videos."""
    vel = []
    for seed in seeds:
        rng = np.random.default_rng(seed)
        v = rng.normal(size=(num_frames, 6)).astype(np.float32)
        for i in range(1, num_frames):
            v[i] = 0.9 * v[i - 1] + 0.1 * v[i]
        v[:, :3] *= rot_step
        v[:, 3:] *= trans_step
        vel.append(v)
    vel = torch.from_numpy(np.stack(vel))
    poses = [torch.zeros((len(vel), 6))]
    for i in range(1, num_frames):
        poses.append(lie.compose(vel[:, i], poses[-1]))
    return torch.stack(poses, 1)


def build_scenes_and_poses(scene_kind: str, seed_pairs, frames: int,
                           rot_step: float = 0.0015, trans_step: float = 0.02,
                           rot_amp: float = 0.08, trans_amp: float = 0.12,
                           texture: dict = None
                           ) -> Tuple[list, torch.Tensor]:
    """The scene kinds of the port's ``tools/make_reference_input.py``:
    the room of depth 1.25, half-width 1.7 and half-height 1.15, seen on

    - ``base``: a smooth random walk (``rot_step``, ``trans_step``);
    - ``fastrot``: the same walk with 3x the rotational velocity;
    - ``revisit``: the bounded ``loop_trajectory`` (``rot_amp``,
      ``trans_amp``), which revisits earlier views.

    One video for each (scene seed, trajectory seed) of ``seed_pairs``;
    ``texture`` holds ``make_room_scene``'s texture arguments
    (``num_harmonics``, ``freq_range``, ``contrast``), the port's where
    absent.  Returns the scenes and the (videos, frames, 6) float32 poses
    on the CPU."""
    scenes = [make_room_scene(seed=int(s), depth=1.25, half_width=1.7,
                              half_height=1.15, **(texture or {}))
              for s, _ in seed_pairs]
    traj = [int(t) for _, t in seed_pairs]
    if scene_kind in ("base", "fastrot"):
        poses = trajectories(frames, traj, rot_step=rot_step * (
            3.0 if scene_kind == "fastrot" else 1.0), trans_step=trans_step)
    elif scene_kind == "revisit":
        poses = torch.stack([torch.from_numpy(loop_trajectory(
            frames, seed=t, rot_amp=rot_amp, trans_amp=trans_amp))
            for t in traj])
    else:
        raise ValueError(f"unknown scene kind {scene_kind!r}")
    return scenes, poses


def render_frames(scene: PlaneScene, poses: torch.Tensor, rows: int,
                  cols: int, intrinsics: Tuple[float, float, float, float],
                  device, chunk: int = 32) -> torch.Tensor:
    """The (N, rows, cols) float32 images of ``poses`` (N, 6), rendered on
    ``device`` ``chunk`` frames a call (the renderer's intermediates hold
    some 25 MB a frame at 480x270)."""
    poses = poses.to(device=device, dtype=torch.float32)
    out = torch.empty((poses.shape[0], rows, cols), dtype=torch.float32,
                      device=device)
    for i in range(0, poses.shape[0], chunk):
        out[i:i + chunk] = render(scene, poses[i:i + chunk], rows, cols,
                                  *intrinsics)[0]
    return out
