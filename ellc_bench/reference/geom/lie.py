"""se(3)/SO(3) Lie-group operations in closed form (Rodrigues).

Port of ``egomotion_with_local_loop_closures_tpu/geom/lie.py``.  Twist
layout ``xi = [wx, wy, wz, vx, vy, vz]``, SE3 = expm(hat(xi)) as in the
reference (``src/Frame.cpp:384``).  Every function works on the trailing
dimensions and takes any leading batch dimensions.

:func:`compose` and :func:`relative` launch the hand-written CUDA kernel
of ``ops/se3_kernel.py`` for CUDA tensors (one launch for all poses) and
run their plain twins, :func:`plain_compose` and :func:`plain_relative`,
for CPU tensors.
"""

from __future__ import annotations

import math

import torch


_EPS = 1e-8
# Small-angle threshold on theta^2 for the sinc-family Taylor branches
# (see the JAX module: 1 - cos(theta) cancels in float32 below ~3e-3).
_THETA2_SMALL = 1e-4


def hat_so3(w: torch.Tensor) -> torch.Tensor:
    """[w]_x for w of shape (..., 3) -> (..., 3, 3)."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = torch.zeros_like(wx)
    return torch.stack([
        torch.stack([z, -wz, wy], dim=-1),
        torch.stack([wz, z, -wx], dim=-1),
        torch.stack([-wy, wx, z], dim=-1),
    ], dim=-2)


def vee_so3(W: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`hat_so3`: (..., 3, 3) -> (..., 3)."""
    return torch.stack([W[..., 2, 1], W[..., 0, 2], W[..., 1, 0]], dim=-1)


def _norm2(w: torch.Tensor) -> torch.Tensor:
    """|w|^2 of (..., 3) as (w0 w0 + w1 w1) + w2 w2."""
    return ((w[..., 0] * w[..., 0] + w[..., 1] * w[..., 1])
            + w[..., 2] * w[..., 2])


def _over(x: torch.Tensor, c: float) -> torch.Tensor:
    """x / c as a true division on every device (ATen's CUDA division by a
    Python scalar multiplies by the float32 reciprocal instead)."""
    return x / torch.full_like(x, c)


def _sinc_coeffs(theta2: torch.Tensor):
    """(A, B, C) = (sin t / t, (1-cos t)/t^2, (t - sin t)/t^3), with
    Taylor fallbacks near zero."""
    small = theta2 < _THETA2_SMALL
    t2s = torch.where(small, 1.0, theta2)
    ts = torch.sqrt(t2s)
    s = torch.sin(ts)
    A = torch.where(small, 1.0 - _over(theta2, 6.0), s / ts)
    B = torch.where(small, 0.5 - _over(theta2, 24.0),
                    (1.0 - torch.cos(ts)) / t2s)
    C = torch.where(small, 1.0 / 6.0 - _over(theta2, 120.0),
                    (ts - s) / (t2s * ts))
    return A, B, C


def _eye3(like: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=like.dtype, device=like.device).expand(like.shape)


def mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` for small matrices over broadcast leading dimensions, entry
    by entry: (a_i0 b_0j + a_i1 b_1j) + ... in order of the inner index.
    Each pose of a stack (the videos of the batched pipeline) gets the bits
    it gets alone, and on the card these are the bits of the hand-written
    kernels' products (``csrc/ellc_device.cuh``), which a cuBLAS product,
    rounding with fused multiply-adds, would not give.  On the CPU they are
    also ``torch.bmm``'s."""
    out = a[..., :, 0, None] * b[..., None, 0, :]
    for k in range(1, a.shape[-1]):
        out = out + a[..., :, k, None] * b[..., None, k, :]
    return out


def _matvec(M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return mm(M, v.unsqueeze(-1)).squeeze(-1)


def exp_so3(w: torch.Tensor) -> torch.Tensor:
    """SO(3) exponential: (..., 3) -> (..., 3, 3).  R = I + A [w]x + B [w]x^2."""
    theta2 = _norm2(w)
    A, B, _ = _sinc_coeffs(theta2)
    W = hat_so3(w)
    W2 = mm(W, W)
    return _eye3(W) + A[..., None, None] * W + B[..., None, None] * W2


def log_so3(R: torch.Tensor) -> torch.Tensor:
    """SO(3) logarithm: (..., 3, 3) -> (..., 3), via the quaternion."""
    return log_quat(quat_from_matrix(R))


def exp_se3(xi: torch.Tensor) -> torch.Tensor:
    """SE(3) exponential of a twist (..., 6) -> (..., 4, 4):
    R = exp([w]x), t = V v with V = I + B [w]x + C [w]x^2."""
    w, v = xi[..., :3], xi[..., 3:]
    theta2 = _norm2(w)
    A, B, C = _sinc_coeffs(theta2)
    W = hat_so3(w)
    W2 = mm(W, W)
    eye = _eye3(W)
    R = eye + A[..., None, None] * W + B[..., None, None] * W2
    V = eye + B[..., None, None] * W + C[..., None, None] * W2
    t = _matvec(V, v)
    top = torch.cat([R, t[..., :, None]], dim=-1)
    bottom = torch.zeros_like(top[..., :1, :])
    bottom[..., 0, 3].fill_(1.0)
    return torch.cat([top, bottom], dim=-2)


def log_se3(T: torch.Tensor) -> torch.Tensor:
    """SE(3) logarithm: (..., 4, 4) -> twist (..., 6);
    v = V^-1 t with V^-1 = I - 1/2 [w]x + (1/t^2)(1 - A/(2B)) [w]x^2."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    w = log_so3(R)
    theta2 = _norm2(w)
    A, B, _ = _sinc_coeffs(theta2)
    small = theta2 < _THETA2_SMALL
    t2s = torch.where(small, 1.0, theta2)
    D = torch.where(small, 1.0 / 12.0 + _over(theta2, 720.0),
                    (1.0 - A / (2.0 * B)) / t2s)
    W = hat_so3(w)
    W2 = mm(W, W)
    Vinv = _eye3(W) - 0.5 * W + D[..., None, None] * W2
    return torch.cat([w, _matvec(Vinv, t)], dim=-1)


def inv_se3_matrix(T: torch.Tensor) -> torch.Tensor:
    """Inverse of an SE(3) matrix without a linear solve."""
    Rt = T[..., :3, :3].transpose(-1, -2)
    tt = -_matvec(Rt, T[..., :3, 3])
    top = torch.cat([Rt, tt[..., :, None]], dim=-1)
    bottom = torch.zeros_like(top[..., :1, :])
    bottom[..., 0, 3].fill_(1.0)
    return torch.cat([top, bottom], dim=-2)


def compose(xi_1wrt2: torch.Tensor, xi_2wrt3: torch.Tensor) -> torch.Tensor:
    """log(exp(xi_1wrt2) @ exp(xi_2wrt3)) (frame::concatenateRelativePose,
    src/Frame.cpp:503-530): the CUDA kernel for CUDA tensors (float32),
    :func:`plain_compose` for CPU tensors."""
    return plain_compose(xi_1wrt2, xi_2wrt3)


def relative(xi_1wrt0: torch.Tensor, xi_2wrt0: torch.Tensor) -> torch.Tensor:
    """log(exp(xi_1wrt0) @ exp(xi_2wrt0)^-1) (frame::concatenateOriginPose,
    src/Frame.cpp:534-562): the CUDA kernel for CUDA tensors (float32),
    :func:`plain_relative` for CPU tensors."""
    return plain_relative(xi_1wrt0, xi_2wrt0)


def plain_compose(xi_1wrt2: torch.Tensor, xi_2wrt3: torch.Tensor
                  ) -> torch.Tensor:
    """:func:`compose` in plain PyTorch on any device and dtype: the twin
    of ``csrc/se3_kernel.cu``."""
    return log_se3(mm(exp_se3(xi_1wrt2), exp_se3(xi_2wrt3)))


def plain_relative(xi_1wrt0: torch.Tensor, xi_2wrt0: torch.Tensor
                   ) -> torch.Tensor:
    """:func:`relative` in plain PyTorch on any device and dtype."""
    return log_se3(mm(exp_se3(xi_1wrt0), inv_se3_matrix(exp_se3(xi_2wrt0))))


def inverse(xi: torch.Tensor) -> torch.Tensor:
    """log(exp(xi)^-1) == -xi exactly (frame::calculateInvLiePose)."""
    return -xi


def quat_from_matrix(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix -> unit quaternion (..., 4), scalar-first, by the
    Shepperd pivot construction (see the JAX module for why)."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    def safe_sqrt(a):
        return torch.sqrt(torch.clamp_min(a, 1e-12))

    S0 = safe_sqrt(1.0 + tr) * 2.0
    q0 = torch.stack([S0 / 4.0, (m21 - m12) / S0, (m02 - m20) / S0,
                      (m10 - m01) / S0], dim=-1)
    S1 = safe_sqrt(1.0 + m00 - m11 - m22) * 2.0
    q1 = torch.stack([(m21 - m12) / S1, S1 / 4.0, (m01 + m10) / S1,
                      (m02 + m20) / S1], dim=-1)
    S2 = safe_sqrt(1.0 - m00 + m11 - m22) * 2.0
    q2 = torch.stack([(m02 - m20) / S2, (m01 + m10) / S2, S2 / 4.0,
                      (m12 + m21) / S2], dim=-1)
    S3 = safe_sqrt(1.0 - m00 - m11 + m22) * 2.0
    q3 = torch.stack([(m10 - m01) / S3, (m02 + m20) / S3, (m12 + m21) / S3,
                      S3 / 4.0], dim=-1)

    case = torch.argmax(torch.stack([tr, m00, m11, m22], dim=-1), dim=-1)
    q = torch.where((case == 0)[..., None], q0,
                    torch.where((case == 1)[..., None], q1,
                                torch.where((case == 2)[..., None], q2, q3)))
    q = q * torch.where(q[..., :1] < 0, -1.0, 1.0)
    n = torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    return q / torch.clamp_min(n, _EPS)


def quat_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamilton product a*b, scalar-first."""
    aw, ax, ay, az = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bw, bx, by, bz = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return torch.stack([
        aw * bw - ax * bx - ay * by - az * bz,
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
    ], dim=-1)


def quat_conj(q: torch.Tensor) -> torch.Tensor:
    return q * torch.tensor([1.0, -1.0, -1.0, -1.0], dtype=q.dtype,
                            device=q.device)


def log_quat(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion -> rotation vector (..., 3), angle in (-pi, pi]."""
    s = torch.linalg.vector_norm(q[..., 1:], dim=-1)
    theta = 2.0 * torch.atan2(s, q[..., 0])
    theta = torch.where(theta >= math.pi, theta - 2.0 * math.pi, theta)
    theta = torch.where(theta < -math.pi, theta + 2.0 * math.pi, theta)
    scale = torch.where(s < _EPS, 2.0, theta / torch.clamp_min(s, _EPS))
    return q[..., 1:] * scale[..., None]


def exp_quat(w: torch.Tensor) -> torch.Tensor:
    """Rotation vector -> unit quaternion (..., 4), scalar-first."""
    theta = torch.linalg.vector_norm(w, dim=-1)
    half = theta / 2.0
    small = theta < _EPS
    k = torch.where(small, 0.5 - theta * theta / 48.0,
                    torch.sin(half) / torch.where(small, 1.0, theta))
    return torch.cat([torch.cos(half)[..., None], w * k[..., None]], dim=-1)


def matrix_from_quat(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion -> rotation matrix (..., 3, 3)."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                     2 * (x * z + w * y)], dim=-1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                     2 * (y * z - w * x)], dim=-1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                     1 - 2 * (x * x + y * y)], dim=-1),
    ], dim=-2)


def rotation_angle_deg(Ra: torch.Tensor, Rb: torch.Tensor) -> torch.Tensor:
    """Angular distance between two rotations in degrees
    (CompareRotations.m:1-20 metric)."""
    w = log_so3(Ra.transpose(-1, -2) @ Rb)
    return torch.linalg.vector_norm(w, dim=-1) * (180.0 / math.pi)


def view_vector(xi: torch.Tensor) -> torch.Tensor:
    """Third row of the rotation block of exp(xi): the viewing direction of
    the loop-closure angle gate (GlobalOptimize.cpp:436-452)."""
    return exp_so3(xi[..., :3])[..., 2, :]
