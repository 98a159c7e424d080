"""Sim(3) pose-graph refinement: joint rotation, translation and scale.

Port of ``egomotion_with_local_loop_closures_tpu/graph/sim3.py``.  The
reference's back-end averages rotations only
(``perform_rotation_averaging_transition1.m:79-82``); this graph over the
keyframes adds the rest: odometry edges carry each keyframe's rescale
factor as a relative log-scale, loop-closure edges the rematched poses,
and damped Gauss-Newton solves it, node 0 fixed as the gauge.

Sim(3) exp and log are in closed form (Rodrigues rotation and the
W = C I + A [w]x + B [w]x^2 integral with its Taylor limits at small
angle and small log-scale), branch-free through ``torch.where``, so they
batch over leading dimensions and differentiate under ``torch.func``.
:func:`refine` is the dense solver: the full (7E x 7(N-1)) Jacobian by
``torch.func.jacfwd`` each iteration, fine for a window of keyframes and
the reference the matrix-free solver in ``graph/ba.py`` is tested
against.  Everything is float32, as in the JAX package.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from egomotion_with_local_loop_closures_tpu_torch.geom import lie


# ------------------------------------------------------------- Sim(3) ops

def hat_sim3(xi: torch.Tensor) -> torch.Tensor:
    """(..., 7) [w v s] -> (..., 4, 4) algebra element
    [[hat(w) + sI, v], [0, 0]]."""
    w, v, s = xi[..., :3], xi[..., 3:6], xi[..., 6]
    W = lie.hat_so3(w)
    top = torch.cat([W + s[..., None, None] * lie._eye3(W), v[..., :, None]],
                    dim=-1)
    return torch.cat([top, torch.zeros_like(top[..., :1, :])], dim=-2)


_SMALL_T2 = 1e-4      # theta^2 Taylor switch (as in geom.lie)
_SMALL_S = 1e-3       # |sigma| Taylor switch


def _w_coeffs(theta2: torch.Tensor, s: torch.Tensor):
    """Coefficients (A, B, C) of W = int_0^1 e^{s tau} exp([w]x tau) dtau
    = C I + A [w]x + B [w]x^2, with the Taylor limits at theta -> 0 and
    s -> 0.  All four regimes are computed with guarded denominators and
    selected with ``torch.where``."""
    scale = torch.exp(s)
    t_small = theta2 < _SMALL_T2
    s_small = torch.abs(s) < _SMALL_S

    t2g = torch.where(t_small, 1.0, theta2)       # guarded theta^2
    tg = torch.sqrt(t2g)
    sg = torch.where(s_small, 1.0, s)             # guarded sigma

    # C = (e^s - 1)/s;    s->0: 1 + s/2 + s^2/6
    C = torch.where(s_small, 1.0 + s / 2.0 + s * s / 6.0, (scale - 1.0) / sg)

    a = scale * torch.sin(tg)
    b = scale * torch.cos(tg)
    s2t2 = sg * sg + t2g

    # A: s->0: (1-cos t)/t^2 (t->0: 1/2 - t^2/24);
    #    else (a s + (1-b) t)/(t (s^2+t^2)) (t->0: (e^s (s-1) + 1)/s^2)
    A_s0 = torch.where(t_small, 0.5 - theta2 / 24.0,
                       (1.0 - torch.cos(tg)) / t2g)
    A_t0 = (scale * (sg - 1.0) + 1.0) / (sg * sg)
    A_gen = (a * sg + (1.0 - b) * tg) / (tg * s2t2)
    A = torch.where(s_small, A_s0, torch.where(t_small, A_t0, A_gen))

    # B: s->0: (t - sin t)/t^3 (t->0: 1/6 - t^2/120);
    #    else (C - ((b-1) s + a t)/(s^2+t^2)) / t^2
    #    (t->0: (e^s (s^2-2s+2) - 2)/(2 s^3))
    B_s0 = torch.where(t_small, 1.0 / 6.0 - theta2 / 120.0,
                       (tg - torch.sin(tg)) / (t2g * tg))
    B_t0 = (scale * (sg * sg - 2.0 * sg + 2.0) - 2.0) / (2.0 * sg ** 3)
    B_gen = (C - ((b - 1.0) * sg + a * tg) / s2t2) / t2g
    B = torch.where(s_small, B_s0, torch.where(t_small, B_t0, B_gen))
    return A, B, C


def _w_matrix(w: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """W = int_0^1 e^{s tau} exp(hat(w) tau) dtau in closed form."""
    A, B, C = _w_coeffs(torch.sum(w * w, dim=-1), s)
    W = lie.hat_so3(w)
    return (C[..., None, None] * lie._eye3(W) + A[..., None, None] * W
            + B[..., None, None] * (W @ W))


def _det3(M: torch.Tensor) -> torch.Tensor:
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    return a * (e * i - f * h) - b * (d * i - f * g) + c * (d * h - e * g)


def _inv3(M: torch.Tensor) -> torch.Tensor:
    """Closed-form 3x3 inverse (adjugate over determinant), no pivoting;
    W is well conditioned (it tends to I as the transform does)."""
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    A_ = e * i - f * h
    B_ = -(d * i - f * g)
    C_ = d * h - e * g
    det = a * A_ + b * B_ + c * C_
    det = torch.where(torch.abs(det) > 1e-20, det, 1e-20)
    adj = torch.stack([
        torch.stack([A_, -(b * i - c * h), b * f - c * e], dim=-1),
        torch.stack([B_, a * i - c * g, -(a * f - c * d)], dim=-1),
        torch.stack([C_, -(a * h - b * g), a * e - b * d], dim=-1),
    ], dim=-2)
    return adj / det[..., None, None]


def _homogeneous(A: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """[[A, t], [0, 1]] for A (..., 3, 3) and t (..., 3)."""
    top = torch.cat([A, t[..., :, None]], dim=-1)
    bottom = torch.cat([torch.zeros_like(top[..., :1, :3]),
                        torch.ones_like(top[..., :1, 3:])], dim=-1)
    return torch.cat([top, bottom], dim=-2)


def exp_sim3(xi: torch.Tensor) -> torch.Tensor:
    """Sim(3) exponential: (..., 7) [w v s] -> (..., 4, 4)
    [[e^s R, W v], [0, 1]] (the matrix exponential of hat_sim3)."""
    w, v, s = xi[..., :3], xi[..., 3:6], xi[..., 6]
    t = (_w_matrix(w, s) @ v[..., None])[..., 0]
    return _homogeneous(torch.exp(s)[..., None, None] * lie.exp_so3(w), t)


def log_sim3(T: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`exp_sim3` for T = [[e^s R, t], [0, 1]]."""
    A = T[..., :3, :3]
    s = torch.log(_det3(A)) / 3.0           # det(e^s R) = e^{3s}
    w = lie.log_so3(A * torch.exp(-s)[..., None, None])
    v = (_inv3(_w_matrix(w, s)) @ T[..., :3, 3, None])[..., 0]
    return torch.cat([w, v, s[..., None]], dim=-1)


def inv_sim3(T: torch.Tensor) -> torch.Tensor:
    """[[A, t], [0, 1]]^-1 = [[A^-1, -A^-1 t], [0, 1]], A^-1 by
    adjugate."""
    Ainv = _inv3(T[..., :3, :3])
    return _homogeneous(Ainv, -(Ainv @ T[..., :3, 3, None])[..., 0])


def se3_to_sim3(xi6: torch.Tensor, log_scale: float = 0.0) -> torch.Tensor:
    """Lift an se(3) twist [w v] to a Sim(3) 7-vector with the given
    log-scale."""
    xi6 = torch.as_tensor(xi6, dtype=torch.float32)
    return torch.cat([xi6, xi6.new_tensor([log_scale])])


# -------------------------------------------------------------- pose graph

class Sim3Graph(NamedTuple):
    """Edge list: measurement Z_ij ~ X_j X_i^-1 (j in frame i)."""
    nodes: torch.Tensor     # (N, 7) initial world 7-vectors
    edges: torch.Tensor     # (E, 2) int64 [i, j]
    meas: torch.Tensor      # (E, 7) measured relative 7-vectors
    weights: torch.Tensor   # (E,) per-edge weight


def residuals(nodes: torch.Tensor, edges: torch.Tensor,
              meas: torch.Tensor) -> torch.Tensor:
    """r_e = log(X_j X_i^-1 Z_e^-1), (E, 7): zero when X_j = Z X_i, the
    pipeline's left composition (lie.compose: world = pose_wrt_kf o
    kf_world, Frame.cpp:503-530)."""
    Xi = exp_sim3(nodes[edges[:, 0]])
    Xj = exp_sim3(nodes[edges[:, 1]])
    return log_sim3(Xj @ inv_sim3(Xi) @ inv_sim3(exp_sim3(meas)))


def huber_weights(r: torch.Tensor, weights: torch.Tensor,
                  huber_delta: float) -> torch.Tensor:
    """Per-edge weight times the Huber factor of the whole-edge residual
    norm."""
    rn = torch.linalg.vector_norm(r, dim=-1)
    return weights * torch.where(rn <= huber_delta, 1.0,
                                 huber_delta / torch.clamp_min(rn, 1e-12))


def refine(graph: Sim3Graph, num_iters: int = 10, huber_delta: float = 0.05,
           damping: float = 1e-6) -> Tuple[torch.Tensor, torch.Tensor]:
    """Damped Gauss-Newton on the Sim(3) pose graph with the dense
    Jacobian, ``num_iters`` iterations.  Node 0 is the gauge anchor
    (the identity-prepended first pose of ``small_batch_rotavg.m:35``).
    Returns (refined (N, 7) nodes, (num_iters,) weighted residual RMS)."""
    N = graph.nodes.shape[0]
    anchor = graph.nodes[:1]

    def flat_residuals(free_flat):
        nodes = torch.cat([anchor, free_flat.reshape(N - 1, 7)])
        return residuals(nodes, graph.edges, graph.meas).reshape(-1)

    free = graph.nodes[1:].reshape(-1)
    eye = torch.eye(free.shape[0], dtype=free.dtype, device=free.device)
    hist = []
    for _ in range(num_iters):
        r = flat_residuals(free)
        J = torch.func.jacfwd(flat_residuals)(free)        # (7E, 7(N-1))
        w = torch.repeat_interleave(
            huber_weights(r.reshape(-1, 7), graph.weights, huber_delta), 7)
        JtW = J.T * w[None, :]
        delta = torch.linalg.solve_ex(JtW @ J + damping * eye, JtW @ r)[0]
        hist.append(torch.sqrt(torch.mean(w * r * r)))
        free = free - delta
    return torch.cat([anchor, free.reshape(N - 1, 7)]), torch.stack(hist)


# ----------------------------------------------------------- construction

def graph_from_trajectory(kf_world_poses: np.ndarray,
                          kf_rescales: np.ndarray, loop_edges=None,
                          device=None) -> Sim3Graph:
    """A keyframe pose graph from pipeline outputs, on ``device``.

    - nodes: keyframe world se(3) poses lifted to Sim(3), node k's
      log-scale the accumulated log rescale (the GLOABL_DEPTH_SCALE chain,
      ExternVariable.h:229);
    - odometry edges k -> k+1: the relative pose and the keyframe's log
      rescale;
    - loop edges ``(i, j, rel_pose6)`` with log-scale 0; every weight 1.
    """
    P = np.asarray(kf_world_poses, np.float32)
    n = P.shape[0]
    rs = np.log(np.maximum(np.asarray(kf_rescales, np.float32), 1e-12))
    cum = np.concatenate([[0.0], np.cumsum(rs)[:-1]]).astype(np.float32)
    nodes = np.concatenate([P, cum[:, None]], axis=1)
    rel = lie.relative(torch.from_numpy(P[1:]),
                       torch.from_numpy(P[:-1])).numpy()
    ei = [[k, k + 1] for k in range(n - 1)]
    meas = [np.concatenate([rel[k], [rs[k]]]) for k in range(n - 1)]
    for (i, j, rel6) in (loop_edges or []):
        ei.append([i, j])
        meas.append(np.concatenate([np.asarray(rel6, np.float32), [0.0]]))
    f32 = dict(dtype=torch.float32, device=device)
    return Sim3Graph(
        nodes=torch.as_tensor(nodes, **f32),
        edges=torch.as_tensor(np.asarray(ei, np.int64).reshape(-1, 2),
                              device=device),
        meas=torch.as_tensor(np.asarray(meas, np.float32).reshape(-1, 7),
                             **f32),
        weights=torch.ones(len(ei), **f32))
