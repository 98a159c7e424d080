"""Robust SO(3) rotation averaging (Chatterjee-Govindu).

Port of ``egomotion_with_local_loop_closures_tpu/graph/rotation_averaging.py``
(the reference's MATLAB back end, ``matlab_scripts/SO3GraphAveraging/``):

- :func:`largest_connected_component` and :func:`spanning_tree_init` stay
  host numpy (float64), as in the JAX package;
- :func:`l1_init` (the L1 bootstrap, minimized by IRLS-L1 in place of the
  MATLAB's interior-point LP) and :func:`irls_refine` (the sigma-weighted
  IRLS, RobustMeanSO3Graph.m:130-191) run in float32 torch on the
  caller's device, like the JAX package's float32 device programs;
- :func:`average_so3_graph` is the AverageSO3Graph.m:57-94 pipeline.

The JAX package pads the edge list and the node set to power-of-2 buckets
so that its jitted solvers compile once; the port solves the real graph.

Graph convention: edge p relates nodes ``i = I[0, p]`` -> ``j = I[1, p]``
with ``R_ij = R_j R_i^{-1}`` (RobustMeanSO3Graph.m "IMPORTANT NOTES").
"""

from __future__ import annotations

import math
import warnings

import numpy as np
import torch

from egomotion_with_local_loop_closures_tpu_torch.geom import lie


def largest_connected_component(I: np.ndarray, n: int) -> np.ndarray:
    """Node mask of the largest connected component (AverageSO3Graph.m:62-65
    uses graphconncomp).  Host-side union-find; graphs are tiny."""
    parent = list(range(n))

    def find(a):
        while parent[a] != a:
            parent[a] = parent[parent[a]]
            a = parent[a]
        return a

    for i, j in I.T:
        ri, rj = find(int(i)), find(int(j))
        if ri != rj:
            parent[ri] = rj
    roots = np.asarray([find(i) for i in range(n)])
    vals, counts = np.unique(roots, return_counts=True)
    return roots == vals[np.argmax(counts)]


def _quat_mul_np(a, b):
    w1, x1, y1, z1 = a
    w2, x2, y2, z2 = b
    return np.asarray([w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
                       w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
                       w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
                       w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2])


def spanning_tree_init(QQ: np.ndarray, I: np.ndarray, n: int) -> np.ndarray:
    """Quaternion init by walking edges until all nodes are reached
    (RobustMeanSO3Graph.m:88-118).  QQ: (m, 4) relative quats (scalar
    first), I: (2, m) int edges i->j.  Returns (n, 4) float64."""
    Q = np.tile(np.asarray([1.0, 0.0, 0.0, 0.0]), (n, 1))
    have = np.zeros(n, bool)
    have[0] = True
    qq = np.asarray(QQ)
    while not have.all():
        progressed = False
        for p in range(I.shape[1]):
            i, j = int(I[0, p]), int(I[1, p])
            if have[i] and not have[j]:
                Q[j] = _quat_mul_np(qq[p], Q[i])            # Qj = Qij * Qi
                have[j] = True
                progressed = True
            elif have[j] and not have[i]:
                cj = qq[p] * np.asarray([1.0, -1.0, -1.0, -1.0])
                Q[i] = _quat_mul_np(cj, Q[j])        # Qi = conj(Qij) * Qj
                have[i] = True
                progressed = True
        if not progressed:
            break  # disconnected: the caller restricts to a component first
    return Q


def _residual_tangent(QQ: torch.Tensor, Q: torch.Tensor, I: torch.Tensor
                      ) -> torch.Tensor:
    """B = log(Qj^-1 Qij Qi) in the atan2 form of
    RobustMeanSO3Graph.m:140-161; (m, 3)."""
    w = lie.quat_mul(QQ, Q[I[0]])
    w = lie.quat_mul(lie.quat_conj(Q[I[1]]), w)
    s2 = torch.linalg.vector_norm(w[:, 1:], dim=1)
    theta = 2.0 * torch.atan2(s2, w[:, 0])
    theta = torch.where(theta >= math.pi, theta - 2 * math.pi, theta)
    theta = torch.where(theta < -math.pi, theta + 2 * math.pi, theta)
    ok = s2 > 1e-12
    B = w[:, 1:] * (theta / torch.where(ok, s2, 1.0))[:, None]
    return torch.where(ok[:, None], B, 0.0)


def _incidence(I: torch.Tensor, n: int) -> torch.Tensor:
    """Dense A (m, n-1): row p has -1 at i-1, +1 at j-1 (node 0 fixed);
    RobustMeanSO3Graph.m:121-127."""
    m = I.shape[1]
    A = torch.zeros((m, n - 1), dtype=torch.float32, device=I.device)
    rows = torch.arange(m, device=I.device)
    for k, sign in ((0, -1.0), (1, 1.0)):
        # node 0 adds an exact 0 to column 0; the sums are exact
        A.index_put_((rows, torch.clamp_min(I[k] - 1, 0)),
                     torch.where(I[k] > 0, sign, 0.0), accumulate=True)
    return A


def _apply_update(Q: torch.Tensor, dW: torch.Tensor) -> torch.Tensor:
    """Q <- Q * exp(dW) quaternion-compose (RobustMeanSO3Graph.m:173-183)."""
    return lie.quat_mul(Q, lie.exp_quat(dW))


def _solve_weighted(A: torch.Tensor, B: torch.Tensor, w: torch.Tensor
                    ) -> torch.Tensor:
    """argmin_X ||diag(w)(A X - B)||_2 via the normal equations (an LU
    solve, as jnp.linalg.solve; ``solve_ex`` skips the singularity check
    that would read the result back to the host)."""
    Aw = A * w[:, None]
    G = Aw.T @ Aw + 1e-9 * torch.eye(A.shape[1], device=A.device)
    return torch.linalg.solve_ex(G, Aw.T @ (B * w[:, None]))[0]


def irls_refine(QQ: torch.Tensor, I: torch.Tensor, n: int, Q0: torch.Tensor,
                sigma_deg: float = 5.0, max_iters: int = 100,
                tol: float = 1e-3) -> torch.Tensor:
    """Chatterjee-Govindu IRLS (RobustMeanSO3Graph.m:130-191): at least
    one iteration, then until the mean update norm is <= ``tol`` or
    ``max_iters`` ran.  The stop reads the score on the host, one read per
    iteration."""
    sigma = sigma_deg * math.pi / 180.0
    A = _incidence(I, n)
    Q = Q0
    weights = torch.ones(I.shape[1], device=Q0.device)
    zero = torch.zeros((1, 3), device=Q0.device)
    for _ in range(max_iters):
        B = _residual_tangent(QQ, Q, I)
        X = _solve_weighted(A, B, weights)           # (n-1, 3)
        E = A @ X - B
        weights = sigma / (torch.sum(E * E, dim=1) + sigma * sigma)
        score = torch.sum(torch.linalg.vector_norm(X, dim=1)) / n
        Q = _apply_update(Q, torch.cat([zero, X], dim=0))
        if float(score) <= tol:
            break
    return Q


def l1_init(QQ: torch.Tensor, I: torch.Tensor, n: int, Q0: torch.Tensor,
            max_iters: int = 10, inner_iters: int = 8) -> torch.Tensor:
    """L1 rotation averaging by IRLS-L1 (replaces BoxMedianSO3Graph's
    interior-point l1decode_pd; the same objective min ||A dw - B||_1 per
    axis, weights 1/sqrt(|r| + eps) refreshed ``inner_iters`` times per
    outer relinearization)."""
    A = _incidence(I, n)
    eps = 1e-5
    Q = Q0
    zero = torch.zeros((1, 3), device=Q0.device)
    for _ in range(max_iters):
        B = _residual_tangent(QQ, Q, I)
        X = torch.zeros((n - 1, 3), device=Q0.device)
        for _ in range(inner_iters):
            R = A @ X - B
            X = torch.cat([
                _solve_weighted(A, B[:, k:k + 1],
                                1.0 / torch.sqrt(torch.abs(R[:, k]) + eps))
                for k in range(3)], dim=1)
        Q = _apply_update(Q, torch.cat([zero, X], dim=0))
    return Q


def average_so3_graph(RR: np.ndarray, I: np.ndarray, device,
                      sigma_deg: float = 5.0,
                      l1_iters: int = 10, irls_iters: int = 100,
                      tol: float = 1e-3) -> np.ndarray:
    """Full AverageSO3Graph pipeline.  RR: (m, 3, 3) relative rotations
    R_ij = R_j R_i^T; I: (2, m) 0-based edges.  Returns (n, 3, 3) absolute
    rotations (identity for nodes outside the largest component).  The
    solvers run on ``device``."""
    device = torch.device(device)
    I = np.asarray(I, dtype=np.int64)
    n = int(I.max()) + 1
    keep = largest_connected_component(I, n)
    remap = -np.ones(n, np.int64)
    remap[keep] = np.arange(keep.sum())
    edge_keep = keep[I[0]] & keep[I[1]]
    I_sub = remap[I[:, edge_keep]]
    RR_sub = np.asarray(RR[edge_keep], np.float64)

    # rotation-sanity projection (AverageSO3Graph.m:80-91): improper
    # rotations (det <= 0) are an error; singular values off 1 by >= 0.1
    # are an error, >= 0.01 a warning; every matrix is re-projected onto
    # SO(3) via U * round(S) * V' as the MATLAB does
    dets = np.linalg.det(RR_sub)
    if (dets <= 0).any():
        p = int(np.argmax(dets <= 0))
        raise ValueError(f"det(RR[{p}])={dets[p]:.6f} <= 0: "
                         "improper input rotation")
    U, S, Vt = np.linalg.svd(RR_sub)
    if (np.abs(S - 1.0) >= 0.1).any():
        p = int(np.argmax((np.abs(S - 1.0) >= 0.1).any(axis=1)))
        raise ValueError(f"svd(RR[{p}]) singular values {S[p]} too far "
                         "from 1: not a rotation")
    if (np.abs(S - 1.0) >= 0.01).any():
        warnings.warn("rotation-averaging input rotations required "
                      "SO(3) re-projection (singular values off 1 by "
                      ">= 0.01)")
    RR_sub = np.einsum("nij,nj,njk->nik", U, np.round(S), Vt)

    QQ = lie.quat_from_matrix(torch.as_tensor(RR_sub, dtype=torch.float32,
                                              device=device))
    n_keep = int(keep.sum())
    Q0 = spanning_tree_init(QQ.cpu().numpy(), I_sub, n_keep)
    Ij = torch.as_tensor(I_sub, device=device)
    Q = torch.as_tensor(Q0, dtype=torch.float32, device=device)
    if n_keep > 1:        # a lone node (only self-edges) stays at identity
        Q = l1_init(QQ, Ij, n_keep, Q, max_iters=l1_iters)
        Q = irls_refine(QQ, Ij, n_keep, Q, sigma_deg=sigma_deg,
                        max_iters=irls_iters, tol=tol)
    out = np.tile(np.eye(3), (n, 1, 1))
    out[keep] = lie.matrix_from_quat(Q).cpu().numpy()
    return out


def random_so3_graph(n: int, completeness: float = 0.5,
                     sigma: float = 0.1, num_outliers: int = 0,
                     seed: int = 0):
    """Synthetic test graph, port of RandomSO3Graph.m: ground-truth
    rotations, edges with Lie-algebra Gaussian noise, plus uniformly
    random outlier edges, drawn from ``np.random.default_rng(seed)`` in
    the JAX package's order (its rotations float32).  Returns (R_gt
    (n, 3, 3), RR (m, 3, 3), I (2, m))."""
    def exp(w):
        return lie.exp_so3(torch.as_tensor(w, dtype=torch.float32)).numpy()

    rng = np.random.default_rng(seed)
    R_gt = exp(rng.normal(size=(n, 3)) * 0.8)
    edges = [(i, i + 1) for i in range(n - 1)]   # ensure connectivity
    for i in range(n):
        for j in range(i + 2, n):
            if rng.uniform() < completeness:
                edges.append((i, j))
    I = np.asarray(edges).T
    m = I.shape[1]
    noise = exp(rng.normal(size=(m, 3)) * sigma)
    RR = np.einsum("mab,mbc,mdc->mad", noise, R_gt[I[1]], R_gt[I[0]])
    if num_outliers:
        idx = rng.choice(m, size=min(num_outliers, m), replace=False)
        RR[idx] = exp(rng.uniform(-np.pi, np.pi, size=(len(idx), 3)))
    return R_gt, RR, I
