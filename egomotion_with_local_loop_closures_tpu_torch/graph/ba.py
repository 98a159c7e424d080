"""Sim(3) bundle adjustment of the keyframe pose graph: per-edge
Jacobians, matrix-free normal equations, preconditioned CG.

Port of ``refine`` from
``egomotion_with_local_loop_closures_tpu/graph/ba.py``; the solver behind
``runtime/ellc_lc.py``'s ``do_sim3_refine``.  ``graph/sim3.py``'s dense
``refine`` builds the whole (7E x 7(N-1)) Jacobian each iteration; here
each damped Gauss-Newton iteration costs O(E + N):

1. every edge's residual r_e = log(X_j X_i^-1 Z_e^-1) and its two 7x7
   blocks d r_e / d eps_i, d r_e / d eps_j under left perturbations
   exp(eps) X, by ``torch.func.jacfwd`` of the closed-form 14 -> 7 edge
   map evaluated for all edges at once (14 forward-mode passes over the
   edge batch);
2. Huber and per-edge weights on whole-edge residual norms, as in
   ``sim3.refine``;
3. (J^T W J + lambda I) dx = J^T W r solved without forming the matrix:
   CG whose matvec gathers node blocks per edge, multiplies by the edge's
   blocks and sums them back per node, preconditioned by the inverted
   per-node 7x7 diagonal blocks;
4. node 0 fixed as the gauge by zeroing its tangent in the gradient, the
   matvec and the preconditioner.

Every loop has a fixed trip count and nothing in an iteration reads a
value back to the host.  The per-node sums (the gradient, the diagonal
blocks, each matvec) gather each node's edge terms through a table built
once a refine (:func:`_node_table`) and sum them over its columns: one
fixed order, with no float atomic, so two runs on the card give the same
nodes (``index_add_`` on CUDA adds in atomic order).

``refine_sharded`` splits the edges over the ranks of a process group:
each rank linearizes its own edges, and every (N, 7) and (N, 7, 7)
reduction (the gradient, the preconditioner's blocks and each CG matvec)
and the residual sums are ``all_reduce``d where the JAX package
``psum``s; the node state is replicated.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.distributed as dist

from egomotion_with_local_loop_closures_tpu_torch.graph import sim3
from egomotion_with_local_loop_closures_tpu_torch.graph.sim3 import Sim3Graph


class BAResult(NamedTuple):
    nodes: torch.Tensor        # (N, 7) refined world 7-vectors
    rms_history: torch.Tensor  # (num_iters,) weighted residual RMS


def _edge_map(eps: torch.Tensor, xi_i: torch.Tensor, xi_j: torch.Tensor,
              meas7: torch.Tensor) -> torch.Tensor:
    """r(eps) = log(exp(eps_j) X_j (exp(eps_i) X_i)^-1 Z^-1) with eps =
    [eps_i, eps_j] (..., 14): the edge residual under left
    perturbations, over any leading edge dimensions."""
    Xi = sim3.exp_sim3(xi_i)
    Xj = sim3.exp_sim3(xi_j)
    Zinv = sim3.inv_sim3(sim3.exp_sim3(meas7))
    M = (sim3.exp_sim3(eps[..., 7:]) @ Xj @ sim3.inv_sim3(Xi)
         @ sim3.inv_sim3(sim3.exp_sim3(eps[..., :7])) @ Zinv)
    return sim3.log_sim3(M)


def _residual_jacobians(xi_i, xi_j, meas):
    """Every edge's (r (E, 7), J_i (E, 7, 7), J_j (E, 7, 7)) at eps = 0.
    The edges share one eps (14,), and edge e's residual depends on it
    through its own computation alone, so the Jacobian of the (E, 7)
    residuals w.r.t. it holds each edge's own blocks."""
    E = xi_i.shape[0]

    def f(eps):
        r = _edge_map(eps.expand(E, 14), xi_i, xi_j, meas)
        return r, r
    J, r = torch.func.jacfwd(f, has_aux=True)(
        torch.zeros(14, dtype=xi_i.dtype, device=xi_i.device))
    return r, J[..., :7], J[..., 7:]


def _linearize(nodes, edges, meas, weights, huber_delta):
    """Residuals, Jacobian blocks and robust weights of all edges."""
    r, Ji, Jj = _residual_jacobians(nodes[edges[:, 0]], nodes[edges[:, 1]],
                                    meas)
    return r, Ji, Jj, sim3.huber_weights(r, weights, huber_delta)


def _gauge(v: torch.Tensor) -> torch.Tensor:
    """Zero node 0's tangent (the gauge anchor)."""
    return torch.cat([torch.zeros_like(v[:1]), v[1:]])


def _node_table(ei: torch.Tensor, ej: torch.Tensor, N: int) -> torch.Tensor:
    """(N, max degree): row n holds the indices of node n's edge ends in
    the E ends i, then the E ends j, ascending, padded with 2E (a zero
    row appended by :func:`_to_nodes`).  Reads the largest degree back to
    the host: once a refine, the edges being fixed."""
    E = ei.numel()
    ends = torch.cat([ei, ej]).long()
    nodes, order = torch.sort(ends, stable=True)
    deg = torch.bincount(ends, minlength=N)
    start = torch.cumsum(deg, 0) - deg
    rank = torch.arange(2 * E, device=ei.device) - start[nodes]
    table = torch.full((N, max(int(deg.max()) if E else 0, 1)), 2 * E,
                       dtype=torch.int64, device=ei.device)
    table[nodes, rank] = order
    return table


def _to_nodes(table: torch.Tensor, ti: torch.Tensor,
              tj: torch.Tensor) -> torch.Tensor:
    """Per node, the sum of the terms of its edge ends (``ti`` at each
    edge's end i, ``tj`` at its end j, (E, ...)): a gather through
    ``table`` and a sum over its columns, in one fixed order."""
    both = torch.cat([ti, tj, ti.new_zeros((1,) + ti.shape[1:])])
    return both[table].sum(1)


def _assemble_grad_diag(r, Ji, Jj, w, table):
    """g = sum_e J^T w r per node, and the per-node 7x7 diagonal blocks D
    of J^T W J (the block-Jacobi preconditioner)."""
    gi = torch.einsum("eab,ea->eb", Ji, r) * w[:, None]
    gj = torch.einsum("eab,ea->eb", Jj, r) * w[:, None]
    Di = torch.einsum("eab,eac->ebc", Ji, Ji) * w[:, None, None]
    Dj = torch.einsum("eab,eac->ebc", Jj, Jj) * w[:, None, None]
    return _to_nodes(table, gi, gj), _to_nodes(table, Di, Dj)


def _matvec(v, Ji, Jj, w, ei, ej, table, damping):
    """(J^T W J + damping I) v without the matrix: one gather, per-edge
    7x7 products, each end's product summed back into its node."""
    u = (torch.einsum("eab,eb->ea", Ji, v[ei])
         + torch.einsum("eab,eb->ea", Jj, v[ej])) * w[:, None]
    out = _to_nodes(table, torch.einsum("eab,ea->eb", Ji, u),
                    torch.einsum("eab,ea->eb", Jj, u))
    return _gauge(out + damping * v)


def _pcg(matvec, g, Dinv, num_iters):
    """Preconditioned conjugate gradient for H x = g, ``num_iters``
    iterations; ``Dinv`` (N, 7, 7) is the block-Jacobi preconditioner."""
    def apply_pre(x):
        return _gauge(torch.einsum("nab,nb->na", Dinv, x))

    x = torch.zeros_like(g)
    r = g                                    # residual of H x = g at x = 0
    z = apply_pre(r)
    p = z
    rz = torch.sum(r * z)
    for _ in range(num_iters):
        Hp = matvec(p)
        pHp = torch.sum(p * Hp)
        alpha = rz / torch.where(torch.abs(pHp) > 1e-20, pHp, 1e-20)
        x = x + alpha * p
        r = r - alpha * Hp
        z = apply_pre(r)
        rz_new = torch.sum(r * z)
        p = z + rz_new / torch.where(torch.abs(rz) > 1e-20, rz, 1e-20) * p
        rz = rz_new
    return x


def _retract(nodes: torch.Tensor, dx: torch.Tensor) -> torch.Tensor:
    """The GN step on the manifold: the Jacobians are for left
    perturbations exp(eps) X, so X <- exp(-dx) X (node 0's dx is 0)."""
    return sim3.log_sim3(sim3.exp_sim3(-dx) @ sim3.exp_sim3(nodes))


def _block_inv(D: torch.Tensor, damping: float) -> torch.Tensor:
    """Inverse of each per-node 7x7 block plus damping; the gauge node's
    block is the identity (its tangent is zeroed anyway).  ``solve_ex``
    checks nothing on the host."""
    eye = torch.eye(7, dtype=D.dtype, device=D.device)
    Dd = torch.cat([eye[None], D[1:] + damping * eye])
    return torch.linalg.solve_ex(Dd, eye.expand_as(Dd))[0]


def refine(graph: Sim3Graph, num_iters: int = 10, cg_iters: int = 25,
           huber_delta: float = 0.05, damping: float = 1e-6) -> BAResult:
    """Damped Gauss-Newton with matrix-free PCG: the problem and robust
    weighting of ``sim3.refine``, at O(E + N) an iteration."""
    N = graph.nodes.shape[0]
    ei, ej = graph.edges[:, 0], graph.edges[:, 1]
    table = _node_table(ei, ej, N)
    nodes = graph.nodes
    hist = []
    for _ in range(num_iters):
        r, Ji, Jj, w = _linearize(nodes, graph.edges, graph.meas,
                                  graph.weights, huber_delta)
        g, D = _assemble_grad_diag(r, Ji, Jj, w, table)
        dx = _pcg(lambda v: _matvec(v, Ji, Jj, w, ei, ej, table, damping),
                  _gauge(g), _block_inv(D, damping), cg_iters)
        hist.append(torch.sqrt(torch.mean(w[:, None] * r * r)))
        nodes = _retract(nodes, dx)
    return BAResult(nodes=nodes, rms_history=torch.stack(hist))


def pad_edges(graph: Sim3Graph, multiple: int) -> Sim3Graph:
    """Pad the edge list to a multiple of ``multiple`` with zero-weight
    identity self-edges on node 0 (their residual is log(X0 X0^-1 I) = 0
    and their weight removes any numeric residue)."""
    E = graph.edges.shape[0]
    pad = -E % multiple
    if pad == 0:
        return graph

    def grow(t, *shape):
        return torch.cat([t, t.new_zeros((pad,) + shape)])

    return Sim3Graph(nodes=graph.nodes, edges=grow(graph.edges, 2),
                     meas=grow(graph.meas, 7), weights=grow(graph.weights))


def _psum(t: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``t`` over the ranks of ``group`` (a new tensor)."""
    t = t.clone()
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    return t


def refine_sharded(graph: Sim3Graph, group=None, num_iters: int = 10,
                   cg_iters: int = 25, huber_delta: float = 0.05,
                   damping: float = 1e-6) -> BAResult:
    """Edge-sharded ``refine`` over the ranks of ``group`` (None: the
    default group).  Every rank passes the whole graph; the edges are
    padded to a multiple of the group's size (``pad_edges``) and rank r
    takes the r-th block of them.  Every rank returns the same nodes,
    equal to ``refine``'s up to the order of the float sums.  As in the
    JAX package, the RMS counts the padding edges' (zero) residuals."""
    n = dist.get_world_size(group)
    rank = dist.get_rank(group)
    graph = pad_edges(graph, n)
    per = graph.edges.shape[0] // n
    mine = slice(rank * per, (rank + 1) * per)
    edges, meas, weights = (graph.edges[mine], graph.meas[mine],
                            graph.weights[mine])
    N = graph.nodes.shape[0]
    ei, ej = edges[:, 0], edges[:, 1]
    table = _node_table(ei, ej, N)
    nodes = graph.nodes
    hist = []
    for _ in range(num_iters):
        r, Ji, Jj, w = _linearize(nodes, edges, meas, weights, huber_delta)
        g, D = _assemble_grad_diag(r, Ji, Jj, w, table)
        g, D = _psum(g, group), _psum(D, group)

        def mv(v):
            local = _matvec(v, Ji, Jj, w, ei, ej, table, 0.0)
            return _gauge(_psum(local, group) + damping * v)

        dx = _pcg(mv, _gauge(g), _block_inv(D, damping), cg_iters)
        sums = _psum(torch.stack([torch.sum(w[:, None] * r * r),
                                  torch.tensor(float(r.numel()),
                                               device=r.device)]), group)
        hist.append(torch.sqrt(sums[0] / sums[1]))
        nodes = _retract(nodes, dx)
    return BAResult(nodes=nodes, rms_history=torch.stack(hist))
