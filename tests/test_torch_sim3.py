"""The port's Sim(3) pose-graph refinement (graph/sim3.py, graph/ba.py and
LC mode's ``_sim3_refine_trajectory``) against the JAX package's.

The same numpy inputs go through both.  Sim(3) exp, log and inverse in
each of the four regimes of the closed form (small or large angle, small
or large log-scale) within 1e-5 per entry (entries of magnitude up to
~3: a few float32 ulp of two libraries' transcendentals; measured
2.6e-6); the dense and the matrix-free solvers on a seeded 10-node graph
with an outlier loop edge, 8 iterations, within 5e-5 per node component
(measured 1.0e-6 and 4.1e-6 on a CPU); and the trajectory refinement of
the JAX package's 96x128 LC run (tests/data/port_golden_lc_test.json)
within 5e-5.
"""

import json
import os
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from egomotion_with_local_loop_closures_tpu.config import TEST_CONFIG as JT
from egomotion_with_local_loop_closures_tpu.graph import ba as jba
from egomotion_with_local_loop_closures_tpu.graph import sim3 as jsim3
from egomotion_with_local_loop_closures_tpu.runtime import ellc_lc as jlc

from egomotion_with_local_loop_closures_tpu_torch.config import TEST_CONFIG
from egomotion_with_local_loop_closures_tpu_torch.graph import ba, sim3
from egomotion_with_local_loop_closures_tpu_torch.runtime import ellc_lc

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OPS_TOL, SOLVER_TOL = 1e-5, 5e-5
# (rotation scale, log-scale scale) of each regime: theta^2 against
# _SMALL_T2 = 1e-4, |s| against _SMALL_S = 1e-3
REGIMES = {"general": (0.3, 0.2), "small_angle": (1e-3, 0.2),
           "small_scale": (0.3, 1e-4), "both_small": (1e-3, 1e-4)}


def twists(rot, scale, n, seed):
    rng = np.random.default_rng(seed)
    return np.concatenate([rng.normal(size=(n, 3)) * rot,
                           rng.normal(size=(n, 3)),
                           rng.normal(size=(n, 1)) * scale], 1
                          ).astype(np.float32)


@pytest.mark.parametrize("regime", sorted(REGIMES))
def test_exp_log_inv_match_jax(regime):
    rot, scale = REGIMES[regime]
    xi = twists(rot, scale, 16, seed=len(regime))
    theta2 = np.sum(xi[:, :3] ** 2, axis=1)
    assert ((theta2 < sim3._SMALL_T2) == (rot < 0.01)).all()
    assert ((np.abs(xi[:, 6]) < sim3._SMALL_S) == (scale < 0.01)).all()
    Tj = np.asarray(jax.vmap(jsim3.exp_sim3)(jnp.asarray(xi)))
    Tt = sim3.exp_sim3(torch.as_tensor(xi))
    np.testing.assert_allclose(Tt.numpy(), Tj, atol=OPS_TOL, rtol=0)
    np.testing.assert_allclose(
        sim3.log_sim3(torch.as_tensor(Tj)).numpy(),
        np.asarray(jax.vmap(jsim3.log_sim3)(jnp.asarray(Tj))),
        atol=OPS_TOL, rtol=0)
    np.testing.assert_allclose(
        sim3.inv_sim3(torch.as_tensor(Tj)).numpy(),
        np.asarray(jsim3.inv_sim3(jnp.asarray(Tj))), atol=OPS_TOL, rtol=0)
    # exp is the matrix exponential of the algebra element, log its
    # inverse; below |s| = 1e-3 the closed form keeps the s -> 0 limits of
    # A and B, exact to O(s) (at |s| ~ 1e-4 and |v| ~ 3: ~5e-5), as in
    # the JAX package
    np.testing.assert_allclose(
        Tt.numpy(), torch.linalg.matrix_exp(sim3.hat_sim3(
            torch.as_tensor(xi, dtype=torch.float64))).numpy(), atol=1e-4)
    np.testing.assert_allclose(sim3.log_sim3(Tt).numpy(), xi, atol=2e-5)
    np.testing.assert_allclose(sim3.hat_sim3(torch.as_tensor(xi[0])).numpy(),
                               np.asarray(jsim3.hat_sim3(jnp.asarray(xi[0]))))


@pytest.fixture(scope="module")
def graph():
    """A seeded 10-node graph: the odometry chain and three loop edges,
    measured with noise, one loop edge an outlier, nodes started off the
    truth."""
    rng = np.random.default_rng(4)
    gt = twists(0.2, 0.1, 10, seed=3)
    gt[0] = 0.0
    edges = np.asarray([(k, k + 1) for k in range(9)]
                       + [(0, 5), (2, 7), (3, 9)], np.int64)
    T = np.asarray(jax.vmap(jsim3.exp_sim3)(jnp.asarray(gt)))
    meas = np.asarray(jax.vmap(jsim3.log_sim3)(jnp.asarray(
        T[edges[:, 1]] @ np.asarray(jsim3.inv_sim3(jnp.asarray(
            T[edges[:, 0]]))))))
    meas = (meas + rng.normal(size=meas.shape) * 0.01).astype(np.float32)
    meas[-1, 3:6] += 0.5                                   # the outlier
    init = (gt + rng.normal(size=gt.shape) * 0.05).astype(np.float32)
    init[0] = 0.0
    jg = jsim3.Sim3Graph(jnp.asarray(init), jnp.asarray(edges, jnp.int32),
                         jnp.asarray(meas), jnp.ones(len(edges)))
    tg = sim3.Sim3Graph(torch.as_tensor(init), torch.as_tensor(edges),
                        torch.as_tensor(meas), torch.ones(len(edges)))
    return jg, tg


def test_residuals_match_jax(graph):
    jg, tg = graph
    np.testing.assert_allclose(
        sim3.residuals(tg.nodes, tg.edges, tg.meas).numpy(),
        np.asarray(jsim3.residuals(jg.nodes, jg.edges, jg.meas)),
        atol=OPS_TOL, rtol=0)


def test_dense_refine_matches_jax(graph):
    jg, tg = graph
    nj, hj = jsim3.refine(jg, num_iters=8)
    nt, ht = sim3.refine(tg, num_iters=8)
    np.testing.assert_allclose(nt.numpy(), np.asarray(nj), atol=SOLVER_TOL,
                               rtol=0)
    np.testing.assert_allclose(ht.numpy(), np.asarray(hj), rtol=1e-4)
    assert torch.equal(nt[0], tg.nodes[0])                 # the gauge
    assert float(ht[-1]) < 0.6 * float(ht[0])


def test_ba_refine_matches_jax_and_the_dense_solver(graph):
    jg, tg = graph
    rj = jba.refine(jg, num_iters=8)
    rt = ba.refine(tg, num_iters=8)
    np.testing.assert_allclose(rt.nodes.numpy(), np.asarray(rj.nodes),
                               atol=SOLVER_TOL, rtol=0)
    np.testing.assert_allclose(rt.rms_history.numpy(),
                               np.asarray(rj.rms_history), rtol=1e-4)
    # 25 CG iterations come close to the dense solve, as in the JAX package
    dense, _ = sim3.refine(tg, num_iters=8)
    np.testing.assert_allclose(rt.nodes.numpy(), dense.numpy(), atol=2e-3)


def test_graph_from_trajectory_matches_jax():
    P = twists(0.2, 0.0, 6, seed=9)[:, :6]
    rescales = np.linspace(0.9, 1.1, 6).astype(np.float32)
    loops = [(0, 4, P[4] - P[0]), (1, 5, P[5] - P[1])]
    jg = jsim3.graph_from_trajectory(P, rescales, loop_edges=loops)
    tg = sim3.graph_from_trajectory(P, rescales, loop_edges=loops)
    for name in ("nodes", "meas", "weights"):
        np.testing.assert_allclose(getattr(tg, name).numpy(),
                                   np.asarray(getattr(jg, name)),
                                   atol=OPS_TOL, rtol=0)
    np.testing.assert_array_equal(tg.edges.numpy(), np.asarray(jg.edges))


def test_trajectory_refinement_matches_jax():
    """LC mode's final refinement of the JAX package's 96x128 LC run: its
    corrected poses and loop edges into both packages' functions."""
    with open(os.path.join(ROOT, "tests", "data",
                           "port_golden_lc_test.json")) as f:
        run = json.load(f)["run_ellc_lc"]
    ids = np.asarray(run["frame_ids"], np.int64)
    poses = np.asarray(run["world_poses"], np.float32)
    edges = [types.SimpleNamespace(**e) for e in run["edges"]]
    overrides = run["config_overrides"]
    want = jlc._sim3_refine_trajectory(ids, poses, edges,
                                       JT.replace(**overrides))
    got = ellc_lc._sim3_refine_trajectory(
        ids, poses, edges, TEST_CONFIG.replace(**overrides), "cpu")
    assert got.shape == poses.shape == want.shape
    np.testing.assert_allclose(got, want, atol=SOLVER_TOL, rtol=0)
    assert np.abs(got - poses).max() > 10 * SOLVER_TOL


@pytest.mark.parametrize("log_scale", [0.0, -0.37])
def test_se3_to_sim3_matches_jax(log_scale):
    xi = np.random.default_rng(4).normal(size=6).astype(np.float32)
    want = np.asarray(jsim3.se3_to_sim3(jnp.asarray(xi), log_scale))
    got = sim3.se3_to_sim3(torch.as_tensor(xi), log_scale)
    assert got.dtype == torch.float32 and got.shape == (7,)
    np.testing.assert_array_equal(got.numpy(), want)
