"""The port's rotation averaging and per-batch correction held against the
JAX package on the same numpy inputs.

Tolerances: averaged rotations and corrected poses to 1e-4.  Both run the
same float32 solvers (the JAX package's x64 mode is off), with float64
host code in the same places; the JAX package pads the graph to
power-of-2 sizes, which changes the rounding of its solves a little.
"""

import warnings

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from egomotion_with_local_loop_closures_tpu.geom import lie as jlie
from egomotion_with_local_loop_closures_tpu.graph import batch as jbatch
from egomotion_with_local_loop_closures_tpu.graph import (
    rotation_averaging as jra)

from egomotion_with_local_loop_closures_tpu_torch.graph import (
    batch, rotation_averaging as ra)

torch.set_num_threads(1)


@pytest.mark.parametrize("seed,outliers", [(0, 0), (1, 4), (2, 8)])
def test_random_so3_graph_matches_jax(seed, outliers):
    """The port of RandomSO3Graph.m draws what the JAX package's draws
    from the same seed: the same edges, the rotations within a few
    float32 units in the last place (two libraries' exp_so3)."""
    want = jra.random_so3_graph(14, completeness=0.5, sigma=0.05,
                                num_outliers=outliers, seed=seed)
    got = ra.random_so3_graph(14, completeness=0.5, sigma=0.05,
                              num_outliers=outliers, seed=seed)
    np.testing.assert_array_equal(got[2], want[2])
    for a, b in zip(got[:2], want[:2]):
        assert a.dtype == b.dtype == np.float32 and a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=0, atol=2e-6)


@pytest.mark.parametrize("seed,outliers", [(0, 0), (1, 4), (2, 8)])
def test_average_so3_graph_matches_jax(seed, outliers):
    R_gt, RR, I = ra.random_so3_graph(14, completeness=0.5, sigma=0.05,
                                       num_outliers=outliers, seed=seed)
    want = jra.average_so3_graph(RR, I)
    got = ra.average_so3_graph(RR, I, "cpu")
    np.testing.assert_allclose(want, got, atol=1e-4)
    # and it averaged: every node within 10 degrees of the truth, up
    # to the global rotation R_i -> R_i G that R_ij = R_j R_i^T leaves free
    G = got[0].T @ R_gt[0]
    err = np.asarray(jlie.rotation_angle_deg(jnp.asarray(R_gt),
                                             jnp.asarray(got @ G)))
    assert err.max() < 10.0


def test_l1_init_and_irls_refine_match_jax():
    _, RR, I = ra.random_so3_graph(10, completeness=0.6, sigma=0.05,
                                    num_outliers=3, seed=3)
    QQ = np.asarray(jlie.quat_from_matrix(jnp.asarray(RR, jnp.float32)))
    Q0 = ra.spanning_tree_init(QQ, I, 10)
    np.testing.assert_array_equal(Q0, jra.spanning_tree_init(QQ, I, 10))
    Q0 = Q0.astype(np.float32)
    Qj = jra.l1_init(jnp.asarray(QQ), jnp.asarray(I), 10, jnp.asarray(Q0))
    Qt = ra.l1_init(torch.as_tensor(QQ), torch.as_tensor(I), 10,
                    torch.as_tensor(Q0))
    np.testing.assert_allclose(np.asarray(Qj), Qt.numpy(), atol=1e-4)
    Rj = jra.irls_refine(jnp.asarray(QQ), jnp.asarray(I), 10, Qj)
    Rt = ra.irls_refine(torch.as_tensor(QQ), torch.as_tensor(I), 10,
                        torch.as_tensor(np.asarray(Qj)))
    np.testing.assert_allclose(np.asarray(Rj), Rt.numpy(), atol=1e-4)


def test_largest_component_and_incidence():
    I = np.asarray([[0, 1, 3, 4, 5], [1, 2, 4, 5, 6]])
    np.testing.assert_array_equal(ra.largest_connected_component(I, 7),
                                  jra.largest_connected_component(I, 7))
    np.testing.assert_array_equal(
        ra._incidence(torch.as_tensor(I), 7).numpy(),
        np.asarray(jra._incidence(jnp.asarray(I), 7)))


def test_sanity_projection_errors_and_warning():
    _, RR, I = ra.random_so3_graph(6, seed=4)
    bad = RR.copy()
    bad[2] = -bad[2]                                  # det = -1
    with pytest.raises(ValueError, match="improper"):
        ra.average_so3_graph(bad, I, "cpu")
    far = RR.copy()
    far[1] = far[1] * 1.2
    with pytest.raises(ValueError, match="not a rotation"):
        ra.average_so3_graph(far, I, "cpu")
    near = RR.copy()
    near[1] = near[1] * 1.03
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        got = ra.average_so3_graph(near, I, "cpu")
    assert any("re-projection" in str(w.message) for w in caught)
    np.testing.assert_allclose(got, jra.average_so3_graph(near, I), atol=1e-4)


def synthetic_batch(seed=5, K=8, n=33):
    """A bootstrap-like batch: world poses of frames 1..n (frame 1 at the
    origin), per-frame odometry rows against the last keyframe (ids 1, K,
    2K, ...) with noise, and two noisy loop edges."""
    rng = np.random.default_rng(seed)
    steps = (rng.normal(size=(n, 6)) * [0.01, 0.01, 0.01, 0.03, 0.03, 0.03]
             ).astype(np.float32)
    steps[0] = 0.0
    world = [np.zeros(6, np.float32)]
    for s in steps[1:]:
        world.append(np.asarray(jlie.compose(jnp.asarray(s),
                                             jnp.asarray(world[-1]))))
    world = np.stack(world)

    def rel(f, k, noise):
        r = np.asarray(jlie.relative(jnp.asarray(world[f - 1]),
                                     jnp.asarray(world[k - 1])))
        return r + rng.normal(size=6).astype(np.float32) * noise

    pose_rows, odometry = [], []
    kf = 1
    for f in range(2, n + 1):
        pose_rows.append([f, kf, *world[f - 1]])
        odometry.append([f, kf, *rel(f, kf, 0.004)])
        if f % K == 0:
            kf = f
    pose_abs = np.asarray([[1, 1, 0, 0, 0, 0, 0, 0]]
                          + [[r[0], 1, *r[2:8]] for r in pose_rows])
    extra = np.asarray([[24, 1, *rel(24, 1, 0.002)],
                        [32, 8, *rel(32, 8, 0.002)]])
    return np.asarray(odometry), extra, pose_abs


@pytest.mark.parametrize("with_loops", [False, True])
def test_perform_rotation_averaging_matches_jax(with_loops):
    odometry, extra, pose_abs = synthetic_batch()
    extra = extra if with_loops else None
    want = jbatch.perform_rotation_averaging(odometry, extra, pose_abs, 1)
    got = batch.perform_rotation_averaging(odometry, extra, pose_abs, 1,
                                           "cpu")
    assert got.shape == (len(pose_abs), 7)
    np.testing.assert_array_equal(got[:, 0], pose_abs[:, 0])
    np.testing.assert_allclose(want, got, atol=1e-4)


def test_batch_edges_from_files_matches_jax():
    odometry, extra, _ = synthetic_batch()
    for go in (extra, None, extra[:0]):
        want = jbatch.batch_edges_from_files(None, odometry, go, 8)
        got = batch.batch_edges_from_files(odometry, go, 8)
        np.testing.assert_array_equal(want[0], got[0])
        assert (want[1] is None) == (got[1] is None)
        if got[1] is not None:
            np.testing.assert_array_equal(want[1], got[1])
