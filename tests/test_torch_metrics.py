"""The port's accuracy metrics (utils/metrics.py) against the JAX
package's on the same numpy inputs.

Tolerances: angles within 1e-3 degrees on angles of 0.5 degrees and more
(float32 rotation_angle_deg goes through arccos/atan of nearly equal
rotations, which two libraries round differently); ATE within 1e-5
relative plus 1e-7 (a 3x3 SVD of float32 covariances, on trajectories
whose centres are not collinear, so the alignment's rotation is unique);
reprojection errors within 1e-4 px, and the point counts equal.  The
medians are held on even counts, where both average the middle two.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from egomotion_with_local_loop_closures_tpu.geom import lie as jlie
from egomotion_with_local_loop_closures_tpu.utils import metrics as jmetrics

from egomotion_with_local_loop_closures_tpu_torch.utils import metrics

torch.set_num_threads(1)

ANGLE_TOL, PX_TOL = 1e-3, 1e-4


def _rotations(seed, n, scale):
    w = (np.random.default_rng(seed).normal(size=(n, 3)) * scale).astype(
        np.float32)
    return np.array(jlie.exp_so3(jnp.asarray(w)))


def _assert_dicts(got, want, atol):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=0,
                                   atol=atol, err_msg=k)


@pytest.mark.parametrize("n", [6, 7])
def test_compare_rotations_matches_jax(n):
    """An even and an odd count; R2 is R1 with per-rotation noise of a few
    degrees, right-multiplied by a global rotation that the anchoring
    removes."""
    R1 = _rotations(1, n, 0.3)
    noise = _rotations(2, n, 0.05)
    g = np.array(jlie.exp_so3(jnp.asarray([0.4, -0.2, 0.1], jnp.float32)))
    R2 = (noise @ R1 @ g).astype(np.float32)
    want = jmetrics.compare_rotations(jnp.asarray(R1), jnp.asarray(R2))
    got = metrics.compare_rotations(torch.as_tensor(R1), torch.as_tensor(R2))
    e = np.asarray(jlie.rotation_angle_deg(
        jnp.asarray(R1), jnp.asarray(R2) @ (jnp.asarray(R2[0]).T
                                            @ jnp.asarray(R1[0]))))
    assert np.sort(e)[1] >= 0.5       # every angle but the anchor's
    _assert_dicts(got, want, ANGLE_TOL)


def test_median_averages_the_middle_pair():
    x = torch.tensor([4.0, 1.0, float("nan"), 3.0, 2.0])
    assert float(metrics._median(x)) == 2.5
    assert float(metrics._median(x)) == float(jnp.nanmedian(
        jnp.asarray(x.numpy())))


@pytest.mark.parametrize("align_scale", [True, False])
def test_ate_rmse_matches_jax(align_scale):
    """A curved, noisy trajectory against a scaled and rotated copy."""
    rng = np.random.default_rng(3)
    t = np.linspace(0, 2 * np.pi, 24)
    gt = np.zeros((24, 6), np.float32)
    gt[:, :3] = np.stack([0.2 * np.sin(t), 0.1 * t, 0.05 * np.cos(2 * t)], 1)
    gt[:, 3:] = np.stack([np.cos(t), 0.3 * np.sin(t), 0.5 * t], 1)
    est = (gt + rng.normal(size=gt.shape) * 0.01).astype(np.float32)
    est[:, 3:] *= 1.3
    want = float(jmetrics.ate_rmse(jnp.asarray(est), jnp.asarray(gt),
                                   align_scale=align_scale))
    got = float(metrics.ate_rmse(torch.as_tensor(est), torch.as_tensor(gt),
                                 align_scale=align_scale))
    assert want > 1e-3
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)
    assert float(metrics.ate_rmse(torch.as_tensor(gt),
                                  torch.as_tensor(gt))) < 1e-4


@pytest.mark.parametrize("masked", [False, True])
def test_reprojection_error_matches_jax(masked):
    rng = np.random.default_rng(5)
    depth = (1.5 + rng.uniform(size=(24, 32))).astype(np.float32)
    depth[rng.uniform(size=depth.shape) < 0.2] = 0.0
    if (depth > 0).sum() % 2:          # an even count for the median
        depth[tuple(np.argwhere(depth > 0)[0])] = 0.0
    gmask = np.zeros((24, 32), bool)
    gmask[4:12, 6:16] = True
    est = np.asarray([0.01, -0.004, 0.002, 0.03, 0.01, -0.02], np.float32)
    true = np.asarray([0.008, -0.002, 0.0, 0.02, 0.012, -0.01], np.float32)
    kw = dict(fx=30.0, fy=30.0, cx=16.0, cy=12.0)
    want = jmetrics.reprojection_error(
        jnp.asarray(est), jnp.asarray(depth), jnp.asarray(true),
        grad_mask=jnp.asarray(gmask) if masked else None, **kw)
    got = metrics.reprojection_error(
        torch.as_tensor(est), torch.as_tensor(depth), torch.as_tensor(true),
        grad_mask=torch.as_tensor(gmask) if masked else None, **kw)
    assert int(got["num_points"]) == int(want["num_points"])
    assert int(got["num_points"]) % 2 == 0 or masked
    _assert_dicts({k: v for k, v in got.items() if k != "num_points"},
                  {k: v for k, v in want.items() if k != "num_points"},
                  PX_TOL)


def test_reprojection_error_zero_for_true_pose():
    depth = torch.full((24, 32), 2.0)
    pose = torch.tensor([0.01, -0.004, 0.002, 0.03, 0.01, -0.02])
    out = metrics.reprojection_error(pose, depth, pose, 30.0, 30.0, 16.0,
                                     12.0)
    assert float(out["mean_px"]) < 1e-4
    assert int(out["num_points"]) == 24 * 32
