"""The port's synthetic scenes (utils/synthetic.py) and its CLI's
``--synthetic`` against the JAX package's.

Tolerances:

- the scene arrays and ``loop_trajectory`` are numpy draws of the same
  seed: equal bit for bit;
- ``trajectory`` chains float32 ``lie.compose`` over the frames: within
  5e-4 per component.  Near a rotation of 0.01 rad, log_se3's
  coefficient (1 - A/(2B))/theta^2 divides a float32 1 - cos(theta)
  whose relative rounding is ~1e-3, and XLA's and ATen's cos round that
  last bit differently; on the CLI's 65-frame walk the two part by 1.9e-4
  at frame 18 and stay there (3e-8 before it);
- ``render`` of the same poses: images within 2e-3 grey levels and depths
  within 1e-6 relative, except on at most 0.1 % of the pixels (a plane
  seam, where a ulp picks the other plane).  The texture's cos argument
  reaches ~200 rad, where float32 holds it to ~1.5e-5 rad, times
  amplitudes summing to ~100 grey levels in libraries that round cos
  differently; measured 2.4e-4 at 96x128 and 480x270;
- the CLI's ``--synthetic 17`` at its 96x128 default: ``poses_gt.txt``
  within the trajectory tolerance of the JAX CLI's, and the port's ATE no
  more than 1e-3 above the JAX CLI's (tests/data/port_golden_synthetic.json,
  written by ``tools/make_port_golden.py --synthetic``: the JAX CLI's ATE
  is 5.50e-3; the port's is 3.41e-3-3.54e-3 on the CPU at 1 and 4
  threads, with its torch or its glibc depth init).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from egomotion_with_local_loop_closures_tpu.utils import synthetic as jsyn

from egomotion_with_local_loop_closures_tpu_torch.runtime import cli
from egomotion_with_local_loop_closures_tpu_torch.utils import metrics
from egomotion_with_local_loop_closures_tpu_torch.utils import synthetic

torch.set_num_threads(1)

GOLDEN = os.path.join(os.path.dirname(__file__), "data",
                      "port_golden_synthetic.json")
TRAJ_TOL, IMG_TOL, DEPTH_RTOL, SEAM_FRAC, ATE_SLACK = (5e-4, 2e-3, 1e-6,
                                                       1e-3, 1e-3)
SCENE = dict(depth=1.25, half_width=1.7, half_height=1.15)
CAMERA = (96, 128, 110.0, 110.0, 64.0, 48.0)


@pytest.mark.parametrize("seed,harmonics", [(0, 24), (5, 8)])
def test_scene_equals_jax_bit_for_bit(seed, harmonics):
    want = jsyn.make_room_scene(seed=seed, num_harmonics=harmonics, **SCENE)
    got = synthetic.make_room_scene(seed=seed, num_harmonics=harmonics,
                                    **SCENE)
    for name, a, b in zip(want._fields, want, got):
        np.testing.assert_array_equal(b, a, err_msg=name)


def test_loop_trajectory_equals_jax_bit_for_bit():
    np.testing.assert_array_equal(synthetic.loop_trajectory(300, seed=3),
                                  jsyn.loop_trajectory(300, seed=3))


def test_trajectory_matches_jax():
    kw = dict(seed=0, rot_step=0.0015, trans_step=0.02)
    want = np.asarray(jsyn.trajectory(65, **kw))
    got = synthetic.trajectory(65, **kw)
    assert got.dtype == torch.float32 and got.shape == (65, 6)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TRAJ_TOL)
    np.testing.assert_array_equal(got[0].numpy(), np.zeros(6))


def test_render_matches_jax():
    scene = synthetic.make_room_scene(seed=2, **SCENE)
    poses = np.asarray(jsyn.trajectory(20, seed=1, rot_step=0.01,
                                       trans_step=0.05))[[0, 7, 19]]
    want = jax.vmap(lambda p: jsyn.render(scene, p, *CAMERA))(
        jnp.asarray(poses))
    img, depth = synthetic.render_sequence(scene, torch.as_tensor(poses),
                                           *CAMERA)
    assert img.shape == depth.shape == (3, 96, 128)
    d_img = np.abs(img.numpy() - np.asarray(want[0]))
    d_depth = np.abs(depth.numpy() / np.asarray(want[1]) - 1.0)
    off = (d_img > IMG_TOL) | (d_depth > DEPTH_RTOL)
    assert off.mean() <= SEAM_FRAC, (d_img.max(), d_depth.max())
    # one pose alone renders what the batch renders for it
    one = synthetic.render(scene, torch.as_tensor(poses[1]), *CAMERA)
    np.testing.assert_allclose(one[0].numpy(), img[1].numpy(), rtol=0,
                               atol=1e-4)
    assert float(img.min()) >= 0.0 and float(img.max()) <= 255.0


def test_cli_synthetic_matches_the_jax_cli(tmp_path):
    with open(GOLDEN) as f:
        golden = json.load(f)["cli_test"]
    out = tmp_path / "out"
    assert cli.main(golden["argv"] + ["--out", str(out),
                                      "--device", "cpu"]) == 0
    gt = np.loadtxt(out / "poses_gt.txt")
    np.testing.assert_allclose(gt, np.asarray(golden["poses_gt"]), rtol=0,
                               atol=TRAJ_TOL)
    orig = np.loadtxt(out / "poses_orig.txt")
    ids = orig[:, 0].astype(int)
    assert ids.tolist() == golden["frame_ids"]
    assert np.isfinite(orig).all() and (orig[:, 9] > 0).all()
    ate = float(metrics.ate_rmse(torch.as_tensor(orig[:, 2:8]),
                                 torch.as_tensor(gt[ids - 1])))
    assert ate <= golden["ate"] + ATE_SLACK, (ate, golden["ate"])
