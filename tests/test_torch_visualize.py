"""The port's debug images (utils/visualize.py) against the JAX package's,
modelled on tests/test_visualize.py.

Tolerances: the colormap, the coloured depth map and the normalized
views equal the JAX package's bit for bit (the same numpy code);
``alignment_views`` on the same numpy inputs: the masks equal except on at
most 0.1 % of the pixels (a warp landing within a ulp of the image's
edge), warped and residual values within 1e-3 grey levels elsewhere
(float32 projection and bilinear weights rounded by two libraries).
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from egomotion_with_local_loop_closures_tpu.config import (
    ELLCConfig as JaxConfig)
from egomotion_with_local_loop_closures_tpu.utils import visualize as jvis

from egomotion_with_local_loop_closures_tpu_torch.config import ELLCConfig
from egomotion_with_local_loop_closures_tpu_torch.utils import (
    synthetic, visualize)

torch.set_num_threads(1)

CAMERA = dict(rows=96, cols=128, fx=110.0, fy=110.0, cx=64.0, cy=48.0)
CFG, JCFG = ELLCConfig(**CAMERA), JaxConfig(**CAMERA)
VIEW_TOL, MASK_FRAC = 1e-3, 1e-3


@pytest.fixture(scope="module")
def frames():
    """A keyframe image and depth and a current image 1 cm to the side,
    as numpy arrays."""
    scene = synthetic.make_room_scene(seed=2, depth=1.25, half_width=1.7,
                                      half_height=1.15)
    pose = np.asarray([0.0, 0.0, 0.0, 0.01, 0.0, 0.0], np.float32)
    img, depth = synthetic.render_sequence(
        scene, torch.as_tensor(np.stack([np.zeros(6, np.float32), pose])),
        96, 128, 110.0, 110.0, 64.0, 48.0)
    return img[0].numpy(), depth[0].numpy(), img[1].numpy(), pose


def test_jet_colormap_equals_jax():
    u8 = np.arange(256, dtype=np.uint8)
    rgb = visualize.jet_colormap(u8)
    np.testing.assert_array_equal(rgb, jvis.jet_colormap(u8))
    # JET(0) is deep blue, the sentinel of invalid depth
    assert rgb[0, 2] in (127, 128) and rgb[0, 0] == 0 and rgb[0, 1] == 0


def test_colour_depth_map_and_normalize_view_equal_jax():
    rng = np.random.default_rng(0)
    depth = rng.uniform(0, 3, (16, 20)).astype(np.float32)
    depth[rng.uniform(size=depth.shape) < 0.3] = 0.0
    gray = rng.uniform(0, 255, (16, 20)).astype(np.float32)
    rgb = visualize.colour_depth_map(depth, gray)
    np.testing.assert_array_equal(rgb, jvis.colour_depth_map(depth, gray))
    assert (rgb[depth == 0] == gray[depth == 0, None].astype(np.uint8)).all()
    for symmetric in (False, True):
        np.testing.assert_array_equal(
            visualize.normalize_view(gray - 100, symmetric),
            jvis.normalize_view(gray - 100, symmetric))


def test_alignment_views_match_jax(frames):
    kf_img, kf_depth, cur, pose = frames
    got = visualize.alignment_views(torch.as_tensor(kf_img),
                                    torch.as_tensor(kf_depth),
                                    torch.as_tensor(cur),
                                    torch.as_tensor(pose), CFG)
    want = jvis.alignment_views(jnp.asarray(kf_img), jnp.asarray(kf_depth),
                                jnp.asarray(cur), jnp.asarray(pose), JCFG)
    same = got["valid_mask"] == want["valid_mask"]
    assert (~same).mean() <= MASK_FRAC
    for name in ("warped", "residual"):
        np.testing.assert_allclose(got[name][same], want[name][same],
                                   rtol=0, atol=VIEW_TOL, err_msg=name)
    # at the true pose the warp reproduces the keyframe
    m = got["valid_mask"]
    assert m.mean() > 0.5 and np.median(np.abs(got["residual"][m])) < 3.0


def test_dump_frame_debug_and_plot(frames, tmp_path):
    kf_img, kf_depth, cur, pose = frames
    prefix = str(tmp_path / "dbg")
    visualize.dump_frame_debug(prefix, kf_img, kf_depth, cur, pose, CFG)
    for suffix in ("_depth.png", "_warped.png", "_residual.png"):
        assert os.path.getsize(prefix + suffix) > 0
    poses = np.asarray([[0, 0.01 * i, 0, 0.02 * i, 0, 0.01 * i]
                        for i in range(20)], np.float32)
    p = str(tmp_path / "traj.png")
    visualize.plot_trajectory(poses, p, gt_poses=poses)
    assert os.path.getsize(p) > 0
