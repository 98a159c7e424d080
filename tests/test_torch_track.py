"""The port's Gauss-Newton aligner held against the JAX package's gather
path (``use_window_warp=False``) on the same rendered, integer-valued
frames.

Tolerances: one linearization's 6x6 system agrees to rtol 1e-4 (sums of
~10^4 float32 terms, reduced in different orders); the aligned pose after
32 iterations over four levels agrees to 1e-5 per twist component.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from egomotion_with_local_loop_closures_tpu.config import ELLCConfig as JCfg
from egomotion_with_local_loop_closures_tpu.image import pyramid as jpyr
from egomotion_with_local_loop_closures_tpu.track import alignment as jalign
from egomotion_with_local_loop_closures_tpu.utils import synthetic

from egomotion_with_local_loop_closures_tpu_torch.config import ELLCConfig
from egomotion_with_local_loop_closures_tpu_torch.image import pyramid
from egomotion_with_local_loop_closures_tpu_torch.track import alignment

torch.set_num_threads(1)

KW = dict(rows=96, cols=128, fx=110.0, fy=110.0, cx=64.0, cy=48.0,
          use_window_warp=False)
JCFG, CFG = JCfg(**KW), ELLCConfig(**KW)
TRUE = np.asarray([0.006, -0.004, 0.003, 0.015, -0.01, 0.008], np.float32)


@pytest.fixture(scope="module")
def pair():
    scene = synthetic.make_room_scene(seed=0)
    fx, fy, cx, cy = JCFG.level_intrinsics(0)
    img0, depth0 = synthetic.render(scene, jnp.zeros(6), JCFG.rows,
                                    JCFG.cols, fx, fy, cx, cy)
    img1, _ = synthetic.render(scene, jnp.asarray(TRUE), JCFG.rows,
                               JCFG.cols, fx, fy, cx, cy)
    img0, img1 = (np.round(np.asarray(i)).astype(np.float32)
                  for i in (img0, img1))
    rng = np.random.default_rng(0)
    hole = rng.uniform(size=img0.shape) < 0.2
    depth0 = np.where(hole, 0.0, np.asarray(depth0)).astype(np.float32)
    var0 = np.where(hole, -1.0, 0.0005 + 0.002 * rng.uniform(
        size=img0.shape)).astype(np.float32)
    kf_j = jalign.make_keyframe_levels(jnp.asarray(img0), jnp.asarray(depth0),
                                       jnp.asarray(var0), JCFG)
    cur_j = jalign.make_current_levels(jpyr.build_pyramid(jnp.asarray(img1),
                                                          4))
    kf_t = tuple(alignment.KeyframeLevel(*(torch.as_tensor(np.array(a))
                                           for a in lv)) for lv in kf_j)
    cur_t = alignment.make_current_levels(
        pyramid.build_pyramid(torch.as_tensor(img1), 4))
    return kf_j, cur_j, kf_t, cur_t


@pytest.mark.parametrize("level", [0, 1, 2, 3])
def test_gn_quantities_match_jax(pair, level):
    kf_j, cur_j, kf_t, cur_t = pair
    pose = 0.5 * TRUE
    intr = JCFG.level_intrinsics(level)
    Hj, gj, ej, nj, _ = jalign._gn_quantities(kf_j[level], cur_j[level],
                                              jnp.asarray(pose), intr, JCFG)
    Ht, gt, et, nt = alignment._gn_quantities(kf_t[level], cur_t[level],
                                              torch.as_tensor(pose), intr,
                                              CFG)
    scale = float(np.abs(np.asarray(Hj)).max())
    np.testing.assert_allclose(np.asarray(Hj), Ht.numpy(), rtol=1e-4,
                               atol=1e-5 * scale)
    gscale = float(np.abs(np.asarray(gj)).max())
    np.testing.assert_allclose(np.asarray(gj), gt.numpy(), rtol=1e-4,
                               atol=1e-5 * gscale)
    assert float(ej) == pytest.approx(float(et), rel=1e-4)
    assert float(nj) == float(nt) > 0


def test_align_matches_jax(pair):
    kf_j, cur_j, kf_t, cur_t = pair
    pj, dj = jalign.align(kf_j, cur_j, jnp.zeros(6), JCFG)
    pt, dt = alignment.align(kf_t, cur_t, torch.zeros(6), CFG)
    np.testing.assert_allclose(np.asarray(pj), pt.numpy(), atol=1e-5)
    np.testing.assert_array_equal(np.asarray(dj.iters_used),
                                  dt.iters_used.numpy())
    assert float(dj.valid_fraction) == pytest.approx(
        float(dt.valid_fraction), abs=1e-4)
    assert float(dt.oow_fraction) == 0.0
    # and it tracked the true motion
    np.testing.assert_allclose(pt.numpy(), TRUE, atol=2e-3)


def test_singular_system_gives_zero_update(pair):
    """A template with no depth: H = 0, the solve is NaN, the guard keeps
    the pose and freezes the level (PixelWisePyramid.cpp:451)."""
    kf_j, cur_j, kf_t, cur_t = pair
    empty = alignment.KeyframeLevel(kf_t[3].image,
                                    torch.zeros_like(kf_t[3].depth),
                                    kf_t[3].var)
    pose0 = torch.as_tensor(0.5 * TRUE)
    pose, wp, iters, _ = alignment.gn_level(empty, cur_t[3], pose0, 3, CFG, 4)
    # compose(0, pose) = log(exp(pose)): the pose up to float rounding
    torch.testing.assert_close(pose, pose0, atol=1e-6, rtol=0)
    assert int(iters) == 1 and float(wp) == 0.0
