"""The port's dense epipolar line stereo and EKF observation held against
the JAX package's dense path (``stereo_compact_frac=0``, u16-packed
samples, which are exact on integer-valued frames) on rendered frames.

Tolerances: the gather-free segment setup agrees to atol 1e-4 px with
equal codes.  After the walk, a pixel whose SSD minimum is a near-tie can
pick another step when the last bits of a sample differ, so up to 0.5 % of
the pixels may differ in code; where both succeed, inverse depth and
variance agree to rtol 1e-3 on 99 % of the pixels.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from egomotion_with_local_loop_closures_tpu.config import ELLCConfig as JCfg
from egomotion_with_local_loop_closures_tpu.depth import state as jstate
from egomotion_with_local_loop_closures_tpu.depth import stereo as jstereo
from egomotion_with_local_loop_closures_tpu.geom import camera as jcamera
from egomotion_with_local_loop_closures_tpu.geom import lie as jlie
from egomotion_with_local_loop_closures_tpu.image import interp as jinterp
from egomotion_with_local_loop_closures_tpu.image import pyramid as jpyr
from egomotion_with_local_loop_closures_tpu.utils import synthetic

from egomotion_with_local_loop_closures_tpu_torch.config import ELLCConfig
from egomotion_with_local_loop_closures_tpu_torch.depth import (
    state as dstate, stereo)
from egomotion_with_local_loop_closures_tpu_torch.geom import camera, lie
from egomotion_with_local_loop_closures_tpu_torch.image import pyramid

torch.set_num_threads(1)

KW = dict(rows=96, cols=128, fx=110.0, fy=110.0, cx=64.0, cy=48.0,
          stereo_compact_frac=0.0, stereo_pack_u8=False,
          bootstrap_rng="glibc")
JCFG, CFG = JCfg(**KW), ELLCConfig(**KW)
POSE = np.asarray([0.002, -0.001, 0.0, 0.04, 0.01, 0.0], np.float32)


def T(a):
    return torch.as_tensor(np.array(a))


@pytest.fixture(scope="module")
def frames():
    scene = synthetic.make_room_scene(seed=5, depth=1.2, half_width=1.6,
                                      half_height=1.1)
    fx, fy, cx, cy = JCFG.level_intrinsics(0)
    img0, depth0 = synthetic.render(scene, jnp.zeros(6), JCFG.rows,
                                    JCFG.cols, fx, fy, cx, cy)
    img1, _ = synthetic.render(scene, jnp.asarray(POSE), JCFG.rows,
                               JCFG.cols, fx, fy, cx, cy)
    img0, img1 = (np.round(np.asarray(i)).astype(np.float32)
                  for i in (img0, img1))
    gx, gy = jpyr.gradients(jnp.asarray(img0))
    mg = jpyr.max_abs_gradient(gx, gy)
    return dict(img0=img0, img1=img1, gx=np.asarray(gx), gy=np.asarray(gy),
                mg=np.asarray(mg), depth0=np.asarray(depth0))


def t_kf_from_cur():
    Tm = np.asarray(jlie.exp_se3(jnp.asarray(POSE)))
    return (-Tm[:3, :3].T @ Tm[:3, 3]).astype(np.float32)


def bands(f):
    """An update-style band around the true inverse depth."""
    gt = 1.0 / f["depth0"]
    return [np.maximum(gt - 0.3, 0.0).astype(np.float32),
            gt.astype(np.float32),
            np.minimum(gt + 0.3, 20.0).astype(np.float32)]


def test_argmin_takes_first_of_ties():
    a = torch.tensor([[3.0, 1.0], [1.0, 1.0], [1.0, 0.5], [2.0, 0.5]])
    assert torch.argmin(a, dim=0).tolist() == [1, 2]


def test_epl_direction_matches_jax(frames):
    t = t_kf_from_cur()
    ej = jstereo.epl_direction(jnp.asarray(frames["img0"]), jnp.asarray(t),
                               JCFG)
    et = stereo.epl_direction(T(frames["img0"]), T(t), CFG)
    np.testing.assert_allclose(np.asarray(ej[0]), et[0].numpy(), atol=1e-6)
    np.testing.assert_allclose(np.asarray(ej[1]), et[1].numpy(), atol=1e-6)
    np.testing.assert_array_equal(np.asarray(ej[2]), et[2].numpy())
    assert 0.1 < float(et[2].float().mean()) < 0.9


def test_segment_setup_and_descriptor_match_jax(frames):
    """The setup is elementwise and must agree; the port's exact 5-tap
    descriptor equals the JAX package's window-sampled one wherever the
    setup passes (rescale in (0.7, 1.4) keeps the taps inside the D=4
    window)."""
    H, W = frames["img0"].shape
    epx, epy, _ = jstereo.epl_direction(jnp.asarray(frames["img0"]),
                                        jnp.asarray(t_kf_from_cur()), JCFG)
    lo, prior, hi = bands(frames)
    x, y = jcamera.pixel_grid(H, W)
    sj = jstereo._segment_setup(x, y, epx, epy, jnp.asarray(lo),
                                jnp.asarray(prior), jnp.asarray(hi),
                                jnp.asarray(POSE), H, W, JCFG)
    xt, yt = camera.pixel_grid(H, W)
    st = stereo._segment_setup(xt, yt, T(epx), T(epy), T(lo), T(prior),
                               T(hi), T(POSE), H, W, CFG)
    np.testing.assert_array_equal(np.asarray(sj.code), st.code.numpy())
    ok = np.asarray(sj.code) == 0
    assert ok.mean() > 0.2
    for name in ("pfar_x", "pfar_y", "incx", "incy", "pclose_x", "pclose_y",
                 "rescale"):
        np.testing.assert_allclose(np.asarray(getattr(sj, name))[ok],
                                   getattr(st, name).numpy()[ok],
                                   atol=1e-4, err_msg=name)
    dj = jstereo._kf_descriptor(jnp.asarray(frames["img0"]), epx, epy,
                                sj.rescale, H, W)
    dt = stereo._kf_descriptor(T(frames["img0"]), T(epx), T(epy),
                               st.rescale, H, W)
    np.testing.assert_allclose(np.asarray(dj)[:, ok], dt.numpy()[:, ok],
                               atol=1e-3)


def test_line_stereo_matches_jax(frames):
    H, W = frames["img0"].shape
    epx, epy, ok = jstereo.epl_direction(jnp.asarray(frames["img0"]),
                                         jnp.asarray(t_kf_from_cur()), JCFG)
    lo, prior, hi = bands(frames)
    rj = jstereo.line_stereo(
        jnp.asarray(frames["img0"]), jnp.asarray(frames["gx"]),
        jnp.asarray(frames["gy"]),
        jinterp.pack_pairs_u16(jnp.asarray(frames["img1"])), epx, epy,
        jnp.asarray(lo), jnp.asarray(prior), jnp.asarray(hi),
        jnp.asarray(POSE), JCFG)
    rt = stereo.line_stereo(T(frames["img0"]), T(frames["gx"]),
                            T(frames["gy"]), T(frames["img1"]), T(epx),
                            T(epy), T(lo), T(prior), T(hi), T(POSE), CFG)
    cj, ct = np.asarray(rj.code), rt.code.numpy()
    gate = np.asarray(ok)
    assert np.mean(cj[gate] != ct[gate]) <= 0.005
    both = gate & (cj == 0) & (ct == 0)
    assert both.mean() > 0.1
    for name in ("idepth", "var"):
        a = np.asarray(getattr(rj, name))[both]
        b = getattr(rt, name).numpy()[both]
        rel = np.abs(a - b) / np.maximum(np.abs(a), 1e-6)
        assert np.mean(rel <= 1e-3) >= 0.99, name
    # and the successes triangulate the true depth
    gt = 1.0 / frames["depth0"][both]
    assert np.median(np.abs(rt.idepth.numpy()[both] - gt) / gt) < 0.02


def test_observe_matches_jax(frames):
    """Create and update paths from a glibc random init with holes (the
    holes are where new hypotheses get created)."""
    mg = frames["mg"]
    jst = jstate.initialize_random(jax.random.PRNGKey(0), jnp.asarray(mg),
                                   JCFG)
    hole = np.random.default_rng(1).uniform(size=mg.shape) < 0.4
    jst = jst._replace(valid=jst.valid & ~jnp.asarray(hole))
    tst = dstate.initialize_random(None, T(mg), CFG)
    tst = tst.replace(valid=tst.valid & ~T(hole))
    args_j = [jnp.asarray(frames[k]) for k in ("img0", "gx", "gy", "mg",
                                                "img1")]
    args_t = [T(frames[k]) for k in ("img0", "gx", "gy", "mg", "img1")]
    oj = jstereo.observe(jst, *args_j, jnp.asarray(POSE), JCFG)
    ot = stereo.observe(tst, *args_t, T(POSE), CFG)
    vj, vt = np.asarray(oj.state.valid), ot.state.valid.numpy()
    assert np.mean(vj != vt) <= 0.005
    assert abs(int(oj.num_created) - int(ot.num_created)) <= 0.005 * vj.size
    assert abs(int(oj.num_updated) - int(ot.num_updated)) <= 0.005 * vj.size
    assert int(ot.num_updated) > 0 and int(ot.num_created) > 0
    same = vj & vt
    for name in ("idepth", "var", "validity"):
        a = np.asarray(getattr(oj.state, name))[same]
        b = getattr(ot.state, name).numpy()[same]
        rel = np.abs(a - b) / np.maximum(np.abs(a), 1e-6)
        assert np.mean(rel <= 1e-3) >= 0.99, name
    np.testing.assert_array_equal(np.asarray(oj.state.blacklisted)[same],
                                  ot.state.blacklisted.numpy()[same])
