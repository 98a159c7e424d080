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
from egomotion_with_local_loop_closures_tpu.geom import lie as jlie
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
# weight_image: w_p = 1/(noise + var (dr/dd)^2) is ill-conditioned in
# float32 where (dr/dd)^2 is large: against a float64 evaluation the JAX
# package and the port are both up to 4.3e-6 (about 1e-4 relative) off at
# level 0, at 30 of 12,288 pixels.  So each side is held to float64, the
# port within twice the JAX package's error plus WI_ULPS units in the last
# place of the largest weight, and the two sides to each other within
# twice WI_RTOL, with at most WI_OFF_FRAC of the pixels past rtol 1e-5.
WI_ULPS, WI_RTOL, WI_OFF_FRAC = 4, 1e-4, 5e-3


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


# --- the constant-weight (inverse-compositional) rematch aligner (K5) ---
# Weight images and template Jacobians are per-pixel closed forms and
# agree to float32 rounding (rtol 1e-5 of each level's largest value);
# rematched poses after 32 iterations agree to 1e-4 per twist component.
# The batched calls stack three distinct keyframes (rendered at their own
# poses, each with its own holes and saved weights), so a candidate that
# read another's template, Jacobian, Hessian or points would disagree with
# its own JAX call.

KF_POSES = np.stack([np.zeros(6, np.float32),
                     [-0.004, 0.003, 0.0, -0.01, 0.012, 0.0],
                     [0.002, 0.006, -0.003, 0.02, 0.004, -0.006]]
                    ).astype(np.float32)


@pytest.fixture(scope="module")
def candidates(pair):
    """Three keyframes against the pair's current frame: the pair's own
    and two rendered elsewhere.  Returns the JAX and port keyframe levels
    and weight images (saved at each keyframe's true relative pose), the
    true relative poses, and starting poses: zero, halfway, and the
    solution itself, which converges first."""
    kf_j0, cur_j, kf_t0, cur_t = pair
    scene = synthetic.make_room_scene(seed=0)
    fx, fy, cx, cy = JCFG.level_intrinsics(0)
    kfs_j, kfs_t = [kf_j0], [kf_t0]
    for k in (1, 2):
        img, depth = synthetic.render(scene, jnp.asarray(KF_POSES[k]),
                                      JCFG.rows, JCFG.cols, fx, fy, cx, cy)
        img = np.round(np.asarray(img)).astype(np.float32)
        rng = np.random.default_rng(k)
        hole = rng.uniform(size=img.shape) < 0.2
        depth = np.where(hole, 0.0, np.asarray(depth)).astype(np.float32)
        var = np.where(hole, -1.0, 0.0005 + 0.002 * rng.uniform(
            size=img.shape)).astype(np.float32)
        kf_j = jalign.make_keyframe_levels(
            jnp.asarray(img), jnp.asarray(depth), jnp.asarray(var), JCFG)
        kfs_j.append(kf_j)
        kfs_t.append(tuple(alignment.KeyframeLevel(
            *(torch.as_tensor(np.array(a)) for a in lv)) for lv in kf_j))
    rels = np.stack([np.asarray(jlie.relative(jnp.asarray(TRUE),
                                              jnp.asarray(P)))
                     for P in KF_POSES])
    ws_j = [[jalign.weight_image(kf_j[l], cur_j[l], jnp.asarray(r), l, JCFG)
             for l in range(4)] for kf_j, r in zip(kfs_j, rels)]
    ws_t = [[torch.as_tensor(np.array(w)) for w in w_j] for w_j in ws_j]
    pose0s = np.stack([np.zeros(6, np.float32), 0.5 * rels[1], rels[2]]
                      ).astype(np.float32)
    return kfs_j, kfs_t, ws_j, ws_t, rels, pose0s


def _weight_image_f64(kf, cur, pose, level):
    """``weight_image``'s formula evaluated in float64 with numpy on the
    float32 inputs: the exact value that both float32 sides round."""
    fx, fy, cx, cy = CFG.level_intrinsics(level)
    img, depth, var = (np.asarray(a, np.float64) for a in kf)
    cimg, gx, gy = (np.asarray(a, np.float64) for a in cur)
    H, W = img.shape
    y, x = np.mgrid[0:H, 0:W].astype(np.float64)
    mask = depth > 0
    T = np.asarray(jlie.exp_se3(jnp.asarray(pose)), np.float64)
    Rm = np.asarray(alignment.lie.exp_se3(torch.as_tensor(
        np.asarray(pose, np.float64))))
    assert np.abs(Rm - T).max() < 1e-6
    P = np.stack([(x - cx) * depth / fx, (y - cy) * depth / fy, depth], -1)
    Pt = P @ Rm[:3, :3].T + Rm[:3, 3]
    z = Pt[..., 2]
    z = np.where(np.abs(z) < 1e-10, np.where(z < 0, -1e-10, 1e-10), z)
    wx, wy = Pt[..., 0] / z * fx + cx, Pt[..., 1] / z * fy + cy

    def sample(im):
        x0, y0 = np.floor(wx), np.floor(wy)
        ax, ay = wx - x0, wy - y0
        xs = [np.clip(v, -1, W).astype(np.int64) for v in (x0, np.ceil(wx))]
        ys = [np.clip(v, -1, H).astype(np.int64) for v in (y0, np.ceil(wy))]
        vals, inb = [], np.zeros(wx.shape, bool)
        for yi in ys:
            for xi in xs:
                ok = (xi >= 0) & (xi <= W - 1) & (yi >= 0) & (yi <= H - 1)
                vals.append(np.where(ok, im[yi.clip(0, H - 1),
                                            xi.clip(0, W - 1)], 0.0))
                inb |= ok
        top = (1 - ax) * vals[0] + ax * vals[1]
        bottom = (1 - ax) * vals[2] + ax * vals[3]
        return (1 - ay) * top + ay * bottom, inb

    warped, inb = sample(cimg)
    gxs, gys = fx * sample(gx)[0], fy * sample(gy)[0]
    inv_d = 1 / np.where(mask, depth, 1.0)
    r = np.where(inb, warped - img, 0.0)
    px, py, pz = Pt[..., 0], Pt[..., 1], Pt[..., 2]
    tx, ty, tz = Rm[:3, 3]
    pz2d = np.where(mask, pz * pz * inv_d, 1.0)
    drpdd = (gxs * (tx * pz - tz * px) / pz2d
             + gys * (ty * pz - tz * py) / pz2d)
    w_p = 1 / (CFG.camera_pixel_noise_2 + np.maximum(var, 0) * drpdd ** 2)
    wrp = np.abs(r * np.sqrt(w_p))
    half = CFG.huber_d / 2
    wh = np.where(wrp < half, 1.0, half / np.maximum(wrp, 1e-12))
    return np.where(mask & inb, wh * w_p, 0.0)


def _stack(levels, n=3):
    return tuple(alignment.KeyframeLevel(*(torch.stack([a] * n) for a in lv))
                 for lv in levels)


def _stack_candidates(kfs_t, ws_t, level):
    """The candidates' keyframe level and weight image along a leading B."""
    kf = alignment.KeyframeLevel(*(torch.stack(parts) for parts in zip(
        *(k[level] for k in kfs_t))))
    return kf, torch.stack([w[level] for w in ws_t])


@pytest.mark.parametrize("level", [0, 1, 2, 3])
def test_weight_image_and_template_jacobian_match_jax(pair, level):
    kf_j, cur_j, kf_t, cur_t = pair
    pose = 0.5 * TRUE
    wj = np.asarray(jalign.weight_image(kf_j[level], cur_j[level],
                                        jnp.asarray(pose), level, JCFG))
    wt = alignment.weight_image(kf_t[level], cur_t[level],
                                torch.as_tensor(pose), level, CFG).numpy()
    # both sides against a float64 evaluation of the same formula on the
    # same inputs (the current levels of both sides are equal bit for bit)
    for a, b in zip(cur_j[level], cur_t[level]):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    w64 = _weight_image_f64(kf_t[level], cur_t[level], pose, level)
    err_j, err_t = np.abs(wj - w64).max(), np.abs(wt - w64).max()
    assert err_t <= 2.0 * err_j + WI_ULPS * np.spacing(np.float32(w64.max()))
    # w_p's float32 conditioning leaves both sides ~1e-4 relative off
    # float64 at a few pixels, so they may part by twice that there
    np.testing.assert_allclose(wt, wj, rtol=2 * WI_RTOL, atol=0)
    off = ~np.isclose(wt, wj, rtol=1e-5, atol=1e-5 * wj.max())
    assert off.mean() <= WI_OFF_FRAC
    assert (wt > 0).mean() > 0.3
    Jj = np.asarray(jalign._template_jacobian(kf_j[level], level, JCFG))
    Jt = alignment._template_jacobian(kf_t[level], level, CFG)
    np.testing.assert_allclose(Jj, Jt.numpy(), rtol=1e-5,
                               atol=1e-5 * np.abs(Jj).max())
    # a leading candidate axis gives each candidate its own rows
    Jb = alignment._template_jacobian(_stack([kf_t[level]], 2)[0], level, CFG)
    assert torch.equal(Jb[1], Jt)


def test_gn_level_const_weight_freezes_per_candidate(pair, candidates):
    """Three distinct keyframes in one call against three JAX calls: the
    candidate that starts at its solution converges first, and its freeze
    does not stop the other two."""
    _, cur_j, _, cur_t = pair
    kfs_j, kfs_t, ws_j, ws_t, _, pose0s = candidates
    level = 1
    want = [jalign.gn_level_const_weight(kf_j[level], w_j[level],
                                         cur_j[level], jnp.asarray(p), level,
                                         JCFG, 7)
            for kf_j, w_j, p in zip(kfs_j, ws_j, pose0s)]
    kf_b, w_b = _stack_candidates(kfs_t, ws_t, level)
    pose, wp, iters = alignment.gn_level_const_weight(
        kf_b, w_b, cur_t[level], torch.as_tensor(pose0s), level, CFG, 7)
    np.testing.assert_array_equal([int(w[2]) for w in want], iters.numpy())
    assert len(set(iters.tolist())) > 1 and int(iters[2]) < int(iters[0])
    np.testing.assert_allclose(np.stack([np.asarray(w[0]) for w in want]),
                               pose.numpy(), atol=1e-4)


def test_align_const_weight_batch_matches_three_jax_calls(pair, candidates):
    _, cur_j, _, cur_t = pair
    kfs_j, kfs_t, ws_j, ws_t, rels, pose0s = candidates
    want = np.stack([np.asarray(jalign.align_const_weight_jit(
        kf_j, tuple(w_j), cur_j, jnp.asarray(p), JCFG)[0])
        for kf_j, w_j, p in zip(kfs_j, ws_j, pose0s)])
    stacked = [_stack_candidates(kfs_t, ws_t, l) for l in range(4)]
    got, wp = alignment.align_const_weight(
        tuple(k for k, _ in stacked), tuple(w for _, w in stacked), cur_t,
        torch.as_tensor(pose0s), CFG)
    assert got.shape == (3, 6) and wp.shape == (3,)
    np.testing.assert_allclose(want, got.numpy(), atol=1e-4)
    # every candidate lands on its own keyframe's true relative pose
    np.testing.assert_allclose(got.numpy(), rels, atol=2e-3)
