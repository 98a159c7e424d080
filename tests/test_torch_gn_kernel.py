"""K1, one Gauss-Newton iteration of the tracker as two CUDA kernels
(``ops/gn_kernel.py``, ``csrc/gn_kernel.cu``), and its plain twin
(``track/alignment.py``).

Frames are the port's synthetic room rendered at TEST_CONFIG's 96x128 with
integer grey levels, a keyframe depth with 20 % holes and a seeded
variance; video v of a batch has its own keyframe pose, holes and motion.

- The plain twin on the CPU: a video of a batch (a NaN video among them)
  gets the bits it gets alone, and it agrees with the JAX package's
  ``_gn_quantities`` (rtol 1e-4 for H and g, as tests/test_torch_track.py)
  and ``align`` (1e-5 per twist component).
- The wrappers on CPU tensors run the plain version and launch nothing;
  the module imports without nvcc; the source holds no atomics.
- The CUDA source built for the CPU with g++ (``tests/cuda_emulation.py``:
  a ``std::thread`` per CUDA thread, as tests/test_torch_reg_kernel_emulated.py
  builds K3): K1a's
  sums against the plain linearization (H within 1e-4 of its largest
  entry, g_i within 1e-4 sqrt(H_ii E), the energy within 1e-4 relative,
  the used count exact: float32 sums of ~10^4 terms in another order),
  K1b against the plain iteration on the same H, g and pose (the pose
  within 1e-5 per component, iters and freeze flags equal), whole levels
  and every video of a batch bit-equal to its own call.
- On a card (``-m cuda``; run there with ``python -m pytest
  tests/test_torch_gn_kernel.py -m cuda --noconftest``, since that
  machine has no jax: this file imports the JAX package only in a
  fixture) the same checks on the kernels themselves, and 2 launches per
  GN iteration.
"""

import ctypes
import math
import re

import cuda_emulation
import numpy as np
import pytest
import torch

from egomotion_with_local_loop_closures_tpu_torch.config import TEST_CONFIG
from egomotion_with_local_loop_closures_tpu_torch.depth import fusion
from egomotion_with_local_loop_closures_tpu_torch.image import pyramid
from egomotion_with_local_loop_closures_tpu_torch.ops import gn_kernel
from egomotion_with_local_loop_closures_tpu_torch.track import alignment
from egomotion_with_local_loop_closures_tpu_torch.utils import synthetic

torch.set_num_threads(1)

CFG = TEST_CONFIG
# H against its largest entry, g_i against sqrt(H_ii E), the energy
# relative; the pose after one K1b or after a level, per component
SUM_TOL, POSE_TOL = 1e-4, 1e-5
MOTION = np.asarray([0.006, -0.004, 0.003, 0.015, -0.01, 0.008], np.float32)


def make_video(v):
    """Keyframe levels, current levels and the true relative pose of video
    v, as numpy arrays: keyframe v sits at a seeded pose, the current
    frame at a seeded motion from it."""
    rng = np.random.default_rng(100 + v)
    scene = synthetic.make_room_scene(seed=0)
    kf_pose = (0.02 * rng.normal(size=6)).astype(np.float32)
    motion = (MOTION * (1.0 + 0.3 * v)).astype(np.float32)
    intr = CFG.level_intrinsics(0)
    img0, depth0 = synthetic.render(scene, torch.as_tensor(kf_pose),
                                    CFG.rows, CFG.cols, *intr)
    # the current camera at exp(motion) exp(kf_pose) w.r.t. the world
    from egomotion_with_local_loop_closures_tpu_torch.geom import lie
    cur_pose = lie.compose(torch.as_tensor(motion), torch.as_tensor(kf_pose))
    img1, _ = synthetic.render(scene, cur_pose, CFG.rows, CFG.cols, *intr)
    img0, img1 = (torch.round(i) for i in (img0, img1))
    hole = torch.as_tensor(rng.uniform(size=img0.shape) < 0.2)
    depth0 = torch.where(hole, 0.0, depth0)
    var0 = torch.where(hole, -1.0, torch.as_tensor(
        (0.0005 + 0.002 * rng.uniform(size=img0.shape)).astype(np.float32)))
    depths, vars_ = fusion.build_depth_var_pyramid(depth0, var0,
                                                   CFG.num_levels)
    kf = [(i, d, s) for i, d, s in zip(
        pyramid.build_pyramid(img0, CFG.num_levels), depths, vars_)]
    cur = alignment.make_current_levels(pyramid.build_pyramid(
        img1, CFG.num_levels))
    as_np = lambda lv: tuple(np.ascontiguousarray(t.numpy()) for t in lv)
    return [as_np(lv) for lv in kf], [as_np(lv) for lv in cur], motion


@pytest.fixture(scope="module")
def videos():
    return [make_video(v) for v in range(3)]


def levels(vids, level, device="cpu"):
    """(KeyframeLevel, CurrentLevel) of one video (a (kf, cur, motion)
    triple) or a stack of them, on ``device``."""
    one = isinstance(vids, tuple)
    vids = [vids] if one else vids

    def stack(k, i):
        a = np.stack([v[k][level][i] for v in vids])
        return torch.as_tensor(a[0] if one else a, device=device)
    return (alignment.KeyframeLevel(*(stack(0, i) for i in range(3))),
            alignment.CurrentLevel(*(stack(1, i) for i in range(3))))


def start_poses(n):
    """A seeded pose for each of n videos: half their true motion."""
    return np.stack([0.5 * MOTION * (1.0 + 0.3 * v) for v in range(n)]
                    ).astype(np.float32)


def assert_bits(a, b):
    torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)


def assert_sums_close(got, want):
    """K1a's (H, g, energy, count) against the plain linearization's."""
    Hg, gg, eg, ng = got
    Hw, gw, ew, nw = want
    scale = Hw.abs().amax(dim=(-2, -1), keepdim=True)
    assert ((Hg - Hw).abs() <= SUM_TOL * scale).all()
    g_scale = torch.sqrt(torch.diagonal(Hw, dim1=-2, dim2=-1) * ew[..., None])
    assert ((gg - gw).abs() <= SUM_TOL * g_scale).all()
    assert ((eg - ew).abs() <= SUM_TOL * ew.abs()).all()
    assert torch.equal(ng, nw)


# --- the plain twin on the CPU ---

@pytest.mark.parametrize("level", [0, 1, 2, 3])
def test_plain_twin_is_video_invariant_bit_for_bit(videos, level):
    """Three videos and a fourth whose pose is NaN, in one call: each
    video's linearization and level equal its own call's bits."""
    vids = videos + [videos[0]]
    poses = torch.as_tensor(np.concatenate([start_poses(3),
                                            np.full((1, 6), np.nan,
                                                    np.float32)]))
    kf, cur = levels(vids, level)
    intr = CFG.level_intrinsics(level)
    batch = alignment._gn_quantities(kf, cur, poses, intr, CFG)
    lvl = alignment.gn_level(kf, cur, poses, level, CFG, 3)
    assert torch.isnan(batch[0][3]).all()
    for v, vid in enumerate(vids):
        kf1, cur1 = levels(vid, level)
        alone = alignment._gn_quantities(kf1, cur1, poses[v], intr, CFG)
        for a, b in zip(alone, batch):
            assert_bits(a, b[v])
        lvl1 = alignment.gn_level(kf1, cur1, poses[v], level, CFG, 3)
        for a, b in zip((*lvl1[:3], *lvl1[3]), (*lvl[:3], *lvl[3])):
            assert_bits(a, b[v])


@pytest.fixture(scope="module")
def jax_mods():
    import jax.numpy as jnp
    from egomotion_with_local_loop_closures_tpu.config import (
        TEST_CONFIG as JCFG)
    from egomotion_with_local_loop_closures_tpu.track import alignment as ja
    return jnp, ja, JCFG.replace(use_window_warp=False)


def jax_levels(jnp, ja, vid):
    kf, cur, _ = vid
    return (tuple(ja.KeyframeLevel(*map(jnp.asarray, lv)) for lv in kf),
            tuple(ja.CurrentLevel(*map(jnp.asarray, lv)) for lv in cur))


@pytest.mark.parametrize("level", [0, 1, 2, 3])
def test_gn_quantities_match_jax(videos, jax_mods, level):
    jnp, ja, jcfg = jax_mods
    kf_j, cur_j = jax_levels(jnp, ja, videos[1])
    pose = start_poses(2)[1]
    intr = CFG.level_intrinsics(level)
    assert intr == jcfg.level_intrinsics(level)
    Hj, gj, ej, nj, _ = ja._gn_quantities(kf_j[level], cur_j[level],
                                          jnp.asarray(pose), intr, jcfg)
    kf, cur = levels(videos[1], level)
    Ht, gt, et, nt = gn_kernel.gn_quantities(kf, cur, torch.as_tensor(pose),
                                             intr, CFG)
    Hj, gj = np.asarray(Hj), np.asarray(gj)
    np.testing.assert_allclose(Ht.numpy(), Hj, rtol=1e-4,
                               atol=1e-5 * np.abs(Hj).max())
    np.testing.assert_allclose(gt.numpy(), gj, rtol=1e-4,
                               atol=1e-5 * np.abs(gj).max())
    assert float(et) == pytest.approx(float(ej), rel=1e-4)
    assert float(nt) == float(nj) > 0


@pytest.mark.parametrize("v", [0, 2])
def test_align_matches_jax(videos, jax_mods, v):
    jnp, ja, jcfg = jax_mods
    kf_j, cur_j = jax_levels(jnp, ja, videos[v])
    pj, dj = ja.align(kf_j, cur_j, jnp.zeros(6), jcfg)
    kf_t = tuple(levels(videos[v], lv)[0] for lv in range(CFG.num_levels))
    cur_t = tuple(levels(videos[v], lv)[1] for lv in range(CFG.num_levels))
    pt, dt = alignment.align(kf_t, cur_t, torch.zeros(6), CFG)
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(dt.iters_used.numpy(),
                                  np.asarray(dj.iters_used))
    # and it tracked the true motion
    np.testing.assert_allclose(pt.numpy(), videos[v][2], atol=3e-3)


def test_level_matches_jax_gn_level(videos, jax_mods):
    jnp, ja, jcfg = jax_mods
    kf_j, cur_j = jax_levels(jnp, ja, videos[0])
    pose = start_poses(1)[0]
    pj, wj, ij, (ej, nj, _) = ja.gn_level(kf_j[1], cur_j[1],
                                          jnp.asarray(pose), 1, jcfg, 7)
    kf, cur = levels(videos[0], 1)
    pt, wt, it, (et, nt) = gn_kernel.gn_level(kf, cur, torch.as_tensor(pose),
                                              1, CFG, 7)
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), rtol=0,
                               atol=POSE_TOL)
    assert int(it) == int(ij)
    assert float(nt) == float(nj)
    assert float(et) == pytest.approx(float(ej), rel=1e-4)


# --- the wrappers on the CPU ---

def test_module_imports_without_nvcc_and_source_has_no_atomics():
    """The module imported above without building anything; the kernels
    reduce in a fixed order, with no atomics of any kind."""
    assert gn_kernel._lib is None
    src = gn_kernel.SOURCE.read_text()
    code = re.sub(r"//[^\n]*", "", src)
    assert "atomic" not in code.lower() and "atomicAdd" not in src
    assert src.count("__global__") == 2
    assert gn_kernel.wrapper_of(
        "_ZN12_GLOBAL__N_112gn_linearizeENS_7LinArgsE") == "gn_linearize"
    assert gn_kernel.wrapper_of(
        "_ZN12_GLOBAL__N_19gn_finishENS_7FinArgsE") == "gn_finish"
    assert gn_kernel.wrapper_of("_Z10reg_kernelILb1ELb0EEv4Args") is None


def test_cpu_tensors_take_the_plain_path(videos):
    kf, cur = levels(videos[:2], 2)
    poses = torch.as_tensor(start_poses(2))
    intr = CFG.level_intrinsics(2)
    gn_kernel.reset_launches()
    partials = gn_kernel.linearize(kf, cur, poses, intr, CFG)
    assert partials.shape == (2, 1, gn_kernel.SUMS)
    want = alignment._gn_quantities(kf, cur, poses, intr, CFG)
    got = gn_kernel.sums(partials)
    for a, b in zip(got[1:], want[1:]):
        assert_bits(a, b)
    tri = torch.tril(torch.ones(6, 6, dtype=torch.bool))
    assert_bits(got[0][:, tri], want[0][:, tri])
    st = gn_kernel.finish(partials, poses, gn_kernel.empty_state(poses), CFG,
                          first=True)
    lvl = gn_kernel.gn_level(kf, cur, poses, 2, CFG, 1)
    assert_bits(st.pose, lvl[0])
    assert_bits(st.iters, lvl[2])
    assert gn_kernel.launches == {"gn_linearize": 0, "gn_finish": 0}
    assert gn_kernel._lib is None


# --- the CUDA source built for the CPU ---

@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """K1's library built for the CPU, and its two kernels as ``lin`` and
    ``fin`` functions of ``gn_kernel.iterate``'s signature."""
    lib = gn_kernel.bind(ctypes.CDLL(str(cuda_emulation.build_for_cpu(
        gn_kernel.SOURCE, tmp_path_factory.mktemp("gn_kernel_cpu"), 2))))

    def lin(kf, cur, pose, intr, cfg, y_offset=0, done=None):
        return gn_kernel._launch_linearize(lib, kf, cur, pose, intr, cfg,
                                           y_offset, done, 0)

    def fin(partials, pose_in, st, cfg, first):
        return gn_kernel._launch_finish(lib, partials, pose_in, st, cfg,
                                        first, 0)
    return lin, fin


@pytest.mark.parametrize("level", [0, 2])
@pytest.mark.parametrize("nvid", [1, 2])
def test_emulated_linearize_matches_plain(videos, emulated, level, nvid):
    lin, _ = emulated
    vids = videos[0] if nvid == 1 else videos[:nvid]
    kf, cur = levels(vids, level)
    pose = torch.as_tensor(start_poses(nvid)[0] if nvid == 1
                           else start_poses(nvid))
    intr = CFG.level_intrinsics(level)
    partials = lin(kf, cur, pose, intr, CFG)
    H, W = kf.image.shape[-2:]
    assert partials.shape[-2] == math.ceil(H * W / 256)
    assert_sums_close(gn_kernel.sums(partials),
                      alignment._gn_quantities(kf, cur, pose, intr, CFG))


def test_emulated_linearize_row_block_matches_plain(videos, emulated):
    """``y_offset``: rows 17..47 of level 1's template as those rows of
    the whole template, against the whole current level."""
    lin, _ = emulated
    kf, cur = levels(videos[1], 1)
    rows = slice(17, 48)
    block = alignment.KeyframeLevel(*(t[rows].contiguous() for t in kf))
    pose = torch.as_tensor(start_poses(2)[1])
    intr = CFG.level_intrinsics(1)
    assert_sums_close(
        gn_kernel.sums(lin(block, cur, pose, intr, CFG, y_offset=17)),
        alignment._gn_quantities(block, cur, pose, intr, CFG, y_offset=17))


def test_emulated_finish_matches_plain_on_the_same_system(videos, emulated):
    """K1b and the plain body on identical sums and poses, three videos:
    a first iteration, then one from a state where video 1 is frozen,
    and a video whose H is zero (no depth): its step is zeroed, so its
    pose is composed with a zero update and it freezes."""
    lin, fin = emulated
    kf, cur = levels(videos, 2)
    kf = kf._replace(depth=torch.where(torch.arange(3)[:, None, None] == 2,
                                       0.0, kf.depth))
    poses = torch.as_tensor(start_poses(3))
    intr = CFG.level_intrinsics(2)
    partials = lin(kf, cur, poses, intr, CFG)
    H, g, e, n = gn_kernel.sums(partials)
    one = gn_kernel.pack(H, g, e, n)[:, None, :]

    def check(got, want):
        torch.testing.assert_close(got.pose, want.pose, rtol=0,
                                   atol=POSE_TOL)
        for name in ("iters", "done", "valid"):
            assert torch.equal(getattr(got, name), getattr(want, name)), name
        torch.testing.assert_close(got.wp_last, want.wp_last, rtol=1e-4,
                                   atol=1e-4)
        assert_bits(got.energy, want.energy)

    got = fin(one, poses, gn_kernel.empty_state(poses), CFG, True)
    want = gn_kernel._update(H, g, e, n, poses, None,
                             torch.as_tensor(CFG.termination_weights))
    check(got, want)
    assert got.done.tolist()[2] == 1 and got.iters.tolist() == [1, 1, 1]
    torch.testing.assert_close(got.pose[2], poses[2], rtol=0, atol=1e-6)
    # a second iteration from a state with video 1 frozen
    st = want._replace(done=torch.as_tensor([0, 1, 1], dtype=torch.int32))
    kernel_st = gn_kernel.GNState(*(t.clone() for t in st))
    got2 = fin(one, kernel_st.pose, kernel_st, CFG, False)
    want2 = gn_kernel._update(H, g, e, n, st.pose, st,
                              torch.as_tensor(CFG.termination_weights))
    check(got2, want2)
    assert_bits(got2.pose[1:], st.pose[1:])
    assert got2.iters.tolist() == [2, 1, 1]


@pytest.mark.parametrize("level", [0, 1, 2, 3])
def test_emulated_level_matches_plain(videos, emulated, level):
    """A whole level (its max_iters iterations) for each video, against
    the plain level and a float64 evaluation of it: the same iteration
    counts and used counts, and the pose within POSE_TOL of the plain
    one (the energy within SUM_TOL relative), or, where the plain float32
    result itself lies farther from float64 (level 3 of video 2 stops at
    its 12th iteration unconverged, its pose 3.3e-5 from float64), within
    twice the plain result's distance from float64."""
    lin, fin = emulated
    n_iters = CFG.max_iters[level]
    for v, vid in enumerate(videos):
        kf, cur = levels(vid, level)
        pose0 = torch.as_tensor(start_poses(3)[v])
        st = gn_kernel.iterate(kf, cur, pose0, CFG.level_intrinsics(level),
                               CFG, n_iters, lin, fin)
        pose, wp, iters, (energy, valid) = alignment.gn_level(
            kf, cur, pose0, level, CFG, n_iters)
        pose64, _, _, (energy64, _) = alignment.gn_level(
            alignment.KeyframeLevel(*(t.double() for t in kf)),
            alignment.CurrentLevel(*(t.double() for t in cur)),
            pose0.double(), level, CFG, n_iters)
        for got, want, want64, tol in ((st.pose, pose, pose64, POSE_TOL),
                                       (st.energy, energy, energy64,
                                        SUM_TOL * float(energy))):
            err = float((got.double() - want64).abs().max())
            plain_err = float((want.double() - want64).abs().max())
            assert (float((got - want).abs().max()) <= tol
                    or err <= 2.0 * plain_err), (v, err, plain_err)
        assert int(st.iters) == int(iters) and float(st.valid) == float(valid)


def test_emulated_videos_equal_their_own_calls_bit_for_bit(videos, emulated):
    """Three videos and a NaN one in one call of each kernel per
    iteration: every output of every video equals its V = 1 call's."""
    lin, fin = emulated
    level = 2
    vids = videos + [videos[1]]
    poses = torch.as_tensor(np.concatenate([start_poses(3), np.full(
        (1, 6), np.nan, np.float32)]))
    intr = CFG.level_intrinsics(level)
    kf, cur = levels(vids, level)
    batch = gn_kernel.iterate(kf, cur, poses, intr, CFG, 5, lin, fin)
    assert torch.isnan(batch.pose[3]).all() and int(batch.done[3]) == 1
    for v, vid in enumerate(vids):
        kf1, cur1 = levels([vid], level)
        alone = gn_kernel.iterate(kf1, cur1, poses[v:v + 1], intr, CFG, 5,
                                  lin, fin)
        for a, b in zip(alone, batch):
            assert_bits(a[0], b[v])


# --- on the card ---

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc (K1 runs only on the GPU)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("level", [0, 1, 2, 3])
@pytest.mark.parametrize("nvid", [1, 3])
def test_cuda_linearize_matches_plain(videos, cuda_device, level, nvid):
    vids = videos[0] if nvid == 1 else videos[:nvid]
    kf, cur = levels(vids, level, cuda_device)
    pose = torch.as_tensor(start_poses(nvid)[0] if nvid == 1
                           else start_poses(nvid), device=cuda_device)
    intr = CFG.level_intrinsics(level)
    gn_kernel.reset_launches()
    got = gn_kernel.gn_quantities(kf, cur, pose, intr, CFG)
    torch.cuda.synchronize()
    assert gn_kernel.launches == {"gn_linearize": 1, "gn_finish": 0}
    assert_sums_close(got, alignment._gn_quantities(kf, cur, pose, intr,
                                                    CFG))


@pytest.mark.cuda
def test_cuda_finish_matches_plain_on_the_same_system(videos, cuda_device):
    kf, cur = levels(videos, 1, cuda_device)
    poses = torch.as_tensor(start_poses(3), device=cuda_device)
    H, g, e, n = alignment._gn_quantities(kf, cur, poses,
                                          CFG.level_intrinsics(1), CFG)
    one = torch.cat([H[:, [i for i, _ in gn_kernel.TRIL],
                       [j for _, j in gn_kernel.TRIL]], g, e[:, None],
                     n[:, None]], dim=-1)[:, None, :]
    got = gn_kernel.finish(one, poses, gn_kernel.empty_state(poses), CFG,
                           True)
    want = gn_kernel._update(H, g, e, n, poses, None, alignment.
                             _termination_weights(CFG.termination_weights,
                                                  torch.float32, cuda_device))
    torch.cuda.synchronize()
    torch.testing.assert_close(got.pose, want.pose, rtol=0, atol=POSE_TOL)
    assert torch.equal(got.iters, want.iters)
    assert torch.equal(got.done, want.done)


@pytest.mark.cuda
def test_cuda_level_two_launches_an_iteration_and_videos_bit_equal(
        videos, cuda_device):
    """V = 8 (the three videos repeated) in one call: two launches an
    iteration, each video bit-equal to its V = 1 call, and within 1e-5 of
    the plain level."""
    level = 1
    vids = [videos[v % 3] for v in range(8)]
    poses = torch.as_tensor(np.stack([start_poses(3)[v % 3]
                                      for v in range(8)]),
                            device=cuda_device)
    kf, cur = levels(vids, level, cuda_device)
    n_iters = CFG.max_iters[level]
    gn_kernel.reset_launches()
    batch = alignment.gn_level(kf, cur, poses, level, CFG, n_iters)
    torch.cuda.synchronize()
    assert gn_kernel.launches == {"gn_linearize": n_iters,
                                  "gn_finish": n_iters}
    want = alignment.gn_level(*(type(x)(*(t.cpu() for t in x))
                                for x in (kf, cur)), poses.cpu(), level, CFG,
                              n_iters)
    torch.testing.assert_close(batch[0].cpu(), want[0], rtol=0,
                               atol=POSE_TOL)
    for v in range(8):
        kf1, cur1 = levels(vids[v], level, cuda_device)
        alone = alignment.gn_level(kf1, cur1, poses[v], level, CFG, n_iters)
        for a, b in zip((*alone[:3], *alone[3]),
                        (*batch[:3], *batch[3])):
            assert_bits(a, b[v])
