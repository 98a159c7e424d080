"""K1, the tracker's Gauss-Newton iterations as two CUDA kernels
(``ops/gn_kernel.py``, ``csrc/gn_kernel.cu``: ``gn_level_cluster``, a
level in one launch, and ``gn_step``, an iteration a launch with its
linearize-only and finish-only modes), and its plain twin
(``track/alignment.py``).

Frames are the port's synthetic room rendered at TEST_CONFIG's 96x128 with
integer grey levels, a keyframe depth with 20 % holes and a seeded
variance; video v of a batch has its own keyframe pose, holes and motion.

- The plain twin on the CPU: a video of a batch (a NaN video among them)
  gets the bits it gets alone, and it agrees with the JAX package's
  ``_gn_quantities`` (rtol 1e-4 for H and g, as tests/test_torch_track.py)
  and ``align`` (1e-5 per twist component).
- The wrappers on CPU tensors run the plain version and launch nothing;
  the module imports without nvcc; the source sums no float with
  atomics, its atomics an integer ticket a video and the two live
  counts.
- The plain twin counts K1's live iterations (``profiling.k1_live``):
  over an align of three videos, each level's row holds at iteration i
  the videos whose level ran more than i updates (every video at
  iteration 0).
- The CUDA source built for the CPU with g++ (``tests/cuda_emulation.py``:
  a fiber per CUDA thread, shuffles and cluster barriers emulated; built
  with a cluster of 4 blocks of 128 threads, against the card's 8 of
  512): gn_step's linearization against the plain one (H within 1e-4 of
  its largest entry, g_i within 1e-4 sqrt(H_ii E), the energy within 1e-4
  relative, the used count exact: float32 sums of ~10^4 terms in another
  order), its finish against the plain iteration on the same H, g and
  pose (the pose within 1e-5 per component, iters and freeze flags
  equal), whole levels of both kernels at every level, a NaN video and
  videos that freeze mid-level, every video of a batch bit-equal to its
  own call, a repeated call bit-equal to the first (the tickets
  reset), and both kernels' live counts equal to the twin's.
- On a card (``-m cuda``; run there with ``python -m pytest
  tests/test_torch_gn_kernel.py -m cuda --noconftest``, since that
  machine has no jax: this file imports the JAX package only in a
  fixture) the same checks on the kernels themselves, and the launches
  a level: one gn_level_cluster launch, or one gn_step an iteration;
  the live counts of ``gn_level`` on the card equal the twin's table.
"""

import ctypes
import math
import re
from pathlib import Path

import cuda_emulation
import numpy as np
import pytest
import torch

from egomotion_with_local_loop_closures_tpu_torch.config import TEST_CONFIG
from egomotion_with_local_loop_closures_tpu_torch.depth import fusion
from egomotion_with_local_loop_closures_tpu_torch.image import pyramid
from egomotion_with_local_loop_closures_tpu_torch.ops import (
    gn_kernel, gn_reference)
from egomotion_with_local_loop_closures_tpu_torch.track import alignment
from egomotion_with_local_loop_closures_tpu_torch.utils import (
    profiling, synthetic)

torch.set_num_threads(1)

CFG = TEST_CONFIG
# H against its largest entry, g_i against sqrt(H_ii E), the energy
# relative; the pose after one finish or after a level, per component
SUM_TOL, POSE_TOL = 1e-4, 1e-5
MOTION = np.asarray([0.006, -0.004, 0.003, 0.015, -0.01, 0.008], np.float32)
TERM_W = torch.as_tensor(CFG.termination_weights)


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


def trajectories(kf, cur, pose0, level, n_iters):
    """The plain float32 iterations of a level on the planes' device and
    their float64 evaluation (``gn_reference.plain_trajectory``)."""
    f64 = [type(x)(*(t.double() for t in x)) for x in (kf, cur)]
    term_w = TERM_W.to(pose0.device)
    return (gn_reference.plain_trajectory(kf, cur, pose0, level, CFG,
                                          n_iters, term_w),
            gn_reference.plain_trajectory(*f64, pose0.double(), level, CFG,
                                          n_iters, term_w.double()))


def assert_bits(a, b):
    torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)


def assert_sums_close(got, want):
    """A kernel's (H, g, energy, count) against the plain
    linearization's."""
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


def _recount(iters, n_iters):
    """The videos live at the start of each of a level's ``n_iters``
    iterations, from the updates each applied (a live iteration applies
    one, a frozen video none)."""
    return [int((iters > i).sum()) for i in range(n_iters)]


def test_plain_align_counts_live_iterations(videos, monkeypatch):
    """An align of three videos on the CPU, a NaN video among them (it
    freezes after its first iteration at every level): each level's row
    of ``k1_live`` is the recount of ``iters_used``."""
    monkeypatch.setattr(profiling, "_k1_live", {})
    kf = [levels(videos, lv)[0] for lv in range(CFG.num_levels)]
    cur = [levels(videos, lv)[1] for lv in range(CFG.num_levels)]
    pose0 = torch.as_tensor(start_poses(3))
    pose0[1] = float("nan")
    _, diag = alignment.align(tuple(kf), tuple(cur), pose0, CFG)
    table = profiling.counters()["k1_live"]["cpu"]
    for lv, n_iters in enumerate(CFG.max_iters):
        assert table[lv][0] == 3
        assert table[lv][:n_iters] == _recount(diag.iters_used[:, lv],
                                               n_iters)
        assert not any(table[lv][n_iters:])
    assert any(row[1] == 2 for row in table)


# --- the wrappers on the CPU ---

def test_module_imports_without_nvcc_and_source_has_no_atomics():
    """The module imported above without building anything; the kernels
    sum no float with atomics: the atomics of the source are integer
    ones, gn_step's ticket, one counter a video, reset by the block that
    takes the last one, and each kernel's count of a live iteration into
    the int64 row of ``k1_live``."""
    assert gn_kernel._lib is None
    src = gn_kernel.SOURCE.read_text()
    code = re.sub(r"//[^\n]*", "", src)
    assert re.findall(r"atomic\w*", code) == ["atomicAdd"] * 3
    assert "atomicAdd(&a.tickets[v], 1)" in code
    assert "atomicAdd(a.live + a.iter, 1ull)" in code
    assert "atomicAdd(a.live + it, 1ull)" in code
    assert "unsigned long long* live;" in code
    assert "a.tickets[v] = 0;" in code
    assert code.count("__global__") == 2
    assert gn_kernel.wrapper_of(
        "_ZN12_GLOBAL__N_116gn_level_clusterENS_9LevelArgsE") == \
        "gn_level_cluster"
    assert gn_kernel.wrapper_of(
        "_ZN12_GLOBAL__N_17gn_stepENS_8StepArgsE") == "gn_step"
    assert gn_kernel.wrapper_of("_Z10reg_kernelILb1ELb0EEv4Args") is None


def test_cluster_shape_fits_the_card_and_levels_take_their_kernel():
    """The cluster is a portable one (at most 8 blocks) of whole warps
    within a block's 1,024 threads; at 270x480 levels 0 and 1 run
    gn_step and levels 2 and 3 gn_level_cluster; at TEST_CONFIG's 96x128
    only level 0 runs gn_step."""
    src = gn_kernel.SOURCE.read_text()
    shape = dict(re.findall(r"#define (ELLC_CLUSTER_\w+) (\d+)", src))
    blocks, threads = (int(shape[k]) for k in ("ELLC_CLUSTER_BLOCKS",
                                               "ELLC_CLUSTER_THREADS"))
    assert 1 <= blocks <= 8 and threads % 32 == 0 and threads <= 1024
    from egomotion_with_local_loop_closures_tpu_torch.config import (
        ELLCConfig)
    cfg = ELLCConfig()
    assert [gn_kernel.kernel_for(*cfg.level_shape(lv))
            for lv in range(cfg.num_levels)] == [
        "gn_step", "gn_step", "gn_level_cluster", "gn_level_cluster"]
    assert gn_kernel.align_launches(cfg) == {"gn_level_cluster": 2,
                                             "gn_step": 4 + 7}
    assert gn_kernel.align_launches(cfg, cfg.max_iters_replay) == {
        "gn_level_cluster": 2, "gn_step": 5 + 1}
    assert gn_kernel.align_launches(CFG) == {"gn_level_cluster": 3,
                                             "gn_step": 4}


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
    for kernel in gn_kernel.KERNELS:
        run = gn_kernel.run_level(kf, cur, poses, intr, CFG, 1, kernel)
        assert_bits(run.pose, lvl[0])
    assert gn_kernel.launches == {"gn_level_cluster": 0, "gn_step": 0}
    assert gn_kernel._lib is None


# --- the CUDA source built for the CPU ---

EMULATED_CLUSTER = ("ELLC_CLUSTER_BLOCKS=4", "ELLC_CLUSTER_THREADS=128")


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """K1's library built for the CPU (a cluster of 4 blocks of 128
    threads), as ``lin`` and ``fin`` functions of ``gn_kernel.iterate``'s
    signature (gn_step's two single modes) and ``level``, a whole level of
    either kernel with a workspace of its own unless one is given."""
    lib = gn_kernel.bind(ctypes.CDLL(str(cuda_emulation.build_for_cpu(
        gn_kernel.SOURCE, tmp_path_factory.mktemp("gn_kernel_cpu"), 2,
        EMULATED_CLUSTER))))

    def lin(kf, cur, pose, intr, cfg, y_offset=0, done=None):
        h, w = kf.image.shape[-2:]
        partials = torch.empty(pose.shape[:-1] + (gn_kernel.blocks(h, w),
                                                  gn_kernel.SUMS))
        gn_kernel._launch_step(lib, gn_kernel._LINEARIZE, done is None, pose,
                               gn_kernel.GNState(*(None,) * 5, done),
                               partials, cfg, 0, kf, cur, intr, y_offset)
        return partials

    def fin(partials, pose_in, st, cfg, first):
        gn_kernel._launch_step(lib, gn_kernel._FINISH, first, pose_in, st,
                               partials, cfg, 0)
        return st

    def level(kf, cur, pose0, level_, n_iters, kernel, ws=None, live=None):
        if ws is None:
            ws = gn_kernel.make_workspace(math.prod(pose0.shape[:-1]), "cpu")
        return gn_kernel.level_launches(lib, ws, kf, cur, pose0,
                                        CFG.level_intrinsics(level_), CFG,
                                        n_iters, kernel, 0, live)
    return lin, fin, level


@pytest.mark.parametrize("level", [0, 2])
@pytest.mark.parametrize("nvid", [1, 2])
def test_emulated_linearize_matches_plain(videos, emulated, level, nvid):
    lin, _, _ = emulated
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
    lin, _, _ = emulated
    kf, cur = levels(videos[1], 1)
    rows = slice(17, 48)
    block = alignment.KeyframeLevel(*(t[rows].contiguous() for t in kf))
    pose = torch.as_tensor(start_poses(2)[1])
    intr = CFG.level_intrinsics(1)
    assert_sums_close(
        gn_kernel.sums(lin(block, cur, pose, intr, CFG, y_offset=17)),
        alignment._gn_quantities(block, cur, pose, intr, CFG, y_offset=17))


def test_emulated_finish_matches_plain_on_the_same_system(videos, emulated):
    """The finish alone and the plain body on identical sums and poses,
    three videos: a first iteration, then one from a state where video 1
    is frozen, and a video whose H is zero (no depth): its step is
    zeroed, so its pose is composed with a zero update and it freezes."""
    lin, fin, _ = emulated
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


def test_plain_trajectory_gives_the_plain_level_and_the_rule_holds_it(
        videos):
    """``gn_reference``: the unfrozen plain iterations give the plain
    level (alignment.gn_level on the CPU) bit for bit, a NaN video
    included; ``level_agreement`` takes the plain level itself, and the
    plain state one iteration later for video 2, whose plain stop is at
    a metric within METRIC_TOL of 1, and refuses one that stops two
    iterations late, a pose moved by 2 POSE_TOL, a used count off by one,
    an energy or a termination metric off by twice its tolerance."""
    level, n_iters = 2, CFG.max_iters[2]
    kf, cur = levels(videos, level)
    pose0 = torch.as_tensor(start_poses(3))
    pose0[1] = float("nan")
    traj, traj64 = trajectories(kf, cur, pose0, level, n_iters)
    want = traj.level()
    pose, wp, iters, (energy, valid) = alignment.gn_level(
        kf, cur, pose0, level, CFG, n_iters)
    for a, b in zip((pose, wp, iters, energy, valid), want):
        assert_bits(a, b)
    assert want.iters.tolist()[1] == 1 and torch.isnan(want.pose[1]).all()
    assert gn_reference.level_agreement(want, traj, traj64, level,
                                        POSE_TOL) == (True, [])
    k = int(want.iters[2])
    assert k < n_iters and abs(float(traj.wp[k - 1, 2]) - 1.0) <= \
        gn_reference.METRIC_TOL[level]
    agrees, lines = gn_reference.level_agreement(
        traj.after(want.iters + torch.as_tensor([0, 0, 1])), traj, traj64,
        level, POSE_TOL)
    assert agrees and len(lines) == 1 and lines[0].startswith("video 2")
    assert int(want.iters[0]) + 2 <= n_iters
    late = want._replace(iters=want.iters + torch.as_tensor([2, 0, 0],
                                                            dtype=torch.int32))
    moved = want._replace(pose=want.pose + torch.as_tensor(
        [2 * POSE_TOL, 0, 0, 0, 0, 0])[None] * torch.as_tensor(
            [[1.0], [0.0], [0.0]]))
    off = 2.0 * gn_reference.METRIC_TOL[level] * want.wp_last.abs().clamp(
        min=1.0)
    for bad in (late, moved, want._replace(valid=want.valid + 1),
                want._replace(energy=want.energy * (
                    1.0 + 2.0 * gn_reference.ENERGY_TOL)),
                want._replace(wp_last=want.wp_last + off)):
        agrees, lines = gn_reference.level_agreement(
            bad, traj, traj64, level, POSE_TOL)
        assert not agrees and lines


@pytest.mark.parametrize("level", [0, 1, 2, 3])
def test_emulated_level_matches_plain(videos, emulated, level):
    """A whole level (its max_iters iterations) of each kernel for the
    three videos in one call, against the plain level and a float64
    evaluation of it: the same iteration counts, freeze flags and used
    counts, the pose within POSE_TOL of the plain one and the energy
    within SUM_TOL relative, or, where the plain float32 result itself
    lies farther from float64 (level 3 of video 2 stops at its 12th
    iteration unconverged, its pose 3.3e-5 from float64), within twice the
    plain result's distance from float64; the termination metric within
    ``gn_reference.METRIC_TOL[level]`` of the larger of the float64
    metric and 1, or as near float64.  No video parts from the plain stop
    here (``level_agreement`` would allow it only where the plain metric
    lies within METRIC_TOL[level] of 1)."""
    _, _, run = emulated
    n_iters = CFG.max_iters[level]
    kf, cur = levels(videos, level)
    pose0 = torch.as_tensor(start_poses(3))
    traj, traj64 = trajectories(kf, cur, pose0, level, n_iters)
    plain = traj.level()
    for kernel in gn_kernel.KERNELS:
        st = run(kf, cur, pose0, level, n_iters, kernel)
        assert gn_reference.level_agreement(st, traj, traj64, level,
                                            POSE_TOL) == (True, []), kernel
        assert torch.equal(st.iters, plain.iters)
        assert torch.equal(st.done, plain.done)
        assert torch.equal(st.valid, plain.valid)
        # the energy as before the rule: within SUM_TOL relative, or no
        # farther from float64 than twice the plain energy
        e64 = traj64.level().energy
        err = (st.energy.double() - e64).abs()
        plain_err = (plain.energy.double() - e64).abs()
        assert (((st.energy - plain.energy).abs()
                 <= SUM_TOL * plain.energy.abs())
                | (err <= 2.0 * plain_err)).all(), kernel


@pytest.mark.parametrize("kernel", ["gn_level_cluster", "gn_step"])
def test_emulated_level_freezes_a_nan_video_and_one_mid_level(
        videos, emulated, kernel):
    """Level 1 of a NaN video, a video that converges after a few
    iterations, and one that starts at its solution: the NaN video fails
    its first step (NaN H, so a zeroed step and a frozen NaN pose), and
    each video keeps the values of its last live iteration, as the plain
    level does."""
    _, _, run = emulated
    level, n_iters = 1, CFG.max_iters[1]
    kf, cur = levels([videos[0], videos[1], videos[2]], level)
    pose0 = torch.as_tensor(start_poses(3))
    pose0[0] = float("nan")
    pose0[2] = torch.as_tensor(alignment.gn_level(
        *levels(videos[2], level), pose0[2], level, CFG, n_iters)[0])
    traj, traj64 = trajectories(kf, cur, pose0, level, n_iters)
    plain = traj.level()
    st = run(kf, cur, pose0, level, n_iters, kernel)
    assert plain.iters.tolist()[0] == 1
    assert 1 < plain.iters.tolist()[1] < n_iters
    assert st.iters.tolist()[0] == 1 and st.done.tolist() == [1, 1, 1]
    assert torch.isnan(st.pose[0]).all() and torch.isnan(plain.pose[0]).all()
    assert gn_reference.level_agreement(st, traj, traj64, level,
                                        POSE_TOL) == (True, [])
    assert torch.equal(st.iters, plain.iters)
    assert torch.equal(st.valid, plain.valid)


def test_emulated_videos_equal_their_own_calls_bit_for_bit(videos, emulated):
    """Three videos and a NaN one in one call, of each kernel and of the
    two single modes: every output of every video equals its V = 1
    call's; a second identical call equals the first (gn_step's tickets
    were reset to 0)."""
    lin, fin, run = emulated
    vids = videos + [videos[1]]
    poses = torch.as_tensor(np.concatenate([start_poses(3), np.full(
        (1, 6), np.nan, np.float32)]))
    for level in (0, 2):
        kf, cur = levels(vids, level)
        intr = CFG.level_intrinsics(level)
        outs = {"modes": gn_kernel.iterate(kf, cur, poses, intr, CFG, 5,
                                           lin, fin)}
        ws = gn_kernel.make_workspace(4, "cpu")
        for kernel in gn_kernel.KERNELS:
            outs[kernel] = run(kf, cur, poses, level, 5, kernel, ws)
            again = run(kf, cur, poses, level, 5, kernel, ws)
            assert ws.tickets.tolist() == [0, 0, 0, 0]
            for a, b in zip(outs[kernel], again):
                assert_bits(a, b)
        for name, batch in outs.items():
            assert torch.isnan(batch.pose[3]).all()
            assert int(batch.done[3]) == 1
            for v, vid in enumerate(vids):
                kf1, cur1 = levels([vid], level)
                alone = (gn_kernel.iterate(kf1, cur1, poses[v:v + 1], intr,
                                           CFG, 5, lin, fin)
                         if name == "modes" else
                         run(kf1, cur1, poses[v:v + 1], level, 5, name))
                for a, b in zip(alone, batch):
                    assert_bits(a[0], b[v])


@pytest.mark.parametrize("kernel", ["gn_level_cluster", "gn_step"])
def test_emulated_live_counts_equal_the_twin(videos, emulated, kernel,
                                              monkeypatch):
    """Level 1 of a NaN video, a video that converges mid-level and one
    that starts at its solution: the kernel counts into a row of its own
    what the twin counts into its table's row, and no entry past the
    level's iterations."""
    monkeypatch.setattr(profiling, "_k1_live", {})
    _, _, run = emulated
    level, n_iters = 1, CFG.max_iters[1]
    kf, cur = levels(videos, level)
    pose0 = torch.as_tensor(start_poses(3))
    pose0[0] = float("nan")
    pose0[2] = alignment.gn_level(*levels(videos[2], level), pose0[2],
                                  level, CFG, n_iters)[0]
    profiling.reset_counters()
    iters = alignment.gn_level(kf, cur, pose0, level, CFG, n_iters)[2]
    want = profiling.counters()["k1_live"]["cpu"][level]
    assert want[:n_iters] == _recount(iters, n_iters)
    # the NaN video and the solved one freeze after one iteration, the
    # other video mid-level
    assert want[:2] == [3, 1] and want[n_iters - 1] == 0
    live = torch.zeros(len(want), dtype=torch.int64)
    st = run(kf, cur, pose0, level, n_iters, kernel, live=live)
    assert torch.equal(st.iters, iters)
    assert live.tolist() == want


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
    assert gn_kernel.launches == {"gn_level_cluster": 0, "gn_step": 1}
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
@pytest.mark.parametrize("level", [0, 1, 2, 3])
def test_cuda_level_two_launches_an_iteration_and_videos_bit_equal(
        videos, cuda_device, level):
    """V = 8 (the three videos repeated) in one call of each kernel at
    every level: one gn_level_cluster launch a level, or one gn_step
    launch an iteration; each video bit-equal to its V = 1 call and a
    repeated call bit-equal to the first; the level held to the plain
    level on the card by ``gn_reference.level_agreement``, and at level 1
    every video that keeps the plain stop within POSE_TOL of the plain
    level on the CPU; gn_level takes the kernel ``kernel_for`` names."""
    vids = [videos[v % 3] for v in range(8)]
    poses = torch.as_tensor(np.stack([start_poses(3)[v % 3]
                                      for v in range(8)]),
                            device=cuda_device)
    kf, cur = levels(vids, level, cuda_device)
    n_iters = CFG.max_iters[level]
    intr = CFG.level_intrinsics(level)
    cpu = [type(x)(*(t.cpu() for t in x)) for x in (kf, cur)]
    traj, traj64 = trajectories(kf, cur, poses, level, n_iters)
    want = gn_reference.plain_trajectory(*cpu, poses.cpu(), level, CFG,
                                         n_iters, TERM_W).level()
    for kernel in gn_kernel.KERNELS:
        gn_kernel.reset_launches()
        batch = gn_kernel.run_level(kf, cur, poses, intr, CFG, n_iters,
                                    kernel)
        again = gn_kernel.run_level(kf, cur, poses, intr, CFG, n_iters,
                                    kernel)
        torch.cuda.synchronize()
        per_call = 1 if kernel == "gn_level_cluster" else n_iters
        assert gn_kernel.launches[kernel] == 2 * per_call
        assert sum(gn_kernel.launches.values()) == 2 * per_call
        for a, b in zip(batch, again):
            assert_bits(a, b)
        agrees, lines = gn_reference.level_agreement(
            batch, traj, traj64, level, POSE_TOL)
        assert agrees, (kernel, lines)
        if level == 1:
            same = (batch.iters.cpu() == want.iters) & (
                batch.done.cpu() == want.done)
            torch.testing.assert_close(batch.pose.cpu()[same],
                                       want.pose[same], rtol=0,
                                       atol=POSE_TOL)
        for v in range(8):
            kf1, cur1 = levels(vids[v], level, cuda_device)
            alone = gn_kernel.run_level(kf1, cur1, poses[v], intr, CFG,
                                        n_iters, kernel)
            for a, b in zip(alone, batch):
                assert_bits(a, b[v])
    h, w = kf.image.shape[-2:]
    gn_kernel.reset_launches()
    alignment.gn_level(kf, cur, poses, level, CFG, n_iters)
    kernel = gn_kernel.kernel_for(h, w)
    assert gn_kernel.launches[kernel] == (
        1 if kernel == "gn_level_cluster" else n_iters)


@pytest.mark.cuda
def test_cuda_live_counts_equal_the_twin(videos, cuda_device, monkeypatch):
    """An align of the three videos and a NaN one on the card and on the
    CPU from the same inputs: the kernels' table equals the twin's, and
    each row the recount of the card's own updates."""
    monkeypatch.setattr(profiling, "_k1_live", {})
    vids = videos + [videos[1]]
    pose0 = torch.as_tensor(np.concatenate([start_poses(3), np.full(
        (1, 6), np.nan, np.float32)]))
    got = {}
    for dev in ("cpu", cuda_device):
        kf = tuple(levels(vids, lv, dev)[0] for lv in range(CFG.num_levels))
        cur = tuple(levels(vids, lv, dev)[1] for lv in range(CFG.num_levels))
        _, diag = alignment.align(kf, cur, pose0.to(dev), CFG)
        got[str(dev)] = diag.iters_used.cpu()
    table = profiling.counters()["k1_live"]
    card = table[str(torch.device("cuda", torch.cuda.current_device()))]
    assert card == table["cpu"]
    for lv, n_iters in enumerate(CFG.max_iters):
        assert card[lv][0] == 4
        assert card[lv][:n_iters] == _recount(got["cuda"][:, lv], n_iters)
