"""The port's multi-video batched pipeline (``parallel/sharded.py``) and
its footprint check (``utils/footprint.py``), at TEST_CONFIG on the CPU
under the parity config.

- (a) Each module that takes a video axis, on V = 3 numpy-seeded inputs,
  against its single-video call on each slice.  Tolerance 0: bit for bit.
  The gathers and elementwise ops are equal by construction.  The GN
  system of ``align`` is one (6, N) x (N, 7) product per video, and the
  small Lie-group products are sums of elementwise products
  (``geom.lie.mm``).  So on one CPU thread every video gets the bits it
  gets alone.  This held on every case tried.
- (b) ``batched_init`` against ``init_pipeline`` video by video, bit for
  bit, under the glibc bootstrap and with one generator per video.
- (c) ``batched_process_interval`` against the port's serial
  ``process_interval``.  Two intervals (7 and 8 frames), V = 3, the videos
  taken from ``tests/data/port_lc_test_frames.npz`` at offsets 0, 14 and
  28, from the JAX package's batched init state.  Measured: equal bit
  for bit on one CPU thread, so the tolerance is 0.
- (d) The same run against the JAX package's batched path
  (``tests/data/port_golden_batched_test.json``, written with the init
  state's arrays by ``tools/make_port_golden.py --batched-test``).  It
  allows 2e-3 per pose component, the JAX package's own tolerance for vmap
  against serial (``tests/test_parallel.py``), 1 seeds% point and rtol
  1e-3 on the rescale factors.
- (e) One batched interval makes as many ``align``, ``observe`` and K3
  wrapper calls at V = 3 as at V = 1: there is no loop over videos.
- (f) ``utils/footprint.py`` on the CPU.
- (g) ``parallel.sharded`` and ``utils.footprint`` import without jax.
- (h) On a CUDA card (skipped here): a batched interval against the
  single-video one, and K3 on a (V, H, W) batch of pipeline states
  against its plain version.

The JAX package's runs come from the golden file: this file does not
import jax.
"""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from egomotion_with_local_loop_closures_tpu_torch import convert
from egomotion_with_local_loop_closures_tpu_torch.config import (
    PARITY_OVERRIDES, TEST_CONFIG)
from egomotion_with_local_loop_closures_tpu_torch.depth import (
    fusion, propagate, state as dstate, stereo)
from egomotion_with_local_loop_closures_tpu_torch.image import (interp,
                                                                pyramid)
from egomotion_with_local_loop_closures_tpu_torch.ops import (
    gn_kernel, reg_kernel, stereo_kernel)
from egomotion_with_local_loop_closures_tpu_torch.parallel import sharded
from egomotion_with_local_loop_closures_tpu_torch.runtime import (
    checkpoint, pipeline)
from egomotion_with_local_loop_closures_tpu_torch.track import alignment
from egomotion_with_local_loop_closures_tpu_torch.utils import footprint

torch.set_num_threads(1)

CFG = TEST_CONFIG.replace(**PARITY_OVERRIDES)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, "tests", "data")
V = 3
POSE_TOL, SEEDS_TOL, RESCALE_RTOL = 2e-3, 1.0, 1e-3


@pytest.fixture(scope="module")
def golden():
    with open(os.path.join(DATA, "port_golden_batched_test.json")) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def videos(golden):
    """(V, 16, H, W) frames: video v starts at the golden file's offset."""
    frames = np.load(os.path.join(ROOT, golden["frames_file"]))[
        "frames"].astype(np.float32)
    n = golden["frames_per_video"]
    return np.stack([frames[o:o + n] for o in golden["offsets"]])


def flat(tree, prefix=""):
    """Nested dicts and lists of arrays -> {field path: array}: the
    inverse of :func:`nest`."""
    if not isinstance(tree, (dict, list)):
        return {prefix[:-1]: tree}
    out = {}
    for k, v in (tree.items() if isinstance(tree, dict)
                 else enumerate(tree)):
        out.update(flat(v, f"{prefix}{k}."))
    return out


def nest(flat):
    """{field path: array} -> nested dicts, numbered paths as lists."""
    tree = {}
    for path, a in flat.items():
        node, keys = tree, path.split(".")
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = a

    def lists(node):
        if not isinstance(node, dict):
            return node
        if all(k.isdigit() for k in node):
            return [lists(node[str(i)]) for i in range(len(node))]
        return {k: lists(v) for k, v in node.items()}
    return lists(tree)


def assert_equal(got, ref, what=""):
    """Bit for bit, NaN equal to NaN, over tensors or states."""
    if isinstance(ref, torch.Tensor):
        torch.testing.assert_close(got, ref, rtol=0, atol=0, equal_nan=True,
                                   msg=lambda m: f"{what}: {m}")
    elif isinstance(ref, tuple):
        assert len(got) == len(ref), what
        for i, (g, r) in enumerate(zip(got, ref)):
            assert_equal(g, r, f"{what}[{i}]")
    else:
        for f in dataclasses.fields(ref):
            assert_equal(getattr(got, f.name), getattr(ref, f.name),
                         f"{what}.{f.name}")


def one(tree, v):
    """Slice ``v`` of every tensor of a batched result (tensors, tuples
    and dataclasses of them)."""
    if isinstance(tree, torch.Tensor):
        return tree[v]
    if isinstance(tree, tuple):
        return tuple(one(t, v) for t in tree)
    return dataclasses.replace(tree, **{
        f.name: one(getattr(tree, f.name), v)
        for f in dataclasses.fields(tree)})


# ------------------------------------------------- (a) module by module

def _state(rng, maxgrad):
    """A hypothesis state: the glibc init on ``maxgrad`` with seeded
    smoothed planes, validity and blacklist counts."""
    st = dstate.initialize_random(None, maxgrad, CFG)
    shape = tuple(maxgrad.shape)
    noise = torch.as_tensor(rng.uniform(0.9, 1.1, shape).astype(np.float32))
    return st.replace(
        idepth_smoothed=torch.where(st.valid, st.idepth * noise, -1.0),
        var_smoothed=torch.where(st.valid, st.var * noise, -1.0),
        validity=torch.where(st.valid, torch.as_tensor(
            rng.uniform(1.0, 40.0, shape).astype(np.float32)), 0.0),
        blacklisted=torch.as_tensor(rng.integers(-2, 2, shape).astype(
            np.int32)))


def _poses(rng, scale=(0.004, 0.02)):
    return torch.as_tensor(np.concatenate(
        [rng.normal(0.0, scale[0], (V, 3)), rng.normal(0.0, scale[1], (V, 3))],
        axis=-1).astype(np.float32))


def case_bilinear(rng, frames):
    imgs = torch.as_tensor(rng.uniform(0.0, 255.0, (V,) + CFG.shape)
                           .astype(np.float32))
    H, W = CFG.shape
    x = torch.as_tensor(rng.uniform(-3.0, W + 2.0, (V, 40, 50))
                        .astype(np.float32))
    y = torch.as_tensor(rng.uniform(-3.0, H + 2.0, (V, 40, 50))
                        .astype(np.float32))
    # the stereo walk's layout: the step axis before the video axis
    xs = torch.as_tensor(rng.uniform(-3.0, W + 2.0, (7, V, 20, 30))
                         .astype(np.float32))
    ys = torch.as_tensor(rng.uniform(-3.0, H + 2.0, (7, V, 20, 30))
                         .astype(np.float32))
    return (lambda: (interp.bilinear(imgs, x, y),
                     interp.bilinear_fill(imgs, xs, ys).movedim(1, 0)),
            lambda v: (interp.bilinear(imgs[v], x[v], y[v]),
                       interp.bilinear_fill(imgs[v], xs[:, v], ys[:, v])))


def case_build_pyramid(rng, frames):
    imgs = torch.as_tensor(frames[:, 0])

    def run(im):
        levels = tuple(pyramid.build_pyramid(im, CFG.num_levels))
        gx, gy = pyramid.gradients(im)
        return levels, pyramid.max_abs_gradient(gx, gy)
    return lambda: run(imgs), lambda v: run(imgs[v])


def case_align(rng, frames):
    kf_img = torch.as_tensor(frames[:, 0])
    cur_img = torch.as_tensor(frames[:, 2])
    # the last video's frame is NaN: its every GN step is zeroed, which
    # must not stop the other videos
    cur_img[-1] = float("nan")
    shape = (V,) + CFG.shape
    depth = torch.as_tensor(np.where(rng.uniform(size=shape) < 0.6,
                                     rng.uniform(0.8, 1.5, shape), 0.0)
                            .astype(np.float32))
    var = torch.as_tensor(np.where(depth > 0, rng.uniform(1e-3, 1e-2, shape),
                                   -1.0).astype(np.float32))
    pose0 = _poses(rng, (0.002, 0.01))

    def run(kf_i, d, s, cur_i, p):
        depths, vars_ = fusion.build_depth_var_pyramid(d, s, CFG.num_levels)
        kf = tuple(alignment.KeyframeLevel(*lv) for lv in zip(
            pyramid.build_pyramid(kf_i, CFG.num_levels), depths, vars_))
        cur = alignment.make_current_levels(
            pyramid.build_pyramid(cur_i, CFG.num_levels))
        return alignment.align(kf, cur, p, CFG)
    return (lambda: run(kf_img, depth, var, cur_img, pose0),
            lambda v: run(kf_img[v], depth[v], var[v], cur_img[v],
                          pose0[v]))


def case_observe(rng, frames):
    kf_img = torch.as_tensor(frames[:, 0])
    cur_img = torch.as_tensor(frames[:, 1])
    gx, gy = pyramid.gradients(kf_img)
    mg = pyramid.max_abs_gradient(gx, gy)
    st = _state(rng, mg)
    pose = _poses(rng)

    def run(s, ki, kx, ky, m, ci, p):
        return stereo.observe(s, ki, kx, ky, m, ci, p, CFG)
    return (lambda: run(st, kf_img, gx, gy, mg, cur_img, pose),
            lambda v: run(one(st, v), kf_img[v], gx[v], gy[v], mg[v],
                          cur_img[v], pose[v]))


def case_propagate(rng, frames):
    old_img = torch.as_tensor(frames[:, 0])
    new_img = torch.as_tensor(frames[:, 3])
    gx, gy = pyramid.gradients(old_img)
    st = _state(rng, pyramid.max_abs_gradient(gx, gy))
    ngx, ngy = pyramid.gradients(new_img)
    new_mg = pyramid.max_abs_gradient(ngx, ngy)
    pose = _poses(rng)
    return (lambda: propagate.propagate(st, old_img, new_img, new_mg, pose,
                                        CFG),
            lambda v: propagate.propagate(one(st, v), old_img[v], new_img[v],
                                          new_mg[v], pose[v], CFG))


def case_build_depth_var_pyramid(rng, frames):
    shape = (V,) + CFG.shape
    depth = torch.as_tensor(np.where(rng.uniform(size=shape) < 0.5,
                                     rng.uniform(0.5, 2.0, shape), 0.0)
                            .astype(np.float32))
    var = torch.as_tensor(np.where(depth > 0, rng.uniform(1e-3, 1e-1, shape),
                                   -1.0).astype(np.float32))

    def run(d, s):
        return tuple(map(tuple, fusion.build_depth_var_pyramid(
            d, s, CFG.num_levels)))
    return lambda: run(depth, var), lambda v: run(depth[v], var[v])


def case_to_depth_image(rng, frames):
    gx, gy = pyramid.gradients(torch.as_tensor(frames[:, 0]))
    st = _state(rng, pyramid.max_abs_gradient(gx, gy))
    return (lambda: dstate.to_depth_image(st, CFG),
            lambda v: dstate.to_depth_image(one(st, v), CFG))


def case_initialize_random_glibc(rng, frames):
    gx, gy = pyramid.gradients(torch.as_tensor(frames[:, 0]))
    mg = pyramid.max_abs_gradient(gx, gy)
    return (lambda: dstate.initialize_random(None, mg, CFG),
            lambda v: dstate.initialize_random(None, mg[v], CFG))


def case_initialize_random_generator(rng, frames):
    gx, gy = pyramid.gradients(torch.as_tensor(frames[:, 0]))
    mg = pyramid.max_abs_gradient(gx, gy)
    cfg = CFG.replace(bootstrap_rng="jax")
    seeds = rng.integers(0, 2 ** 31, V)

    def gen(v):
        return torch.Generator().manual_seed(int(seeds[v]))
    return (lambda: dstate.initialize_random([gen(v) for v in range(V)], mg,
                                             cfg),
            lambda v: dstate.initialize_random(gen(v), mg[v], cfg))


CASES = [case_bilinear, case_build_pyramid, case_align, case_observe,
         case_propagate, case_build_depth_var_pyramid, case_to_depth_image,
         case_initialize_random_glibc, case_initialize_random_generator]


@pytest.mark.parametrize("case", CASES, ids=lambda c: c.__name__[5:])
def test_batched_module_equals_each_video_alone(case, videos):
    """Slice v of the batched call equals the single-video call on
    slice v of the inputs, bit for bit (tolerance 0 measured for every
    case, ``align`` included)."""
    rng = np.random.default_rng(sorted(c.__name__ for c in CASES).index(
        case.__name__))
    batched, single = case(rng, videos)
    got = batched()
    for v in range(V):
        assert_equal(one(got, v), single(v), f"{case.__name__} video {v}")


# ------------------------------------------------------ (b) batched_init

@pytest.mark.parametrize("rng_kind", ["glibc", "jax"])
def test_batched_init_equals_init_pipeline(rng_kind, videos):
    cfg = CFG.replace(bootstrap_rng=rng_kind)

    def gens():
        return [torch.Generator().manual_seed(100 + v) for v in range(V)]
    states = sharded.batched_init(videos[:, 0], cfg, "cpu", gens())
    assert states.prev_wrt_kf.shape == (V, 6)
    assert states.depth.valid.shape == (V,) + CFG.shape
    for v, (got, g) in enumerate(zip(sharded.unstack_states(states),
                                     gens())):
        assert_equal(got, pipeline.init_pipeline(videos[v, 0], cfg, "cpu", g),
                     f"video {v}")
    assert_equal(sharded.stack_states(sharded.unstack_states(states)), states)


# -------------------------------------- (c), (d) batched_process_interval

@pytest.fixture(scope="module")
def jax_init_tree(golden):
    with np.load(os.path.join(ROOT, golden["arrays_file"])) as z:
        return nest({k: z[k] for k in z.files})


@pytest.fixture(scope="module")
def batched_run(jax_init_tree, videos):
    """Two batched intervals (7 and 8 frames) from the JAX package's
    batched init state, converted."""
    states = convert.to_port(jax_init_tree, "cpu")
    outs = []
    for a, b in ((1, 8), (8, 16)):
        states, o = sharded.batched_process_interval(states, videos[:, a:b],
                                                     CFG)
        outs.append(o)
    return states, outs


def test_batched_interval_equals_serial(jax_init_tree, videos, batched_run):
    """Each video of the batched run equals the port's serial run of that
    video, outputs and final state bit for bit (measured on one CPU
    thread)."""
    states, outs = batched_run
    assert outs[0].pose_wrt_world.shape == (V, 7, 6)
    assert outs[1].seeds.shape == (V, 8)
    start = sharded.unstack_states(convert.to_port(jax_init_tree, "cpu"))
    for v in range(V):
        st = start[v]
        for k, (a, b) in enumerate(((1, 8), (8, 16))):
            st, o, _ = pipeline.process_interval(st, list(videos[v, a:b]),
                                                 CFG)
            assert_equal(one(outs[k], v), o, f"video {v} interval {k}")
        assert_equal(one(states, v), st, f"video {v} state")


def test_batched_interval_matches_jax(golden, jax_init_tree, batched_run):
    """The port's batched path against the JAX package's (vmap over a
    3-device CPU mesh) from the same init state, which converts to the
    port and back unchanged."""
    jax_arrays = flat(jax_init_tree)
    back = flat(convert.to_numpy(convert.to_port(jax_init_tree, "cpu")))
    # without the loop window the port leaves the weight count out
    assert set(back) == set(jax_arrays) - {"kf.weight_count"}
    for path, a in back.items():
        np.testing.assert_array_equal(a, jax_arrays[path], err_msg=path)
    _, outs = batched_run
    for k, (o, g) in enumerate(zip(outs, golden["intervals"])):
        d_pose = np.abs(o.pose_wrt_world.numpy()
                        - np.asarray(g["pose_wrt_world"])).max()
        d_seeds = np.abs(o.seeds.numpy() - np.asarray(g["seeds"])).max()
        assert d_pose <= POSE_TOL, f"interval {k}: pose diff {d_pose}"
        assert d_seeds <= SEEDS_TOL, f"interval {k}: seeds diff {d_seeds}"
        np.testing.assert_allclose(o.rescale.numpy(), np.asarray(g["rescale"]),
                                   rtol=RESCALE_RTOL)


# ------------------------------------------------------------ (e) spies

def test_one_interval_calls_each_stage_once_whatever_v(videos, monkeypatch):
    counts = {}

    def spy(module, name):
        fn = getattr(module, name)

        def counted(*args, **kw):
            counts[name] = counts.get(name, 0) + 1
            return fn(*args, **kw)
        monkeypatch.setattr(module, name, counted)
    for module, name in ((alignment, "align"), (stereo, "observe"),
                         (reg_kernel, "do_regularization"),
                         (reg_kernel, "regularize")):
        spy(module, name)
    seen = {}
    for n in (1, V):
        states = sharded.batched_init(videos[:n, 0], CFG, "cpu")
        counts.clear()
        sharded.batched_process_interval(states, videos[:n, 1:4], CFG)
        seen[n] = dict(counts)
    # three frames: two track_refine steps and a keyframe step
    assert seen[1] == seen[V] == {"align": 3, "observe": 2,
                                  "do_regularization": 4, "regularize": 1}


# -------------------------------------------------------- (f) footprint

def test_tree_bytes_of_a_stacked_state(videos):
    single = pipeline.init_pipeline(videos[0, 0], CFG, "cpu")
    stacked = sharded.batched_init(videos[:, 0], CFG, "cpu")
    assert footprint.tree_bytes(stacked) == V * footprint.tree_bytes(single)
    assert footprint.tree_bytes(single) == footprint.tree_bytes(
        checkpoint.template_pipeline_state(CFG))


def test_footprint_on_the_cpu_comes_from_the_shapes():
    fp = footprint.interval_footprint(V, CFG, "cpu")
    assert footprint.device_bytes_limit("cpu") is None
    assert fp.fits is None and fp.temp_bytes == 0
    images = V * CFG.keyframe_interval * CFG.rows * CFG.cols * 4
    assert fp.state_bytes == V * footprint.tree_bytes(
        checkpoint.template_pipeline_state(CFG))
    assert fp.peak_bytes == 2 * (fp.state_bytes + images)
    assert f"V={V}" in fp.describe()
    assert footprint.check_fits(V, CFG, "cpu").videos == V


def test_check_fits_refuses_what_cannot_fit(monkeypatch):
    monkeypatch.setattr(footprint, "device_bytes_limit",
                        lambda device=None: 1 << 20)
    assert footprint.interval_footprint(1, CFG, "cpu").fits is False
    with pytest.raises(MemoryError, match=r"Reduce the video batch \(V\)"):
        footprint.check_fits(V, CFG, "cpu")


# ------------------------------------------------------ (g) no jax

def test_batched_modules_import_without_jax():
    code = ("import sys, egomotion_with_local_loop_closures_tpu_torch."
            "parallel.sharded, egomotion_with_local_loop_closures_tpu_torch."
            "utils.footprint; print(sorted(m for m in sys.modules if m == "
            "'jax' or m.startswith(('jax.', "
            "'egomotion_with_local_loop_closures_tpu.')) or m == "
            "'egomotion_with_local_loop_closures_tpu'))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]"


# ------------------------------------------------------ (h) on the card

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc (the K3 kernel runs only "
                    "on the GPU)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_batched_interval_matches_single_video(cuda_device,
                                                    jax_init_tree, videos):
    """A batched interval on the card against each video's single-video
    interval on the card: the card's batched reductions may sum in another
    order, so the JAX package's vmap tolerance (2e-3) and 1 seeds% point;
    K3 launched once per call for all videos, K1's kernels with one
    launch for all videos (``gn_kernel.align_launches`` a frame) and K2
    once per track_refine step for all videos."""
    states = convert.to_port(jax_init_tree, cuda_device)
    reg_kernel.reset_launches()
    gn_kernel.reset_launches()
    stereo_kernel.reset_launches()
    _, outs = sharded.batched_process_interval(states, videos[:, 1:8], CFG)
    assert reg_kernel.launches == {"do_regularization": 8, "regularize": 1}
    assert gn_kernel.launches == {
        k: 7 * n for k, n in gn_kernel.align_launches(CFG).items()}
    assert stereo_kernel.launches == {"stereo_observe": 6}
    for v, st in enumerate(sharded.unstack_states(states)):
        _, o, _ = pipeline.process_interval(st, list(videos[v, 1:8]), CFG)
        d_pose = float((o.pose_wrt_world - outs.pose_wrt_world[v]).abs()
                       .max())
        d_seeds = float((o.seeds - outs.seeds[v]).abs().max())
        assert d_pose <= POSE_TOL and d_seeds <= SEEDS_TOL, (v, d_pose,
                                                             d_seeds)


@pytest.mark.cuda
@pytest.mark.parametrize("occl", [False, True])
def test_cuda_k3_on_batched_pipeline_states(cuda_device, jax_init_tree,
                                            videos, occl):
    """K3 on the (V, H, W) depth states and keyframe max-gradients of a
    batched run, each state bit for bit its plain version alone."""
    states, _ = sharded.batched_process_interval(
        convert.to_port(jax_init_tree, cuda_device), videos[:, 1:5], CFG)
    st, mg = states.depth, states.kf.maxgrad
    got = reg_kernel.do_regularization(st, mg, CFG, occl)
    got_r = reg_kernel.regularize(st, CFG, occl)
    torch.cuda.synchronize()
    for v in range(V):
        assert_equal(one(got, v), propagate.do_regularization(
            one(st, v), mg[v], CFG, occl), f"do_regularization {v}")
        assert_equal(one(got_r, v), propagate.regularize(one(st, v), CFG,
                                                         occl),
                     f"regularize {v}")
