"""K2, one frame's epipolar line stereo and EKF observation as one CUDA
kernel (``ops/stereo_kernel.py``, ``csrc/stereo_kernel.cu``), and its plain
twin (``depth/stereo.py::plain_observe``).

Frames are the port's synthetic room rendered at 96x128 with integer grey
levels: a keyframe and current frames at a third, two thirds and all of a
seeded motion, the last with a patch inverted (its matches fail) and one
striped (its minima repeat); a dark textured patch of the keyframe is
black in every current frame (its walks' SSDs tie exactly).  Two states: a fresh one (the glibc random
init with 40 % holes) and an evolved one (the fresh state after the plain
observation and regularization of the first two current frames); in
both, some pixels have a variance near ``max_var`` (a failed update kills
the pixel) and some a zero smoothed variance (the search band collapses
to code -4).  Each is observed against the last current frame.

- The plain twin's decisions on both inputs reach every line_stereo code
  and every EKF branch, so no comparison below passes vacuously.
- The CUDA source built for the CPU with g++ (``tests/cuda_emulation.py``)
  against the plain twin, bit for bit: the twin takes its square roots in
  float64 and rounds once (``depth/stereo.py::_sqrt``), the correctly
  rounded value the kernel's ``sqrtf`` gives, so the result is the same
  whether ``torch.sqrt`` is the CPU's own (not correctly rounded for
  float32) or a correctly rounded one.  Besides the fixture's states: walks
  of every length the segment allows up to 64 steps (a configuration with
  ``stereo_max_steps`` 64, the kernel's most, and a longer crop), a
  current image with NaN pixels (NaN samples: the first NaN step is the
  best), and the source built with a box of 64 floats (nearly every
  sample read from the image instead) and with 32 x 4 tiles.
- The emulated K2 against the JAX package's dense ``observe``, at
  tests/test_torch_stereo.py's tolerances.
- Each video of a batch of three (the fresh and evolved states and a video
  with a NaN pose, which runs no pixel) bit-equal to its own call and to
  the plain twin.
- The wrapper on CPU tensors runs the plain twin and launches nothing; the
  module imports without nvcc; the source's atomics all add integers, and
  it keeps no per-step array in a thread's local memory.
- On a card (``-m cuda``; run there with ``python -m pytest
  tests/test_torch_stereo_kernel.py -m cuda --noconftest``, since that
  machine has no jax: this file imports the JAX package only in a fixture)
  the kernel itself, one launch a call for all videos, bit for bit against
  the plain twin on the card and each video against its own call.
"""

import ctypes
import re

import cuda_emulation
import numpy as np
import pytest
import torch

from egomotion_with_local_loop_closures_tpu_torch.config import ELLCConfig
from egomotion_with_local_loop_closures_tpu_torch.depth import (
    propagate, state as dstate, stereo)
from egomotion_with_local_loop_closures_tpu_torch.depth.state import (
    FIELDS, DepthMapState)
from egomotion_with_local_loop_closures_tpu_torch.image import pyramid
from egomotion_with_local_loop_closures_tpu_torch.ops import stereo_kernel
from egomotion_with_local_loop_closures_tpu_torch.utils import synthetic

torch.set_num_threads(1)

KW = dict(rows=96, cols=128, fx=110.0, fy=110.0, cx=64.0, cy=48.0,
          stereo_compact_frac=0.0, stereo_pack_u8=False,
          bootstrap_rng="glibc")
CFG = ELLCConfig(**KW)
MOTION = np.asarray([0.002, -0.001, 0.0, 0.04, 0.01, 0.0], np.float32)
BRANCHES = ("create_ok", "create_blacklist", "u_notfound", "inconsistent",
            "u_success", "nf_kill")


@pytest.fixture(scope="module")
def inputs():
    """{"fresh": args, "evolved": args}, each the arguments of observe on
    the CPU: (state, kf image, gradx, grady, maxgrad, current image,
    pose)."""
    scene = synthetic.make_room_scene(seed=5, depth=1.2, half_width=1.6,
                                      half_height=1.1)
    intr = CFG.level_intrinsics(0)

    def render(pose):
        img, _ = synthetic.render(scene, torch.as_tensor(pose), CFG.rows,
                                  CFG.cols, *intr)
        return torch.round(img)
    x = torch.arange(CFG.cols, dtype=torch.float32)
    kf = render(np.zeros(6, np.float32))
    # a dark textured patch of the keyframe seen as black in every current
    # frame: every step of a walk inside it has the same SSD, exactly (the
    # tie rules of the best and second-best steps decide)
    kf[10:26, 50:78] = torch.round(6.0 + 5.0 * torch.sin(x / 1.7))[50:78]
    gx, gy = pyramid.gradients(kf)
    mg = pyramid.max_abs_gradient(gx, gy)
    poses = [torch.as_tensor(MOTION * f) for f in (1 / 3, 2 / 3, 1.0)]
    curs = [render(p) for p in poses]
    for cur in curs:
        cur[4:32, 8:120] = 0.0
    # the last frame with a patch inverted (its matches fail: codes -3)
    # and one striped (periodic minima: ambiguous, code -2)
    last = curs[2]
    last[40:60, 40:80] = 255.0 - last[40:60, 40:80]
    last[66:90, 10:50] = torch.round(
        last + 30.0 * torch.sin(2.0 * np.pi * x / 5.0))[66:90, 10:50]
    rng = np.random.default_rng(1)
    st = dstate.initialize_random(None, mg, CFG)
    u = torch.as_tensor(rng.uniform(size=mg.shape).astype(np.float32))
    st = st.replace(valid=st.valid & ((u >= 0.4) | (u < 0.05)))

    def stress(s):
        """Variances near max_var (a failed update kills the pixel) and
        zero smoothed variances (a collapsed band: code -4) on some of the
        valid pixels."""
        return s.replace(
            var=torch.where(s.valid & (u > 0.75), 0.24, s.var),
            var_smoothed=torch.where(s.valid & (u < 0.05), 0.0,
                                     s.var_smoothed))
    evolved = st
    for cur, pose in zip(curs[:2], poses[:2]):
        evolved = stereo.plain_observe(evolved, kf, gx, gy, mg, cur, pose,
                                       CFG).state
        evolved = propagate.do_regularization(evolved, mg, CFG)
    tail = (kf, gx, gy, mg, curs[2], poses[2])
    return {"fresh": (stress(st),) + tail, "evolved": (stress(evolved),) + tail}


def on(args, device):
    st, *rest = args
    return (DepthMapState(**{n: getattr(st, n).to(device) for n in FIELDS}),
            *(t.to(device) for t in rest))


def stack(args_list):
    """V argument tuples as one batched call's arguments."""
    sts = [a[0] for a in args_list]
    st = DepthMapState(**{n: torch.stack([getattr(s, n) for s in sts])
                          for n in FIELDS})
    return (st, *(torch.stack(ts) for ts in zip(*(a[1:] for a in args_list))))


def nan_pose(args):
    return args[:-1] + (torch.full_like(args[-1], float("nan")),)


def assert_bits(got, want):
    for n in FIELDS:
        torch.testing.assert_close(getattr(got.state, n),
                                   getattr(want.state, n), rtol=0, atol=0,
                                   equal_nan=True, msg=lambda m: f"{n}: {m}")
    assert torch.equal(got.num_created, want.num_created)
    assert torch.equal(got.num_updated, want.num_updated)


# --- the plain twin's decisions ---

@pytest.mark.parametrize("which", ["fresh", "evolved"])
def test_inputs_reach_every_code_and_branch(inputs, which):
    b = stereo.observe_branches(*inputs[which], CFG)
    run = b["run"]
    codes = {c: int((run & (b["code"] == c)).sum()) for c in (0, -1, -2, -3,
                                                                -4)}
    counts = {k: int(b[k].sum()) for k in BRANCHES}
    assert all(n > 0 for n in codes.values()), codes
    assert all(n > 0 for n in counts.values()), counts


def test_twin_sqrt_is_correctly_rounded():
    """The twin's square root is the correctly rounded float32 one (numpy's
    float32 sqrt, IEEE's) on seeded inputs over many binades, as K2's
    ``sqrtf`` is; the CPU's float32 ``torch.sqrt`` need not be."""
    rng = np.random.default_rng(3)
    a = (rng.uniform(size=20_000) * 10.0 ** rng.integers(-6, 7, 20_000)
         ).astype(np.float32)
    got = stereo._sqrt(torch.as_tensor(a)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.int32),
                                  np.sqrt(a).view(np.int32))


# --- the wrapper on the CPU ---

def test_module_imports_without_nvcc_and_atomics_add_integers():
    """The module imported above without building anything; every atomic
    of the kernel adds to an int32 count (exact in any order: no float
    atomic), it is one kernel, no thread keeps a per-step array in its
    local memory (a walk keeps its 5-sample window and the steps it needs
    as they come), the walkers are compacted by a warp ballot, and its
    constants mirror the C struct field for field."""
    assert stereo_kernel._lib is None
    src = stereo_kernel.SOURCE.read_text()
    code = re.sub(r"//[^\n]*", "", src)
    atomics = re.findall(r"(atomic\w*)\(&([\w.\[\]]+),", code)
    assert len(re.findall(r"atomic\w*\(", code)) == len(atomics) > 0
    assert {op for op, _ in atomics} == {"atomicAdd"}
    assert {target.split("[")[0] for _, target in atomics} == {
        "s_count", "a.num_created", "a.num_updated"}
    assert re.search(r"__shared__ int s_count", code)
    assert re.search(r"int32_t\* __restrict__ num_created;", code)
    assert re.search(r"int32_t\* __restrict__ num_updated;", code)
    assert src.count("__global__") == 1
    # arrays outside shared memory: each dimension a literal of at most 9
    # (a pose block, a 5-sample window)
    local = re.findall(r"^\s*(?:const )?(?:float|int|bool|unsigned) "
                       r"\w+((?:\[[^\]]+\])+)", code, re.M)
    dims = [d for decl in local for d in re.findall(r"\[([^\]]+)\]", decl)]
    assert dims and all(d.isdigit() and int(d) <= 9 for d in dims), dims
    assert "__ballot_sync" in code and "__popc" in code
    body = re.search(r"struct StereoParams \{(.*?)\};", code, re.S).group(1)
    fields = []
    for kind, names in re.findall(r"(float|int) ([^;]+);", body):
        fields += [(n.strip(), kind) for n in names.split(",")]
    assert fields == [(n, "float" if t is ctypes.c_float else "int")
                      for n, t in stereo_kernel.Params._fields_]
    assert stereo_kernel.wrapper_of(
        "_ZN12_GLOBAL__N_114stereo_observeENS_10StereoArgsE") == \
        "stereo_observe"
    assert stereo_kernel.wrapper_of(
        "_ZN12_GLOBAL__N_112gn_linearizeENS_7LinArgsE") is None


def test_cpu_tensors_take_the_plain_path(inputs):
    args = inputs["evolved"]
    stereo_kernel.reset_launches()
    got = stereo_kernel.observe(*args, CFG)
    assert_bits(got, stereo.plain_observe(*args, CFG))
    assert_bits(stereo.observe(*args, CFG), got)
    assert stereo_kernel.launches == {"stereo_observe": 0}
    assert stereo_kernel._lib is None


# --- the CUDA source built for the CPU ---

@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """K2's library built for the CPU, as a function of observe's
    arguments."""
    lib = stereo_kernel.bind(ctypes.CDLL(str(cuda_emulation.build_for_cpu(
        stereo_kernel.SOURCE, tmp_path_factory.mktemp("stereo_kernel_cpu"),
        1))))

    def run(*args):
        return stereo_kernel._launch(lib, *args, CFG, 0)
    run.lib = lib
    return run


@pytest.mark.parametrize("sqrt", ["cpu", "correctly_rounded"])
@pytest.mark.parametrize("which", ["fresh", "evolved"])
def test_emulated_matches_plain(inputs, emulated, monkeypatch, which, sqrt):
    """Bit for bit, with the CPU's ``torch.sqrt`` or a correctly rounded
    one: the twin rounds as the kernel does, its square roots included."""
    args = inputs[which]
    got = emulated(*args)
    if sqrt == "correctly_rounded":
        cpu_sqrt = torch.sqrt
        monkeypatch.setattr(torch, "sqrt",
                            lambda a: cpu_sqrt(a.double()).to(a.dtype))
    want = stereo.plain_observe(*args, CFG)
    assert_bits(got, want)
    assert int(want.num_created) > 0 and int(want.num_updated) > 0
    # the state is new, the input untouched
    assert all(getattr(got.state, n) is not getattr(args[0], n)
               for n in FIELDS)


def test_emulated_videos_equal_their_own_calls_bit_for_bit(inputs, emulated):
    """The fresh and evolved states and a NaN-pose video in one call: the
    batch equals the plain twin's batch and each video's planes and counts
    its own call's, bit for bit; the NaN video runs no pixel."""
    vids = [inputs["fresh"], inputs["evolved"], nan_pose(inputs["fresh"])]
    batch = emulated(*stack(vids))
    assert batch.num_created.shape == (3,)
    assert_bits(batch, stereo.plain_observe(*stack(vids), CFG))
    for v, args in enumerate(vids):
        alone = emulated(*args)
        assert_bits(stereo.ObserveResult(
            DepthMapState(**{n: getattr(batch.state, n)[v] for n in FIELDS}),
            batch.num_created[v], batch.num_updated[v]), alone)
    nan_alone = emulated(*vids[2])
    assert_bits(nan_alone, stereo.plain_observe(*vids[2], CFG))
    assert int(nan_alone.num_created) == int(nan_alone.num_updated) == 0


def long_walks():
    """observe's arguments and configuration for walks of every length: the
    kernel's most steps (64), a crop of 70 pixels and no minimum length, a
    keyframe of vertical stripes, a state whose search bands run from a
    few hundredths of a pixel to past the crop, and a pose whose epipolar
    lines are horizontal but for a rounding's worth (walks of two steps)."""
    cfg = CFG.replace(stereo_max_steps=64, max_epl_length_crop=70.0,
                      min_epl_length_crop=0.0)
    rng = np.random.default_rng(11)
    H, W = CFG.rows, CFG.cols
    y, x = np.mgrid[0:H, 0:W].astype(np.float64)

    def stripes(dx):
        return torch.as_tensor(np.round(
            120 + 50 * np.sin((x - dx) / 2.3 + 0.4 * np.sin(y / 5.0))
            + rng.normal(0, 3, (H, W))).astype(np.float32))
    kf, cur = stripes(0.0), stripes(4.0)
    gx, gy = pyramid.gradients(kf)
    mg = pyramid.max_abs_gradient(gx, gy)
    sv = np.exp(rng.uniform(np.log(1e-3), np.log(3.0), (H, W)))
    ids = torch.as_tensor(rng.uniform(0.5, 1.0, (H, W)).astype(np.float32))
    st = DepthMapState(
        idepth=ids, var=torch.full((H, W), 0.01), idepth_smoothed=ids,
        var_smoothed=torch.as_tensor((sv * sv).astype(np.float32)),
        validity=torch.full((H, W), 5.0),
        blacklisted=torch.zeros((H, W), dtype=torch.int32),
        valid=torch.ones((H, W), dtype=torch.bool))
    pose = torch.tensor([0.0, 0.0, 0.0, 0.12, 3e-7, 1e-6])
    return (st, kf, gx, gy, mg, cur, pose), cfg


def test_emulated_walks_of_every_length(emulated):
    """Walks of every length from 2 to 64 steps (a lane's first and second
    step, every lane, and both ballots of the walk's length), bit for bit
    against the twin.  One step is no walk the segment allows: step 1 is
    its far end, which the walk starts one step before."""
    args, cfg = long_walks()
    b = stereo.observe_branches(*args, cfg)
    walked = b["run"] & ((b["code"] == 0) | (b["code"] == -2)
                         | (b["code"] == -3))
    assert set(range(2, 65)) <= set(b["steps"][walked].tolist())
    got = stereo_kernel._launch(emulated.lib, *args, cfg, 0)
    assert_bits(got, stereo.plain_observe(*args, cfg))


def test_emulated_nan_samples(inputs, emulated):
    """NaN pixels in the current image: a walk over them has NaN SSDs,
    whose first is its best step (torch.argmin's rule); bit for bit
    against the twin, which the NaNs move."""
    st, kf, gx, gy, mg, cur, pose = inputs["evolved"]
    cur = cur.clone()
    cur[40:56, 84:92] = float("nan")
    args = (st, kf, gx, gy, mg, cur, pose)
    want = stereo.plain_observe(*args, CFG)
    moved = stereo.plain_observe(*inputs["evolved"], CFG)
    assert not all(torch.equal(getattr(want.state, n),
                               getattr(moved.state, n)) for n in FIELDS)
    assert_bits(emulated(*args), want)


@pytest.mark.parametrize("defines", [("ELLC_K2_BOX=64",),
                                     ("ELLC_K2_TILE_H=4",
                                      "ELLC_K2_MIN_BLOCKS=1")])
def test_emulated_tile_variants_match_plain(inputs, tmp_path, defines):
    """The source built with other constants, bit for bit against the twin
    on the evolved state and on walks of every length: a box of 64 floats
    (nearly every sample falls off it: the image path) and tiles of 32 x 4
    pixels (tools/time_k2.py times such variants on the card)."""
    lib = stereo_kernel.bind(ctypes.CDLL(str(cuda_emulation.build_for_cpu(
        stereo_kernel.SOURCE, tmp_path, 1, defines))))
    for args, cfg in ((inputs["evolved"], CFG), long_walks()):
        assert_bits(stereo_kernel._launch(lib, *args, cfg, 0),
                    stereo.plain_observe(*args, cfg))


@pytest.fixture(scope="module")
def jax_observe():
    import jax.numpy as jnp
    from egomotion_with_local_loop_closures_tpu.config import ELLCConfig as JC
    from egomotion_with_local_loop_closures_tpu.depth import state as jstate
    from egomotion_with_local_loop_closures_tpu.depth import stereo as jst
    jcfg = JC(**KW)

    def run(args):
        st, *rest = args
        jst_state = jstate.DepthMapState(*(jnp.asarray(getattr(st, n).numpy())
                                           for n in FIELDS))
        return jst.observe(jst_state, *(jnp.asarray(t.numpy()) for t in rest),
                           jcfg)
    return run


@pytest.mark.parametrize("which", ["fresh", "evolved"])
def test_emulated_matches_jax(inputs, emulated, jax_observe, which):
    """tests/test_torch_stereo.py's tolerances: at most 0.5 % of the pixels
    differ in validity, the counts within as many; where both are valid,
    idepth, var and validity within rtol 1e-3 on 99 % of them and the
    blacklist equal."""
    args = inputs[which]
    oj = jax_observe(args)
    ot = emulated(*args)
    vj, vt = np.asarray(oj.state.valid), ot.state.valid.numpy()
    assert np.mean(vj != vt) <= 0.005
    assert abs(int(oj.num_created) - int(ot.num_created)) <= 0.005 * vj.size
    assert abs(int(oj.num_updated) - int(ot.num_updated)) <= 0.005 * vj.size
    same = vj & vt
    for name in ("idepth", "var", "validity"):
        a = np.asarray(getattr(oj.state, name))[same]
        b = getattr(ot.state, name).numpy()[same]
        rel = np.abs(a - b) / np.maximum(np.abs(a), 1e-6)
        assert np.mean(rel <= 1e-3) >= 0.99, name
    np.testing.assert_array_equal(np.asarray(oj.state.blacklisted)[same],
                                  ot.state.blacklisted.numpy()[same])


# --- on the card ---

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc (K2 runs only on the GPU)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["fresh", "evolved"])
def test_cuda_matches_plain_one_launch(inputs, cuda_device, which):
    args = on(inputs[which], cuda_device)
    stereo_kernel.reset_launches()
    got = stereo.observe(*args, CFG)
    torch.cuda.synchronize()
    assert stereo_kernel.launches == {"stereo_observe": 1}
    assert_bits(got, stereo.plain_observe(*args, CFG))


@pytest.mark.cuda
def test_cuda_videos_equal_their_own_calls_bit_for_bit(inputs, cuda_device):
    """V = 8 (the fresh, evolved and NaN-pose videos repeated) in one
    launch: each video bit-equal to its own call."""
    three = [inputs["fresh"], inputs["evolved"], nan_pose(inputs["fresh"])]
    vids = [on(three[v % 3], cuda_device) for v in range(8)]
    stereo_kernel.reset_launches()
    batch = stereo.observe(*stack(vids), CFG)
    assert stereo_kernel.launches == {"stereo_observe": 1}
    for v, args in enumerate(vids):
        alone = stereo.observe(*args, CFG)
        assert_bits(stereo.ObserveResult(
            DepthMapState(**{n: getattr(batch.state, n)[v] for n in FIELDS}),
            batch.num_created[v], batch.num_updated[v]), alone)
