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
  against the plain twin: bit for bit where the twin's sqrt is correctly
  rounded, as the card's and the kernel's are; with the CPU's vectorized
  sqrt, which is not, at most 0.1 % of the pixels may differ in any output
  plane (a float plane beyond rtol 1e-5: near-ties of the SSD minimum and
  a triangulation that cancels), the counts within as many pixels.
- The emulated K2 against the JAX package's dense ``observe``, at
  tests/test_torch_stereo.py's tolerances.
- Each video of a batch of three (the fresh and evolved states and a video
  with a NaN pose, which runs no pixel) bit-equal to its own call, and the
  NaN video equal to the plain twin.
- The wrapper on CPU tensors runs the plain twin and launches nothing; the
  module imports without nvcc; the source's only atomics add integers.
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
# pixels where the CPU emulation may differ from the twin with the CPU's
# sqrt (0 and 2 of these 12,288 pixels differ), and the relative tolerance
# of a float plane elsewhere
EMULATED_FRAC, RTOL = 0.001, 1e-5
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


def differing(got, want):
    """(fraction of pixels where any plane differs, beyond RTOL for a
    float plane, NaN equal to NaN; the same count where the integer and
    bool planes agree)."""
    shape = want.state.valid.shape
    bad = torch.zeros(shape, dtype=torch.bool, device=want.state.valid.device)
    discrete = bad.clone()
    for n in FIELDS:
        a, b = getattr(got.state, n), getattr(want.state, n)
        if b.dtype.is_floating_point:
            bad |= ~torch.isclose(a, b, rtol=RTOL, atol=0.0, equal_nan=True)
        else:
            discrete |= a != b
    bad |= discrete
    return float(bad.float().mean()), int((bad & ~discrete).sum())


def assert_matches_plain(got, want, limit):
    frac, float_only = differing(got, want)
    assert frac <= limit, (frac, float_only)
    n = want.state.valid.numel()
    for a, b in ((got.num_created, want.num_created),
                 (got.num_updated, want.num_updated)):
        assert a.dtype == b.dtype == torch.int32
        assert abs(int(a) - int(b)) <= limit * n


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


# --- the wrapper on the CPU ---

def test_module_imports_without_nvcc_and_atomics_add_integers():
    """The module imported above without building anything; the kernel's
    only atomics add int32 counts (exact in any order), and its constants
    mirror the C struct field for field."""
    assert stereo_kernel._lib is None
    src = stereo_kernel.SOURCE.read_text()
    code = re.sub(r"//[^\n]*", "", src)
    atomics = re.findall(r"atomic\w*\(&([\w.\[\]]+),", code)
    assert len(re.findall(r"atomic", code)) == len(atomics) == 4
    assert set(atomics) == {"s_count[0]", "s_count[1]", "a.num_created[v]",
                            "a.num_updated[v]"}
    assert re.search(r"__shared__ int s_count", code)
    assert re.search(r"int32_t\* __restrict__ num_created;", code)
    assert src.count("__global__") == 1
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
    return run


@pytest.mark.parametrize("sqrt", ["cpu", "correctly_rounded"])
@pytest.mark.parametrize("which", ["fresh", "evolved"])
def test_emulated_matches_plain(inputs, emulated, monkeypatch, which, sqrt):
    """With the CPU's sqrt, within EMULATED_FRAC of the pixels; with a
    correctly rounded one (the card's, and the kernel's), bit for bit:
    the twin rounds as the kernel does."""
    args = inputs[which]
    got = emulated(*args)
    if sqrt == "correctly_rounded":
        cpu_sqrt = torch.sqrt
        monkeypatch.setattr(torch, "sqrt",
                            lambda a: cpu_sqrt(a.double()).to(a.dtype))
    want = stereo.plain_observe(*args, CFG)
    if sqrt == "cpu":
        assert_matches_plain(got, want, EMULATED_FRAC)
    else:
        assert_bits(got, want)
    assert int(want.num_created) > 0 and int(want.num_updated) > 0
    # the state is new, the input untouched
    assert all(getattr(got.state, n) is not getattr(args[0], n)
               for n in FIELDS)


def test_emulated_videos_equal_their_own_calls_bit_for_bit(inputs, emulated):
    """The fresh and evolved states and a NaN-pose video in one call: each
    video's planes and counts equal its own call's; the NaN video runs no
    pixel, so it equals the plain twin bit for bit."""
    vids = [inputs["fresh"], inputs["evolved"], nan_pose(inputs["fresh"])]
    batch = emulated(*stack(vids))
    assert batch.num_created.shape == (3,)
    for v, args in enumerate(vids):
        alone = emulated(*args)
        assert_bits(stereo.ObserveResult(
            DepthMapState(**{n: getattr(batch.state, n)[v] for n in FIELDS}),
            batch.num_created[v], batch.num_updated[v]), alone)
    nan_alone = emulated(*vids[2])
    assert_bits(nan_alone, stereo.plain_observe(*vids[2], CFG))
    assert int(nan_alone.num_created) == int(nan_alone.num_updated) == 0


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
