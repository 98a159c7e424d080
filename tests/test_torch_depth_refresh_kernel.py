"""The keyframe's depth-pyramid refresh (``depth/fusion.py::
refresh_depth_pyramid``; ``ops/depth_refresh_kernel.py``,
``csrc/depth_refresh_kernel.cu``) and its plain twin,
``state.to_depth_image`` then ``fusion.build_depth_var_pyramid``.

Inputs: numpy-seeded depth states at ``TEST_CONFIG``'s 96x128 for one
video and for two (2, 96, 128), at 270x480 (whose levels drop a row at
levels 2 and 3: 270, 135, 67, 33), at a ragged 37x53, at 70x102 (a
width the vector loads do not take; the last warps half outside), a
batch of three at 70x100 and the smallest four-level state, 16x16; hypotheses
valid or not at random, smoothed inverse depths around and below the
-0.05 cut (and exactly at it, at 0 and at -0.0), variances of both signs,
NaN in both planes.

On the CPU:

- the twin against the JAX package's ``to_depth_image`` and
  ``build_depth_var_pyramid``, within the depth tests' tolerances (rtol
  1e-6 at level 0, rtol 2e-6 and atol 1e-7 fused; the valid plane equal);
- the twin's fixed order of each 2x2 sum is the order of the fusion as
  the port ran it before the kernel (``sum(dim=(-3, -1))``), bit for bit;
- ``refresh_depth_pyramid`` on CPU tensors runs the twin, launches
  nothing and builds nothing;
- the CUDA source built for the CPU with g++ (``tests/cuda_emulation.py``)
  equals the twin bit for bit in every plane and level (NaN equal to
  NaN), for one state, a batch, every level count 1-4, and each state of
  a batch equal to itself alone; so it does with the grid's blocks run
  in reverse and odd blocks first, built with the tiles and pixels a
  thread that ``tools/time_k4.py`` times, and on planes that start 4 bytes past a
  16-byte boundary (the scalar loads);
- each block writes only the cells it owns: run one block at a time into
  outputs filled with a sentinel, every cell is written by exactly one
  block, with the twin's bits.

On a card (``python -m pytest tests/test_torch_depth_refresh_kernel.py -m
cuda --noconftest``): the kernel bit-equal to the twin there, one launch a
call, and two calls bit-equal.
"""

import ctypes
import re

import cuda_emulation
import numpy as np
import pytest
import torch

from egomotion_with_local_loop_closures_tpu_torch.config import TEST_CONFIG
from egomotion_with_local_loop_closures_tpu_torch.depth import (
    fusion, state as dstate)
from egomotion_with_local_loop_closures_tpu_torch.ops import (
    depth_refresh_kernel)

torch.set_num_threads(1)

CFG = TEST_CONFIG
CASES = {"one": (96, 128), "videos": (2, 96, 128), "full": (270, 480),
         "ragged": (37, 53)}
# widths the vector loads take and do not, warps half outside, a batch of
# three, and the smallest four-level state
EDGE_CASES = {"edge": (70, 102), "batch3": (3, 70, 100), "small": (16, 16)}
ALL_CASES = {**CASES, **EDGE_CASES}


def states(case, nan=False):
    """A depth state of the case's shape from numpy."""
    shape = ALL_CASES[case]
    seed = (sorted(CASES).index(case) if case in CASES
            else 20 + sorted(EDGE_CASES).index(case))
    rng = np.random.default_rng(seed + 10 * nan)
    valid = rng.uniform(size=shape) < 0.6
    ids = rng.uniform(-0.2, 2.0, size=shape)
    pick = rng.uniform(size=shape)
    ids[pick < 0.02] = -0.05
    ids[(pick >= 0.02) & (pick < 0.03)] = 0.0
    ids[(pick >= 0.03) & (pick < 0.04)] = -0.0
    ids[(pick >= 0.04) & (pick < 0.05)] = 1e-13
    var = rng.uniform(-0.01, 0.1, size=shape)
    if nan:
        var[pick > 0.99] = np.nan
        ids[(pick > 0.97) & (pick < 0.98)] = np.nan
    f32 = lambda a: torch.as_tensor(a.astype(np.float32))  # noqa: E731
    z = torch.zeros(shape)
    return dstate.DepthMapState(
        idepth=f32(ids), var=f32(var), idepth_smoothed=f32(ids),
        var_smoothed=f32(var), validity=z, blacklisted=z.to(torch.int32),
        valid=torch.as_tensor(valid))


def same(a, b):
    """Bit for bit, NaN equal to NaN."""
    return a.shape == b.shape and a.dtype == b.dtype and bool(
        ((a == b) | (a.isnan() & b.isnan())).all()) and bool(
        (torch.signbit(a) == torch.signbit(b)).all()) if a.is_floating_point() \
        else a.shape == b.shape and torch.equal(a, b)


def assert_refresh(got, want):
    st, depths, vars_ = got
    wst, wdepths, wvars = want
    assert same(st.valid, wst.valid)
    assert len(depths) == len(wdepths)
    for i, (a, b, c, d) in enumerate(zip(depths, wdepths, vars_, wvars)):
        assert same(a, b), f"depth level {i}"
        assert same(c, d), f"var level {i}"


@pytest.mark.parametrize("case", ["one", "videos", "ragged"])
def test_twin_matches_jax(case):
    # jax only here: the card's machine runs this file's CUDA cases
    # without it
    import jax.numpy as jnp
    from egomotion_with_local_loop_closures_tpu import config as jconfig
    from egomotion_with_local_loop_closures_tpu.depth import fusion as jfusion
    from egomotion_with_local_loop_closures_tpu.depth import state as jstate
    st = states(case)
    got, depths, vars_ = fusion.plain_refresh_depth_pyramid(st, CFG)
    lead = st.valid.shape[:-2]
    for b in range(int(np.prod(lead, dtype=int))):
        one = (lambda t: t.reshape((-1,) + t.shape[-2:])[b])
        jst = jstate.DepthMapState(**{
            n: jnp.asarray(one(getattr(st, n)).numpy())
            for n in dstate.FIELDS})
        jst, jd, jv = jstate.to_depth_image(jst, jconfig.TEST_CONFIG)
        np.testing.assert_array_equal(np.asarray(jst.valid),
                                      one(got.valid).numpy())
        jds, jvs = jfusion.build_depth_var_pyramid(jd, jv, CFG.num_levels)
        for level, (a, b_, c, d) in enumerate(zip(jds, depths, jvs, vars_)):
            tol = (dict(rtol=1e-6) if level == 0
                   else dict(rtol=2e-6, atol=1e-7))
            np.testing.assert_allclose(np.asarray(a), one(b_).numpy(), **tol)
            np.testing.assert_allclose(np.asarray(c), one(d).numpy(), **tol)


def _fuse_before(depth, var):
    """``fusion.fuse_level`` as the port ran it before the kernel: the 2x2
    sums left to ``sum(dim=(-3, -1))``."""
    H, W = depth.shape[-2:]
    lead = depth.shape[:-2]
    H2, W2 = H // 2, W // 2
    d = depth[..., : H2 * 2, : W2 * 2].reshape(lead + (H2, 2, W2, 2))
    v = var[..., : H2 * 2, : W2 * 2].reshape(lead + (H2, 2, W2, 2))
    valid = v > 0.0
    ivar = torch.where(valid, 1.0 / torch.where(valid, v, 1.0), 0.0)
    inv_d = torch.where(
        valid, 1.0 / torch.where(torch.abs(d) > 1e-12, d, 1e-12), 0.0)
    ivar_sum = ivar.sum(dim=(-3, -1))
    idepth_sum = (ivar * inv_d).sum(dim=(-3, -1))
    num = valid.sum(dim=(-3, -1)).to(depth.dtype)
    any_valid = num > 0
    return (torch.where(any_valid,
                        ivar_sum / torch.where(any_valid, idepth_sum, 1.0),
                        0.0),
            torch.where(any_valid,
                        num / torch.where(any_valid, ivar_sum, 1.0), -1.0))


@pytest.mark.parametrize("case", CASES)
def test_twin_sum_order_is_the_fusion_before(case):
    _, depths, vars_ = fusion.plain_refresh_depth_pyramid(states(case), CFG)
    for level in range(1, CFG.num_levels):
        d, v = _fuse_before(depths[level - 1], vars_[level - 1])
        assert same(d, depths[level]) and same(v, vars_[level])


def test_cpu_state_takes_the_twin():
    depth_refresh_kernel.reset_launches()
    st = states("videos", nan=True)
    assert_refresh(fusion.refresh_depth_pyramid(st, CFG),
                   fusion.plain_refresh_depth_pyramid(st, CFG))
    assert depth_refresh_kernel.launches == {"depth_refresh": 0}
    assert depth_refresh_kernel._lib is None


def test_source_and_names():
    code = re.sub(r"//[^\n]*", "", depth_refresh_kernel.SOURCE.read_text())
    assert "atomic" not in code and code.count("__global__") == 1
    assert re.search(r"kMaxLevels = (\d+);", code).group(1) == str(
        depth_refresh_kernel.MAX_LEVELS)
    assert depth_refresh_kernel.wrapper_of(
        "_ZN12_GLOBAL__N_113depth_refreshE11RefreshArgs") == "depth_refresh"
    assert depth_refresh_kernel.wrapper_of(
        "_ZN12_GLOBAL__N_113pyramid_levelE11PyramidArgs") is None
    st = states("one")
    with pytest.raises(ValueError):
        depth_refresh_kernel.refresh(st.valid, st.idepth_smoothed,
                                     st.var_smoothed, 3, 4)


# --- the CUDA source built for the CPU ---

def _build(tmp_path_factory, name, defines=()):
    """The library built for the CPU, as a function of a state, a border
    and a level count."""
    lib = depth_refresh_kernel.bind(ctypes.CDLL(str(
        cuda_emulation.build_for_cpu(
            depth_refresh_kernel.SOURCE, tmp_path_factory.mktemp(name), 1,
            defines))))

    def run(st, border, levels):
        valid, depths, vars_ = depth_refresh_kernel._launch(
            lib, st.valid, st.idepth_smoothed, st.var_smoothed, border,
            levels, 0)
        return st.replace(valid=valid), depths, vars_
    run.lib = lib
    return run


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    return _build(tmp_path_factory, "depth_refresh_kernel_cpu")


@pytest.fixture(scope="module", params=[1, 2],
                ids=["reversed", "odd_then_even"])
def emulated_in_order(request, tmp_path_factory):
    """The library with the grid's blocks run in the given order."""
    return _build(tmp_path_factory,
                  f"depth_refresh_kernel_cpu{request.param}",
                  (f"EMU_BLOCK_ORDER={request.param}",))


def _plain(st, border, levels):
    return fusion.plain_refresh_depth_pyramid(
        st, CFG.replace(border=border, num_levels=levels))


@pytest.mark.parametrize("nan", [False, True], ids=["finite", "nan"])
@pytest.mark.parametrize("case", ALL_CASES)
def test_emulated_matches_twin(emulated, case, nan):
    st = states(case, nan)
    assert_refresh(emulated(st, CFG.border, CFG.num_levels),
                   _plain(st, CFG.border, CFG.num_levels))


@pytest.mark.parametrize("case", ALL_CASES)
def test_emulated_block_orders(emulated_in_order, case):
    st = states(case, nan=True)
    assert_refresh(emulated_in_order(st, CFG.border, CFG.num_levels),
                   _plain(st, CFG.border, CFG.num_levels))


# the builds tools/time_k4.py times beside the source's
BUILDS = ("ELLC_REF_TILE_H=8", "ELLC_REF_TILE_H=32",
          "ELLC_REF_TILE_H=32,ELLC_REF_TILE_W=64")


@pytest.mark.parametrize("defines", BUILDS, ids=["8x32", "32x32", "32x64"])
def test_emulated_other_builds(tmp_path_factory, defines):
    run = _build(tmp_path_factory, "depth_refresh_kernel_build",
                 tuple(defines.split(",")))
    for case in ("one", "ragged", "edge", "batch3", "small"):
        st = states(case, nan=True)
        assert_refresh(run(st, CFG.border, CFG.num_levels),
                       _plain(st, CFG.border, CFG.num_levels))


def _shifted(t):
    """``t`` in a buffer whose data starts one element past the
    allocation's, 4 bytes past a 16-byte boundary for float32."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    return out


def test_emulated_planes_off_the_vector_alignment(emulated):
    st = states("batch3", nan=True)
    moved = st.replace(**{n: _shifted(getattr(st, n)) for n in
                          ("valid", "idepth_smoothed", "var_smoothed")})
    assert moved.idepth_smoothed.data_ptr() % 16 != 0
    assert_refresh(emulated(moved, CFG.border, CFG.num_levels),
                   _plain(st, CFG.border, CFG.num_levels))


SENTINEL = 0x7FBADBAD       # a signalling NaN: no arithmetic makes it


def _sentinel_empty(shape, dtype, device):
    if dtype == torch.bool:
        return torch.full(shape, 0xAB, dtype=torch.uint8).view(torch.bool)
    return torch.full(shape, SENTINEL, dtype=torch.int32).view(torch.float32)


@pytest.mark.parametrize("case", ["batch3", "edge"])
def test_emulated_each_block_writes_its_own_cells(emulated, monkeypatch,
                                                  case):
    """One block at a time into outputs filled with the sentinel: every
    cell is written by exactly one block, with the twin's bits."""
    monkeypatch.setattr(depth_refresh_kernel, "_empty", _sentinel_empty)
    st = states(case, nan=True)
    wst, wd, wv = _plain(st, CFG.border, CFG.num_levels)
    want = [wst.valid] + wd + wv
    writes = [torch.zeros(w.shape, dtype=torch.int32) for w in want]
    H, W = st.valid.shape[-2:]
    tile = [int(re.search(rf"#define ELLC_REF_TILE_{a} (\d+)",
                          depth_refresh_kernel.SOURCE.read_text()).group(1))
            for a in "HW"]
    blocks = (st.valid[..., 0, 0].numel() * -(-H // tile[0])
              * -(-W // tile[1]))
    try:
        for u in range(blocks):
            emulated.lib.emu_run_only(u)
            gst, gd, gv = emulated(st, CFG.border, CFG.num_levels)
            for g, w, n in zip([gst.valid] + gd + gv, want, writes):
                hit = (g.view(torch.uint8) != 0xAB if g.dtype == torch.bool
                       else g.view(torch.int32) != SENTINEL)
                assert same(g[hit], w[hit]), f"block {u}"
                n += hit.to(torch.int32)
    finally:
        emulated.lib.emu_run_only(-1)
    for i, n in enumerate(writes):
        assert bool((n == 1).all()), f"plane {i} written once"


@pytest.mark.parametrize("levels", [1, 2, 3])
def test_emulated_fewer_levels_and_other_borders(emulated, levels):
    st = states("ragged", nan=True)
    for border in (0, levels + 1):
        assert_refresh(emulated(st, border, levels),
                       _plain(st, border, levels))


def test_emulated_batch_gives_each_state_its_own_bits(emulated):
    st = states("videos", nan=True)
    _, depths, vars_ = emulated(st, CFG.border, CFG.num_levels)
    for b in range(2):
        one = st.__class__(**{n: getattr(st, n)[b] for n in dstate.FIELDS})
        _, d1, v1 = emulated(one, CFG.border, CFG.num_levels)
        assert all(same(x[b], y) for x, y in zip(depths + vars_, d1 + v1))


# --- on the card ---

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc (the refresh kernel runs "
                    "only on the GPU)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("case", ALL_CASES)
def test_cuda_matches_twin_and_repeats(cuda_device, case):
    st = states(case, nan=True)
    st = st.__class__(**{n: getattr(st, n).to(cuda_device)
                         for n in dstate.FIELDS})
    depth_refresh_kernel.reset_launches()
    first = fusion.refresh_depth_pyramid(st, CFG)
    second = fusion.refresh_depth_pyramid(st, CFG)
    torch.cuda.synchronize()
    assert depth_refresh_kernel.launches == {"depth_refresh": 2}
    assert_refresh(first, fusion.plain_refresh_depth_pyramid(st, CFG))
    assert_refresh(second, first)
