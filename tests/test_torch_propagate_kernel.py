"""Keyframe depth propagation on the card (``ops/propagate_kernel.py``,
``csrc/propagate_kernel.cu``: the reprojection, the gates and the merge in
one memset and two launches) and its plain twin (``depth/propagate.py::
candidates`` followed by ``ops/propagate_kernel.py::plain_merge``), which
add each target cell's compatible candidates in ascending source index.

Inputs at 48x64 (a regularized random state into a moved keyframe with
integer grey levels, as ``tests/test_torch_depth.py``): one state; a
batch of three with one new keyframe for all (connection recovery's
trials) and with one new keyframe a state (the batched videos); a
zoom-out (the camera moved back: up to ~40 sources a cell); and a
synthetic state zoomed out with inverse depths on a coarse grid (ties of
the winner), negative and NaN inverse depths (negative and NaN variances)
and a NaN validity.  The merge alone also takes synthetic candidates
whose cells take up to ~200 sources each.

On the CPU:

- the twin's merge (``plain_merge``) equals the merge as the port ran it
  before the kernels (scatter-max and float ``index_add_``, copied below
  as ``_merge_before``) bit for bit;
- ``ranked_sums`` (the twin's sums on the card: a stable sort by target,
  then one rank of every cell a step) equals the CPU's ``index_add_`` bit
  for bit, over those inputs and over 200,000 random adds into 5,000
  cells at 8 threads;
- the CUDA source built for the CPU with g++ (``tests/cuda_emulation.py``)
  equals the twin bit for bit in every plane, with the grid's blocks run
  in order, in reverse and odd-then-even (the order in which the
  candidates reach their lists does not matter); each state of a batch
  gets the bits it gets alone; written into sentinel-filled planes it
  leaves no cell unwritten, and each block of the merge writes its own
  cells and no other;
- ``propagate`` on CPU tensors runs the twin and launches nothing, the
  module imports without nvcc, and the source's atomics exchange ints.

On a card (``-m cuda``; ``python -m pytest
tests/test_torch_propagate_kernel.py -m cuda --noconftest``): the kernels
bit-equal to the twin there, for one state and the batches, and two calls
bit-equal.
"""

import ctypes
import re

import cuda_emulation
import numpy as np
import pytest
import torch

from egomotion_with_local_loop_closures_tpu_torch.config import ELLCConfig
from egomotion_with_local_loop_closures_tpu_torch.depth import (
    propagate, state as dstate)
from egomotion_with_local_loop_closures_tpu_torch.depth.state import (
    FIELDS, DepthMapState)
from egomotion_with_local_loop_closures_tpu_torch.ops import propagate_kernel

torch.set_num_threads(1)

KW = dict(rows=48, cols=64, fx=60.0, fy=60.0, cx=32.0, cy=24.0,
          bootstrap_rng="glibc")
# a loose photometric gate, so that many candidates reach the merge
CFG = ELLCConfig(**KW).replace(max_diff_constant=1e6)
CASES = ("seed0", "seed1", "batch3", "zoom_out", "fan_in")


def _states(seed, B=None, zoom=False, per_state=False):
    """propagate()'s arguments but the config: a state (or B rolled
    copies), the old keyframe's image, the new keyframe's image and max
    gradient (one for all states, or with ``per_state`` one a state) and
    the pose(s)."""
    rng = np.random.default_rng(10 + seed)
    mg = (12.0 * rng.uniform(size=(48, 64))).astype(np.float32)
    st = propagate.regularize(
        dstate.initialize_random(None, torch.as_tensor(mg), CFG), CFG)
    lead = () if B is None else (B,)
    if B is not None:
        st = DepthMapState(**{n: torch.stack([
            torch.roll(getattr(st, n), (2 * b, 5 * b), (0, 1))
            for b in range(B)]) for n in FIELDS})
    new_lead = lead if per_state else ()
    old = np.round(255 * rng.uniform(size=lead + (48, 64)))
    new = np.round(255 * rng.uniform(size=new_lead + (48, 64)))
    new_mg = 5.0 + 10.0 * rng.uniform(size=new_lead + (48, 64))
    pose = rng.normal(size=lead + (6,)) * [0.01, 0.01, 0.01, 0.05, 0.05,
                                           0.05]
    if zoom:
        pose[..., 5] = 4.0         # the camera moved back: cells fill up
    return (st, *(torch.as_tensor(a.astype(np.float32))
                  for a in (old, new, new_mg, pose)))


def _fan_in_state():
    """A synthetic state zoomed out 4 units with no rotation: a target's
    inverse depth hangs on its source's alone, and the smoothed inverse
    depths lie on a coarse grid (ties of the winner); some inverse depths
    negative or NaN (negative and NaN variances), one NaN validity, a
    tenth of the pixels not valid."""
    rng = np.random.default_rng(17)
    shape = (48, 64)
    ids = np.round(rng.uniform(0.5, 1.5, size=shape) * 8) / 8
    idepth = ids * np.where(rng.uniform(size=shape) < 0.05, -0.01, 1.0)
    idepth[rng.uniform(size=shape) < 0.01] = np.nan
    validity = rng.uniform(0.0, 40.0, size=shape)
    validity[20, 30] = np.nan
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32))  # noqa: E731
    st = DepthMapState(
        idepth=f32(idepth), var=f32(rng.uniform(0.01, 0.1, size=shape)),
        idepth_smoothed=f32(ids), var_smoothed=f32(np.full(shape, 0.05)),
        validity=f32(validity),
        blacklisted=torch.zeros(shape, dtype=torch.int32),
        valid=torch.as_tensor(rng.uniform(size=shape) < 0.9))
    old = np.round(255 * rng.uniform(size=shape))
    return (st, f32(old), f32(np.round(255 * rng.uniform(size=shape))),
            f32(5.0 + 10.0 * rng.uniform(size=shape)),
            f32([0.0, 0.0, 0.0, 0.01, -0.02, 4.0]))


def _propagated(seed, B=None, zoom=False):
    """candidates()' outputs and the state's shape."""
    args = _states(seed, B, zoom)
    return propagate.candidates(*args, CFG), args[0].idepth.shape


def _fan_in():
    """Synthetic candidates: 2,400 sources of a 40x60 grid into 23 cells
    (every 100th), cell k taking k / 276 of them (up to ~200); inverse
    depths on a coarse grid (ties of the winner), wide variances (most
    candidates compatible), some negative and some NaN variances, one NaN
    validity."""
    rng = np.random.default_rng(7)
    n = 40 * 60
    tgt = rng.choice(24, size=n, p=np.arange(24) / np.arange(24).sum())
    tgt = tgt * 100
    idepth = np.round(rng.uniform(0.5, 1.5, size=n) * 8) / 8
    var = rng.uniform(0.05, 2.0, size=n)
    var[rng.uniform(size=n) < 0.05] *= -0.01
    var[rng.uniform(size=n) < 0.01] = np.nan
    validity = rng.uniform(0.0, 40.0, size=n)
    validity[17] = np.nan
    cand = rng.uniform(size=n) < 0.9
    f32 = lambda a: torch.as_tensor(a.astype(np.float32))  # noqa: E731
    return (torch.as_tensor(tgt.astype(np.int64)), torch.as_tensor(cand),
            f32(idepth), f32(var), f32(validity)), (40, 60)


@pytest.fixture(scope="module")
def inputs():
    return {"seed0": _propagated(0), "seed1": _propagated(1),
            "batch3": _propagated(2, B=3),
            "zoom_out": _propagated(3, zoom=True), "fan_in": _fan_in()}


# the whole propagate's cases: propagate()'s arguments but the config
STATES = ("seed0", "seed1", "batch3_shared", "batch3_per_state", "zoom_out",
          "fan_in")
BATCHES = ("batch3_shared", "batch3_per_state")


@pytest.fixture(scope="module")
def states():
    return {"seed0": _states(0), "seed1": _states(1),
            "batch3_shared": _states(2, B=3),
            "batch3_per_state": _states(2, B=3, per_state=True),
            "zoom_out": _states(3, zoom=True), "fan_in": _fan_in_state()}


def _merge_before(tgt, cand, idepth, var, validity, shape, cfg):
    """The merge of ``depth/propagate.py::propagate`` before the kernels,
    line for line: one scatter-max, the winner's variance, and four float
    ``index_add_`` calls over every source."""
    N = tgt.numel()
    flat_id = torch.where(cand, idepth, float("-inf"))
    flat_var = var

    def scatter_max(init, vals):
        return torch.full((N,), init, dtype=torch.float32
                          ).scatter_reduce(0, tgt, vals, "amax",
                                           include_self=True)

    def scatter_add(vals):
        return torch.zeros((N,), dtype=torch.float32).index_add_(0, tgt, vals)

    winner = scatter_max(float("-inf"), flat_id)
    w_id = winner[tgt]
    win_var_num = scatter_max(
        0.0, torch.where(flat_id == w_id, flat_var, float("-inf")))
    w_var = win_var_num[tgt]
    diff = w_id - flat_id
    compat = cand & (cfg.diff_fac_prop_merge * diff * diff
                     <= flat_var + w_var)
    cvar = torch.where(torch.abs(flat_var) > 1e-12, flat_var, 1e-12)
    ivar = torch.where(compat, 1.0 / cvar, 0.0)
    safe_id = torch.where(compat, flat_id, 0.0)
    sum_ivar = scatter_add(ivar)
    sum_id = scatter_add(ivar * safe_id)
    sum_validity = scatter_add(torch.where(compat, validity, 0.0))
    count = scatter_add(compat.to(torch.float32))
    has = count > 0
    merged_id = torch.where(has, sum_id / torch.where(has, sum_ivar, 1.0), 0.0)
    merged_var = torch.where(has, 1.0 / torch.where(has, sum_ivar, 1.0), 0.0)
    merged_validity = torch.clamp_max(
        sum_validity,
        cfg.validity_counter_max + cfg.validity_counter_max_variable)
    return DepthMapState(
        idepth=merged_id.reshape(shape), var=merged_var.reshape(shape),
        idepth_smoothed=torch.full(shape, -1.0),
        var_smoothed=torch.full(shape, -1.0),
        validity=merged_validity.reshape(shape),
        blacklisted=torch.zeros(shape, dtype=torch.int32),
        valid=has.reshape(shape))


def assert_bits(got, want):
    for name in FIELDS:
        a, b = getattr(got, name), getattr(want, name)
        assert a.shape == b.shape and a.dtype == b.dtype, name
        torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True,
                                   msg=lambda m: f"{name}: {m}")


def _compat_terms(args):
    tgt, cand, idepth, var, validity = args
    compat = propagate_kernel._compat(tgt, cand, idepth, var, CFG,
                                      tgt.numel())
    return compat, torch.stack(propagate_kernel._terms(compat, idepth, var,
                                                       validity))


def test_inputs_reach_long_lists(inputs, states):
    """A cell of the zoom-outs takes more compatible candidates than the
    kernel selects in one walk (kChunk), and a
    fan-in cell of the synthetic candidates more than eight times as
    many: the multi-walk path runs; every other case's lists fit."""
    chunk = int(re.search(r"kChunk = (\d+);",
                          propagate_kernel.SOURCE.read_text()).group(1))
    fan = {}
    for case in ("zoom_out", "fan_in"):
        args, _ = inputs[case]
        compat, _ = _compat_terms(args)
        fan[case] = int(torch.bincount(args[0][compat]).max())
    assert fan["zoom_out"] > chunk and fan["fan_in"] > 8 * chunk, fan
    lists = {}
    for case, args in states.items():
        tgt, cand = propagate.candidates(*args, CFG)[:2]
        lists[case] = int(torch.bincount(tgt[cand]).max())
    assert lists["zoom_out"] > chunk and lists["fan_in"] > chunk, lists
    assert all(n <= chunk for case, n in lists.items()
               if case not in ("zoom_out", "fan_in")), lists


@pytest.mark.parametrize("case", CASES)
def test_twin_equals_the_merge_before_the_kernels(inputs, case):
    args, shape = inputs[case]
    got = propagate_kernel.plain_merge(*args, shape, CFG)
    assert_bits(got, _merge_before(*args, shape, CFG))
    assert 0 < int(got.valid.sum()) < got.valid.numel()


@pytest.mark.parametrize("case", CASES)
def test_ranked_sums_equal_index_add_on_the_cpu(inputs, case):
    args, _ = inputs[case]
    compat, terms = _compat_terms(args)
    tgt = args[0]
    want = torch.stack([torch.zeros(tgt.numel()).index_add_(0, tgt, t)
                        for t in terms])
    torch.testing.assert_close(
        propagate_kernel.ranked_sums(tgt, compat, terms), want, rtol=0,
        atol=0, equal_nan=True)


def test_ranked_sums_equal_index_add_on_random_adds():
    """200,000 float adds into 5,000 cells, torch at 8 threads."""
    rng = np.random.default_rng(0)
    tgt = torch.as_tensor(rng.integers(0, 5000, size=200_000))
    vals = torch.as_tensor(rng.normal(size=(2, 200_000)).astype(np.float32))
    vals[1] *= torch.as_tensor(10.0 ** rng.integers(-6, 6, size=200_000)
                               ).float()
    threads = torch.get_num_threads()
    torch.set_num_threads(8)
    try:
        want = torch.stack([torch.zeros(200_000).index_add_(0, tgt, v)
                            for v in vals])
    finally:
        torch.set_num_threads(threads)
    got = propagate_kernel.ranked_sums(
        tgt, torch.ones(200_000, dtype=torch.bool), vals)
    assert torch.equal(got, want)


def test_propagate_takes_the_twin_on_the_cpu(states):
    """``propagate`` on CPU tensors is ``candidates`` then ``plain_merge``:
    it launches nothing and builds nothing; the kernels' wrapper takes
    CUDA tensors only."""
    propagate_kernel.reset_launches()
    args = states["seed0"]
    assert_bits(propagate.propagate(*args, CFG),
                propagate_kernel.plain_merge(
                    *propagate.candidates(*args, CFG),
                    args[0].idepth.shape, CFG))
    assert propagate_kernel.launches == {"propagate_candidates": 0,
                                         "propagate_merge": 0}
    assert propagate_kernel._lib is None
    with pytest.raises(ValueError):
        propagate_kernel.propagate(*args, CFG)


def test_source_atomics_exchange_ints_and_names_map():
    code = re.sub(r"//[^\n]*", "", propagate_kernel.SOURCE.read_text())
    assert re.findall(r"(atomic\w*)\(", code) == ["atomicExch"]
    assert re.search(r"int32_t\* head;", code)
    assert code.count("__global__") == 2
    assert propagate_kernel.wrapper_of(
        "_ZN12_GLOBAL__N_120propagate_candidatesE13PropagateArgs") == \
        "propagate_candidates"
    assert propagate_kernel.wrapper_of(
        "_ZN12_GLOBAL__N_115propagate_mergeE13PropagateArgs") == \
        "propagate_merge"
    assert propagate_kernel.wrapper_of(
        "_ZN12_GLOBAL__N_114stereo_observeENS_10StereoArgsE") is None


# --- the CUDA source built for the CPU ---

@pytest.fixture(scope="module", params=[0, 1, 2],
                ids=["in_order", "reversed", "odd_then_even"])
def emulated(request, tmp_path_factory):
    """The library built for the CPU with the grid's blocks run in the
    given order, as a function of propagate's arguments but the config
    (and, optionally, the planes to write into); the library itself as
    ``run.lib``."""
    lib = propagate_kernel.bind(ctypes.CDLL(str(cuda_emulation.build_for_cpu(
        propagate_kernel.SOURCE,
        tmp_path_factory.mktemp(f"propagate_kernel_cpu{request.param}"), 2,
        (f"EMU_BLOCK_ORDER={request.param}",)))))

    def run(args, out=None):
        return propagate_kernel._launch(lib, *args, CFG, 0, out)
    run.lib = lib
    return run


def _twin(args):
    return propagate.propagate(*args, CFG)


@pytest.mark.parametrize("case", STATES)
def test_emulated_matches_twin(states, emulated, case):
    got = emulated(states[case])
    assert_bits(got, _twin(states[case]))
    assert 0 < int(got.valid.sum()) < got.valid.numel()


@pytest.mark.parametrize("case", BATCHES)
def test_emulated_batch_gives_each_state_its_own_bits(states, emulated,
                                                      case):
    st, old, new, mg, pose = states[case]
    got = emulated((st, old, new, mg, pose))
    for b in range(st.idepth.shape[0]):
        one = DepthMapState(**{n: getattr(st, n)[b] for n in FIELDS})
        shared = new.dim() == 2
        alone = emulated((one, old[b], new if shared else new[b],
                          mg if shared else mg[b], pose[b]))
        assert_bits(DepthMapState(**{n: getattr(got, n)[b] for n in FIELDS}),
                    alone)


SENTINEL = {torch.float32: 0x7FC0DEAD, torch.int32: 0x5A5A5A5A,
            torch.bool: 0x5A}


def _sentinels(like: DepthMapState) -> DepthMapState:
    """Planes of ``like``'s shapes and dtypes filled with a bit pattern
    that no output takes (a NaN payload, a byte neither 0 nor 1)."""
    def fill(t):
        if t.dtype == torch.bool:
            return torch.full(t.shape, SENTINEL[t.dtype], dtype=torch.uint8
                              ).view(torch.bool)
        return torch.full(t.shape, SENTINEL[t.dtype], dtype=torch.int32
                          ).view(t.dtype)
    return DepthMapState(**{n: fill(getattr(like, n)) for n in FIELDS})


def _untouched(planes: DepthMapState) -> torch.Tensor:
    """Per cell: True where every plane still holds its sentinel."""
    masks = []
    for n in FIELDS:
        t = getattr(planes, n)
        bits = t.view(torch.uint8) if t.dtype == torch.bool else \
            t.view(torch.int32)
        masks.append(bits == SENTINEL[t.dtype])
    return torch.stack(masks).all(0)


@pytest.mark.parametrize("case", ("batch3_per_state", "fan_in"))
def test_emulated_writes_every_cell_once(states, emulated, case):
    """Into sentinel-filled planes: every cell written, the twin's bits;
    then with one block of the merge at a time, each block's cells are
    the 256 after its index times 256, and no two blocks write a cell."""
    args = states[case]
    want = _twin(args)
    out = _sentinels(want)
    got = emulated(args, out)
    assert got is out and not bool(_untouched(out).any())
    assert_bits(out, want)
    n = want.idepth.numel()
    owner = torch.full((n,), -1, dtype=torch.int64)
    blocks = -(-n // 256)
    try:
        for u in range(blocks):
            emulated.lib.emu_run_only(u)
            out = _sentinels(want)
            emulated(args, out)
            written = (~_untouched(out)).reshape(-1)
            assert not bool((owner[written] >= 0).any()), u
            owner[written] = u
    finally:
        emulated.lib.emu_run_only(-1)
    assert torch.equal(owner, torch.arange(n) // 256)


# --- on the card ---

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc (the propagate kernels run "
                    "only on the GPU)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("case", STATES)
def test_cuda_matches_twin_and_repeats(states, cuda_device, case):
    st, *rest = states[case]
    args = (DepthMapState(**{n: getattr(st, n).to(cuda_device)
                             for n in FIELDS}),
            *(t.to(cuda_device) for t in rest))
    propagate_kernel.reset_launches()
    first = propagate.propagate(*args, CFG)
    second = propagate.propagate(*args, CFG)
    torch.cuda.synchronize()
    assert propagate_kernel.launches == {"propagate_candidates": 2,
                                         "propagate_merge": 2}
    assert_bits(first, _twin(args))
    assert_bits(second, first)
