"""The current frame's pyramid, gradients and max-gradient map
(``image/pyramid.py``; ``ops/pyramid_kernel.py``,
``csrc/pyramid_kernel.cu``) and their plain twins.

Inputs: numpy-seeded integer grey levels (decoded frames) at
``TEST_CONFIG``'s 96x128 for one video and for two (2, 96, 128), a ragged
45x67 frame (floor-halved levels of odd sizes), a frame with a NaN and an
inf, a frame of fractional grey levels (where the blur's sums round, so
their order shows), two 70x100 frames (each level's edge falls inside a
block's tile, and the last row and column of tiles own no level-3 cell)
and the smallest four-level frame, 16x16 (level 3 is 2x2).

On the CPU:

- the twin (``pyramid.plain_build_levels``, what ``build_levels`` runs
  on the CPU) against the JAX package's ``build_pyramid``, ``gradients``
  and ``max_abs_gradient``: level 0's gradients exact, the blurred levels
  and their gradients within atol 1e-4 (a few float32 units in the last
  place of 255), the max-gradient map within atol 1e-4;
- the twin's max-gradient map, whose square root is taken in float64 and
  rounded once, is the map as the port computed it before (float32
  ``torch.sqrt``) within a last place;
- the functions on CPU tensors run the twins, launch nothing and build
  nothing;
- the CUDA source built for the CPU with g++ (``tests/cuda_emulation.py``)
  equals the twin bit for bit in every level, gradient and the map (NaN
  equal to NaN), for one image and a batch, with and without gradients,
  and the map from gradient planes (``max_abs_gradient``), in one launch
  a ``build_levels`` call (two for five levels); so it does with the
  grid's blocks run in reverse and odd blocks first, and built with the
  other tiles that ``tools/time_k4.py`` times;
- each block writes only the cells it owns: run one block at a time into
  outputs filled with a sentinel, every cell is written by exactly one
  block, with the twin's bits.

On a card (``python -m pytest tests/test_torch_pyramid_kernel.py -m cuda
--noconftest``): the kernel bit-equal to the twin there, one launch a
``build_levels``, ``gradients`` or ``max_abs_gradient`` call, and two
calls bit-equal.
"""

import ctypes
import re

import cuda_emulation
import numpy as np
import pytest
import torch

from egomotion_with_local_loop_closures_tpu_torch.image import pyramid
from egomotion_with_local_loop_closures_tpu_torch.ops import pyramid_kernel

torch.set_num_threads(1)

LEVELS = 4
CASES = {"one": (96, 128), "videos": (2, 96, 128), "ragged": (45, 67),
         "nan": (2, 45, 67), "fractional": (96, 128)}
# each level's edge inside a tile, and the smallest four-level frame
EDGE_CASES = {"edge": (2, 70, 100), "small": (16, 16)}
ALL_CASES = {**CASES, **EDGE_CASES}
# tiles and block sizes tools/time_k4.py times beside the source's
TILES = ("ELLC_PYR_TILE_H=16,ELLC_PYR_TILE_W=16,ELLC_PYR_THREADS=256",
         "ELLC_PYR_TILE_W=32,ELLC_PYR_THREADS=256",
         "ELLC_PYR_TILE_H=64,ELLC_PYR_THREADS=1024",
         "ELLC_PYR_TILE_W=64")


def frames(case):
    seed = (sorted(CASES).index(case) if case in CASES
            else 10 + sorted(EDGE_CASES).index(case))
    rng = np.random.default_rng(seed)
    img = 255 * rng.uniform(size=ALL_CASES[case])
    if case != "fractional":        # a blur of integers rounds rarely
        img = np.round(img)
    img = img.astype(np.float32)
    if case == "nan":
        img[0, 20, 30] = np.nan
        img[1, 3, 60] = np.inf
    return torch.as_tensor(img)


def same(a, b):
    """Bit for bit, NaN equal to NaN."""
    return a.shape == b.shape and bool(
        ((a == b) | (a.isnan() & b.isnan())).all())


def assert_levels(got, want):
    for name in pyramid.Levels._fields:
        g, w = getattr(got, name), getattr(want, name)
        if w is None:
            assert g is None, name
            continue
        for i, (x, y) in enumerate(zip(g, w) if isinstance(w, tuple)
                                   else [(g, w)]):
            assert same(x, y), f"{name}[{i}]"


@pytest.mark.parametrize("case", ["one", "videos", "ragged"])
def test_twin_matches_jax(case):
    # jax only here: the card's machine runs this file's CUDA cases
    # without it
    import jax.numpy as jnp
    from egomotion_with_local_loop_closures_tpu.image import pyramid as jpyr
    img = frames(case)
    lv = pyramid.plain_build_levels(img, LEVELS, max_grad=True)
    stack = img.reshape((-1,) + img.shape[-2:])
    for b in range(stack.shape[0]):
        jl = jpyr.build_pyramid(jnp.asarray(stack[b].numpy()), LEVELS)
        for level, jimg in enumerate(jl):
            got = lv.images[level].reshape(
                (-1,) + lv.images[level].shape[-2:])[b]
            np.testing.assert_allclose(np.asarray(jimg), got.numpy(),
                                       atol=1e-4, rtol=0)
            jgx, jgy = jpyr.gradients(jimg)
            for j, t in ((jgx, lv.gradx[level]), (jgy, lv.grady[level])):
                np.testing.assert_allclose(
                    np.asarray(j), t.reshape((-1,) + t.shape[-2:])[b].numpy(),
                    atol=0 if level == 0 else 1e-4, rtol=0)
        jmg = jpyr.max_abs_gradient(*jpyr.gradients(jl[0]))
        np.testing.assert_allclose(
            np.asarray(jmg),
            lv.maxgrad.reshape((-1,) + img.shape[-2:])[b].numpy(),
            atol=1e-4, rtol=0)


def _map_before(gx, gy):
    """The max-gradient map as the port computed it before the kernel,
    its square root float32 ``torch.sqrt``."""
    mag = torch.sqrt(gx * gx + gy * gy)
    vert = torch.maximum(torch.maximum(mag[..., :-2, :], mag[..., 1:-1, :]),
                         mag[..., 2:, :])
    tmp = torch.cat([mag[..., :1, :], vert, mag[..., -1:, :]], dim=-2)
    horiz = torch.maximum(torch.maximum(tmp[..., :-2], tmp[..., 1:-1]),
                          tmp[..., 2:])
    out = mag.clone()
    out[..., 1:-1, 1:-1] = horiz[..., 1:-1, :]
    return out


def test_twin_map_is_the_map_before_within_a_last_place():
    gx, gy = pyramid.plain_gradients(frames("videos"))
    got = pyramid.plain_max_abs_gradient(gx, gy)
    before = _map_before(gx, gy)
    ulp = torch.nextafter(before, torch.full_like(before, float("inf"))) \
        - before
    assert bool(((got - before).abs() <= ulp).all())


def test_cpu_tensors_take_the_twin():
    pyramid_kernel.reset_launches()
    img = frames("videos")
    assert_levels(pyramid.build_levels(img, LEVELS, max_grad=True),
                  pyramid.plain_build_levels(img, LEVELS, max_grad=True))
    for a, b in zip(pyramid.build_pyramid(img, LEVELS),
                    pyramid.plain_build_pyramid(img, LEVELS)):
        assert same(a, b)
    gx, gy = pyramid.gradients(img)
    assert same(pyramid.max_abs_gradient(gx, gy),
                pyramid.plain_max_abs_gradient(gx, gy))
    assert pyramid_kernel.launches == {"pyramid_level": 0}
    assert pyramid_kernel._lib is None


def test_source_and_names():
    code = re.sub(r"//[^\n]*", "", pyramid_kernel.SOURCE.read_text())
    assert "atomic" not in code and code.count("__global__") == 1
    assert re.search(r"kMaxLevels = (\d+);", code).group(1) == str(
        pyramid_kernel.MAX_LEVELS)
    assert pyramid_kernel.wrapper_of(
        "_ZN12_GLOBAL__N_113pyramid_levelE11PyramidArgs") == "pyramid_level"
    assert pyramid_kernel.wrapper_of(
        "_ZN12_GLOBAL__N_111se3_composeE7Se3Args") is None
    with pytest.raises(ValueError):
        pyramid_kernel.build_levels(torch.zeros(8, 8), 2)


# --- the CUDA source built for the CPU ---

def _build(tmp_path_factory, name, defines=()):
    return pyramid_kernel.bind(ctypes.CDLL(str(cuda_emulation.build_for_cpu(
        pyramid_kernel.SOURCE, tmp_path_factory.mktemp(name), 2, defines))))


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """The library built for the CPU."""
    return _build(tmp_path_factory, "pyramid_kernel_cpu")


@pytest.fixture(scope="module", params=[1, 2],
                ids=["reversed", "odd_then_even"])
def emulated_in_order(request, tmp_path_factory):
    """The library built for the CPU with the grid's blocks run in the
    given order."""
    return _build(tmp_path_factory, f"pyramid_kernel_cpu{request.param}",
                  (f"EMU_BLOCK_ORDER={request.param}",))


def assert_matches_twin(lib, img, levels=LEVELS, launches=1):
    """``_levels`` of ``lib`` bit-equal to the twin, with gradients and the
    map and without either, in ``launches`` launches a call (none for one
    level without either: nothing to write)."""
    imgs, gx, gy, mg, n = pyramid_kernel._levels(lib, img, levels, True,
                                                 True, 0)
    assert n == launches
    assert_levels(pyramid.Levels(tuple(imgs), tuple(gx), tuple(gy), mg),
                  pyramid.plain_build_levels(img, levels, max_grad=True))
    imgs, gx, gy, mg, n = pyramid_kernel._levels(lib, img, levels, False,
                                                 False, 0)
    assert n == (0 if levels == 1 else launches) and gx == [] and mg is None
    for a, b in zip(imgs, pyramid.plain_build_pyramid(img, levels)):
        assert same(a, b)


@pytest.mark.parametrize("case", ALL_CASES)
def test_emulated_matches_twin(emulated, case):
    assert_matches_twin(emulated, frames(case))


@pytest.mark.parametrize("case", ALL_CASES)
def test_emulated_block_orders(emulated_in_order, case):
    assert_matches_twin(emulated_in_order, frames(case))


@pytest.mark.parametrize("tile", TILES,
                         ids=["16x16", "32x32", "64x48", "32x64"])
def test_emulated_other_tiles(tmp_path_factory, tile):
    lib = _build(tmp_path_factory, "pyramid_kernel_tile",
                 tuple(tile.split(",")))
    for case in ("nan", "edge", "small", "fractional"):
        assert_matches_twin(lib, frames(case))
    gx, gy = pyramid.plain_gradients(frames("edge"))
    assert same(pyramid_kernel._maxgrad(lib, gx, gy, 0),
                pyramid.plain_max_abs_gradient(gx, gy))


@pytest.mark.parametrize("levels", [1, 2, 5])
def test_emulated_other_level_counts(emulated, levels):
    # five levels: a second launch from level 3, which leaves level 3's
    # gradients to the first
    assert_matches_twin(emulated, frames("videos"), levels,
                        2 if levels > pyramid_kernel.MAX_LEVELS else 1)
    with pytest.raises(ValueError):
        pyramid_kernel._levels(emulated, frames("small"), 5, True, False, 0)


SENTINEL = 0x7FBADBAD       # a signalling NaN: no arithmetic makes it


def test_emulated_each_block_writes_its_own_cells(emulated, monkeypatch):
    """One block at a time into outputs filled with the sentinel: every
    cell is written by exactly one block, with the twin's bits."""
    monkeypatch.setattr(pyramid_kernel, "_empty", lambda shape, device: (
        torch.full(shape, SENTINEL, dtype=torch.int32).view(torch.float32)))
    img = frames("edge")
    want = pyramid.plain_build_levels(img, LEVELS, max_grad=True)
    gx0, gy0 = want.gradx[0], want.grady[0]
    outs = {"images": want.images[1:], "gradx": want.gradx,
            "grady": want.grady, "maxgrad": (want.maxgrad,),
            "map_alone": (want.maxgrad,)}
    writes = {k: [torch.zeros(w.shape, dtype=torch.int32) for w in ws]
              for k, ws in outs.items()}
    tile = [int(re.search(rf"#define ELLC_PYR_TILE_{a} (\d+)",
                          pyramid_kernel.SOURCE.read_text()).group(1))
            for a in "HW"]
    blocks = img.shape[0] * -(-70 // tile[0]) * -(-100 // tile[1])
    run_only = emulated.emu_run_only
    try:
        for u in range(blocks):
            run_only(u)
            imgs, gx, gy, mg, _ = pyramid_kernel._levels(emulated, img, LEVELS,
                                                         True, True, 0)
            got = {"images": imgs[1:], "gradx": gx, "grady": gy,
                   "maxgrad": (mg,),
                   "map_alone": (pyramid_kernel._maxgrad(emulated, gx0, gy0,
                                                         0),)}
            for k, ws in outs.items():
                for g, w, n in zip(got[k], ws, writes[k]):
                    hit = g.view(torch.int32) != SENTINEL
                    assert same(g[hit], w[hit]), f"block {u}: {k}"
                    n += hit.to(torch.int32)
    finally:
        run_only(-1)
    for k, ns in writes.items():
        for level, n in enumerate(ns):
            assert bool((n == 1).all()), f"{k}[{level}] written once"


@pytest.mark.parametrize("case", ["videos", "nan"])
def test_emulated_map_from_gradient_planes(emulated, case):
    gx, gy = pyramid.plain_gradients(frames(case))
    assert same(pyramid_kernel._maxgrad(emulated, gx, gy, 0),
                pyramid.plain_max_abs_gradient(gx, gy))


def test_emulated_batch_gives_each_image_its_own_bits(emulated):
    img = frames("videos")
    got = pyramid_kernel._levels(emulated, img, LEVELS, True, True, 0)
    for b in range(img.shape[0]):
        alone = pyramid_kernel._levels(emulated, img[b], LEVELS, True, True,
                                       0)
        for g, a in zip(got[:3], alone[:3]):
            assert all(same(x[b], y) for x, y in zip(g, a))
        assert same(got[3][b], alone[3])


# --- on the card ---

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc (the pyramid kernel runs "
                    "only on the GPU)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("case", ALL_CASES)
def test_cuda_matches_twin_and_repeats(cuda_device, case):
    img = frames(case).to(cuda_device)
    pyramid_kernel.reset_launches()
    first = pyramid.build_levels(img, LEVELS, max_grad=True)
    second = pyramid.build_levels(img, LEVELS, max_grad=True)
    gx, gy = pyramid.gradients(img)
    mg = pyramid.max_abs_gradient(gx, gy)
    torch.cuda.synchronize()
    # one launch a build_levels call of up to four levels, a gradients
    # call and a max_abs_gradient call
    assert pyramid_kernel.launches == {"pyramid_level": 4}
    assert_levels(first, pyramid.plain_build_levels(img, LEVELS,
                                                    max_grad=True))
    assert_levels(second, first)
    assert same(mg, first.maxgrad)
