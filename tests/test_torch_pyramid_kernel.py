"""The current frame's pyramid, gradients and max-gradient map
(``image/pyramid.py``; ``ops/pyramid_kernel.py``,
``csrc/pyramid_kernel.cu``) and their plain twins.

Inputs: numpy-seeded integer grey levels (decoded frames) at
``TEST_CONFIG``'s 96x128 for one video and for two (2, 96, 128), a ragged
45x67 frame (floor-halved levels of odd sizes), a frame with a NaN and an
inf, and a frame of fractional grey levels (where the blur's sums round,
so their order shows).

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
  and the map from gradient planes (``max_abs_gradient``).

On a card (``python -m pytest tests/test_torch_pyramid_kernel.py -m cuda
--noconftest``): the kernel bit-equal to the twin there, one launch a
level, and two calls bit-equal.
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


def frames(case):
    rng = np.random.default_rng(sorted(CASES).index(case))
    img = 255 * rng.uniform(size=CASES[case])
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
    assert pyramid_kernel.wrapper_of(
        "_ZN12_GLOBAL__N_113pyramid_levelE11PyramidArgs") == "pyramid_level"
    assert pyramid_kernel.wrapper_of(
        "_ZN12_GLOBAL__N_111se3_composeE7Se3Args") is None
    with pytest.raises(ValueError):
        pyramid_kernel.build_levels(torch.zeros(8, 8), 2)


# --- the CUDA source built for the CPU ---

@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """The library built for the CPU."""
    return pyramid_kernel.bind(ctypes.CDLL(str(cuda_emulation.build_for_cpu(
        pyramid_kernel.SOURCE, tmp_path_factory.mktemp("pyramid_kernel_cpu"),
        2))))


@pytest.mark.parametrize("case", CASES)
def test_emulated_matches_twin(emulated, case):
    img = frames(case)
    imgs, gx, gy, mg, n = pyramid_kernel._levels(emulated, img, LEVELS, True,
                                                 True, 0)
    assert n == LEVELS
    assert_levels(pyramid.Levels(tuple(imgs), tuple(gx), tuple(gy), mg),
                  pyramid.plain_build_levels(img, LEVELS, max_grad=True))
    imgs, gx, gy, mg, n = pyramid_kernel._levels(emulated, img, LEVELS,
                                                 False, False, 0)
    assert n == LEVELS - 1 and gx == [] and mg is None
    for a, b in zip(imgs, pyramid.plain_build_pyramid(img, LEVELS)):
        assert same(a, b)


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
@pytest.mark.parametrize("case", CASES)
def test_cuda_matches_twin_and_repeats(cuda_device, case):
    img = frames(case).to(cuda_device)
    pyramid_kernel.reset_launches()
    first = pyramid.build_levels(img, LEVELS, max_grad=True)
    second = pyramid.build_levels(img, LEVELS, max_grad=True)
    gx, gy = pyramid.gradients(img)
    mg = pyramid.max_abs_gradient(gx, gy)
    torch.cuda.synchronize()
    assert pyramid_kernel.launches == {"pyramid_level": 2 * LEVELS + 2}
    assert_levels(first, pyramid.plain_build_levels(img, LEVELS,
                                                    max_grad=True))
    assert_levels(second, first)
    assert same(mg, first.maxgrad)
