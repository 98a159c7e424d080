"""The SE(3) compose and relative pose (``geom/lie.py::compose`` and
``::relative``; ``ops/se3_kernel.py``, ``csrc/se3_kernel.cu``) and their
plain twins.

Inputs: numpy-seeded twists, the pose of one video (6,) and of two
videos (2, 6), and 256 poses over every branch of the formulas: angles
under the Taylor threshold (theta^2 < 1e-4), ordinary ones, and angles
near pi, where the quaternion's pivot moves off the trace; translations
up to a few units.

On the CPU:

- the twins (``lie.plain_compose``, ``lie.plain_relative``) against the
  JAX package's ``compose`` and ``relative``, within the geom tests'
  tolerance for a product of two exps and a log (atol 2e-5);
- ``lie.compose`` on CPU tensors runs the twin, launches nothing and
  builds nothing;
- the CUDA source built for the CPU with g++ (``tests/cuda_emulation.py``)
  against the twin by ``se3_kernel.agreement``: each pose within
  ``COMPOSE_TOL`` (1e-6) of the twin in every component, or no farther
  from the float64 compose than the twin is, plus that bound.  The twin's
  quaternion norms are ``torch.linalg.vector_norm``, whose summation is
  ATen's, and its sin, cos and atan2 ATen's CPU kernels, not glibc's; at
  translations of a few units float32 lies up to ~4e-6 from float64, and
  the two builds up to ~3e-6 apart (2 of 15,360 poses of 60 seeds pass
  only by the float64 clause).

On a card (``python -m pytest tests/test_torch_se3_kernel.py -m cuda
--noconftest``): the kernel held to the twin run on the card by the same
rule, one launch a call for any number of poses and with broadcasting,
and two calls bit-equal.
"""

import ctypes
import re

import cuda_emulation
import numpy as np
import pytest
import torch

from egomotion_with_local_loop_closures_tpu_torch.geom import lie
from egomotion_with_local_loop_closures_tpu_torch.ops import se3_kernel

torch.set_num_threads(1)

NAMES = ("compose", "relative")


def twists(seed, n=256):
    """Twists over the formulas' branches: small (theta^2 < 1e-4),
    ordinary and near-pi rotations, translations up to ~3."""
    rng = np.random.default_rng(seed)
    w = rng.normal(size=(n, 3))
    w /= np.linalg.norm(w, axis=1, keepdims=True)
    angle = np.concatenate([rng.uniform(0.0, 8e-3, n // 4),
                            rng.uniform(0.01, 2.0, n // 2),
                            rng.uniform(2.9, 3.14, n - n // 4 - n // 2)])
    v = rng.normal(size=(n, 3)) * rng.choice([0.01, 1.0], size=(n, 1))
    xi = np.concatenate([w * angle[:, None], v], axis=1).astype(np.float32)
    xi[0] = 0.0
    return xi


def pairs(seed, shape):
    """Two stacks of twists of ``shape`` (..., 6), from numpy."""
    n = int(np.prod(shape[:-1], dtype=int))
    a = twists(seed, max(n, 4))[:n].reshape(shape)
    b = twists(seed + 100, max(n, 4))[::-1][:n].reshape(shape)
    return torch.as_tensor(np.ascontiguousarray(a)), torch.as_tensor(
        np.ascontiguousarray(b))


def plain(name):
    return lie.plain_compose if name == "compose" else lie.plain_relative


SHAPES = {"one": (6,), "videos": (2, 6), "many": (256, 6)}


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("name", NAMES)
def test_twin_matches_jax(name, shape):
    # jax only here: the card's machine runs this file's CUDA cases
    # without it
    import jax.numpy as jnp
    from egomotion_with_local_loop_closures_tpu.geom import lie as jlie
    a, b = pairs(3, SHAPES[shape])
    want = getattr(jlie, name)(jnp.asarray(a.numpy()), jnp.asarray(b.numpy()))
    np.testing.assert_allclose(np.asarray(want), plain(name)(a, b).numpy(),
                               atol=2e-5, rtol=0)


@pytest.mark.parametrize("name", NAMES)
def test_cpu_tensors_take_the_twin(name):
    se3_kernel.reset_launches()
    a, b = pairs(4, (2, 6))
    assert torch.equal(getattr(lie, name)(a, b), plain(name)(a, b))
    assert torch.equal(getattr(lie, name)(a, b[0]), plain(name)(a, b[0]))
    assert se3_kernel.launches == {"se3_compose": 0}
    assert se3_kernel._lib is None


def test_source_and_names():
    code = re.sub(r"//[^\n]*", "", se3_kernel.SOURCE.read_text())
    assert "atomic" not in code and code.count("__global__") == 1
    assert '#include "ellc_device.cuh"' in code
    assert se3_kernel.wrapper_of(
        "_ZN12_GLOBAL__N_111se3_composeE7Se3Args") == "se3_compose"
    assert se3_kernel.wrapper_of(
        "_ZN12_GLOBAL__N_114propagate_linkE9MergeArgs") is None
    with pytest.raises(ValueError):
        se3_kernel.compose(torch.zeros(6), torch.zeros(6))


# --- the CUDA source built for the CPU ---

@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """The library built for the CPU, as a function of compose's
    arguments."""
    lib = se3_kernel.bind(ctypes.CDLL(str(cuda_emulation.build_for_cpu(
        se3_kernel.SOURCE, tmp_path_factory.mktemp("se3_kernel_cpu"), 1))))

    def run(a, b, invert_b):
        shape = torch.broadcast_shapes(a.shape, b.shape)
        return se3_kernel._launch(lib, a.expand(shape), b.expand(shape),
                                  invert_b, 0)
    return run


def assert_near_twin(got, a, b, name):
    diff, apart = se3_kernel.agreement(got, a, b, name == "relative")
    assert apart == 0, f"{name}: {apart} poses apart, {diff:.3g} at most"


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("name", NAMES)
def test_emulated_matches_twin(emulated, name, shape):
    a, b = pairs(5, SHAPES[shape])
    assert_near_twin(emulated(a, b, name == "relative"), a, b, name)


def test_emulated_broadcasts_and_keeps_nan(emulated):
    a, b = pairs(6, (8, 6))
    assert_near_twin(emulated(a, b[3], False), a, b[3].expand(8, 6),
                     "compose")
    a[2, 1] = float("nan")
    got = emulated(a, b, False)
    assert bool(got[2].isnan().all()) and bool(got[[0, 1, 3]].isfinite().all())


# --- on the card ---

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc (the SE(3) kernel runs only "
                    "on the GPU)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("name", NAMES)
def test_cuda_matches_twin_and_repeats(cuda_device, name, shape):
    a, b = (t.to(cuda_device) for t in pairs(7, SHAPES[shape]))
    se3_kernel.reset_launches()
    first = getattr(lie, name)(a, b)
    second = getattr(lie, name)(a, b)
    broadcast = getattr(lie, name)(a, b.reshape(-1, 6)[0])
    torch.cuda.synchronize()
    assert se3_kernel.launches == {"se3_compose": 3}
    assert torch.equal(first, second)
    assert_near_twin(first, a, b, name)
    assert_near_twin(broadcast, a, b.reshape(-1, 6)[0], name)
