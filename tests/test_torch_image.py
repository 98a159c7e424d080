"""The port's image modules (pyramid, gradients, bilinear sampling) held
against the JAX package on the same numpy inputs.

Tolerances: blur and sampling agree to atol 1e-4 on 0..255 images
(a few float32 ulp of the largest value); gradients are exact; the
out-of-bounds masks must be equal.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from egomotion_with_local_loop_closures_tpu.image import interp as jinterp
from egomotion_with_local_loop_closures_tpu.image import pyramid as jpyr

from egomotion_with_local_loop_closures_tpu_torch.image import interp, pyramid

torch.set_num_threads(1)

ATOL = 1e-4


def image(seed, shape=(45, 67)):
    """Integer-valued frames like decoded video (odd shape on purpose:
    the pyramid halves with floor)."""
    rng = np.random.default_rng(seed)
    return np.round(255 * rng.uniform(size=shape)).astype(np.float32)


def close(a, b, atol=ATOL):
    np.testing.assert_allclose(np.asarray(a), b.numpy(), atol=atol, rtol=0)


def test_blur_and_pyramid_match_jax():
    img = image(0)
    close(jpyr._sep_blur5(jnp.asarray(img)),
          pyramid._sep_blur5(torch.as_tensor(img)))
    pj = jpyr.build_pyramid(jnp.asarray(img), 4)
    pt = pyramid.build_pyramid(torch.as_tensor(img), 4)
    assert [tuple(a.shape) for a in pj] == [tuple(b.shape) for b in pt]
    for a, b in zip(pj, pt):
        close(a, b)


def test_gradients_and_max_gradient_match_jax():
    img = image(1)
    gj = jpyr.gradients(jnp.asarray(img))
    gt = pyramid.gradients(torch.as_tensor(img))
    for a, b in zip(gj, gt):
        close(a, b, atol=0)
    close(jpyr.max_abs_gradient(*gj), pyramid.max_abs_gradient(*gt))


@pytest.mark.parametrize("spread", [0.0, 6.0])
def test_bilinear_matches_jax_with_out_of_bounds(spread):
    """Coordinates inside, on the border and outside the image: each
    corner outside contributes 0, and the mask is False only when all
    four corners are outside."""
    img = image(2)
    H, W = img.shape
    rng = np.random.default_rng(3)
    x = rng.uniform(-spread - 1.5, W + spread + 0.5, size=(40, 50))
    y = rng.uniform(-spread - 1.5, H + spread + 0.5, size=(40, 50))
    x[0, :5] = [0.0, W - 1.0, -1.0, W, 3.0]      # integral coordinates
    x, y = x.astype(np.float32), y.astype(np.float32)
    vj, mj = jinterp.bilinear(jnp.asarray(img), jnp.asarray(x), jnp.asarray(y))
    vt, mt = interp.bilinear(torch.as_tensor(img), torch.as_tensor(x),
                             torch.as_tensor(y))
    close(vj, vt)
    np.testing.assert_array_equal(np.asarray(mj), mt.numpy())
    close(jinterp.bilinear_fill(jnp.asarray(img), jnp.asarray(x),
                                jnp.asarray(y)),
          interp.bilinear_fill(torch.as_tensor(img), torch.as_tensor(x),
                               torch.as_tensor(y)))


def test_bilinear_far_out_of_range_and_nan_are_out_of_bounds():
    img = torch.as_tensor(image(4))
    x = torch.tensor([1e12, -1e12, float("nan"), 3.25])
    y = torch.tensor([2.0, 2.0, 2.0, 2.5])
    v, m = interp.bilinear(img, x, y)
    assert m.tolist() == [False, False, False, True]
    assert v[:2].tolist() == [0.0, 0.0]
