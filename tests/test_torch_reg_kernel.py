"""K3, the depth-map regularization kernel of the PyTorch port.

On the CPU the port's wrappers run the plain PyTorch version; it is held
against the JAX package's XLA path (``propagate.do_regularization``) and
against its Pallas kernel in interpret mode, at 48x64, for both
``remove_occlusions`` values and both hole-fill modes.  Discrete fields
(valid, blacklisted) must be equal; float fields agree to rtol 2e-6 /
atol 1e-6 (the tolerance the JAX package's own Pallas-vs-XLA test uses:
XLA may contract a multiply-add into an FMA where PyTorch rounds twice).
The CUDA kernel against the plain version runs only where there is a
card; on such a machine (which need not have jax) run them with
``python -m pytest tests/test_torch_reg_kernel.py -m cuda --noconftest``.
That is why this file imports the JAX package in a fixture and not at the
top.
"""

import types

import numpy as np
import pytest
import torch

from egomotion_with_local_loop_closures_tpu_torch.config import ELLCConfig
from egomotion_with_local_loop_closures_tpu_torch.depth import propagate
from egomotion_with_local_loop_closures_tpu_torch.depth.state import (
    FIELDS, DepthMapState)
from egomotion_with_local_loop_closures_tpu_torch.ops import reg_kernel

torch.set_num_threads(1)

SHAPE = (48, 64)
KW = dict(rows=48, cols=64, fx=60.0, fy=60.0, cx=32.0, cy=24.0)


def random_planes(seed, shape=SHAPE):
    """A numpy-seeded hypothesis state with holes, outliers and varied
    validity, so that every gate of both passes sees both outcomes."""
    rng = np.random.default_rng(seed)
    H, W = shape
    f32 = np.float32
    mg = (12.0 * rng.uniform(size=shape)).astype(f32)
    interior = np.zeros(shape, bool)
    interior[1:H - 1, 1:W - 1] = True
    valid = interior & (mg > 1.0) & (rng.uniform(size=shape) > 0.3)
    idepth = (0.5 + rng.uniform(size=shape)).astype(f32)
    outlier = rng.uniform(size=shape) < 0.1
    idepth = np.where(outlier, 3.0 * idepth, idepth).astype(f32)
    var = (0.002 + 0.05 * rng.uniform(size=shape)).astype(f32)
    planes = dict(
        idepth=np.where(valid, idepth, 0.0).astype(f32),
        var=np.where(valid, var, 0.0).astype(f32),
        idepth_smoothed=np.where(valid, idepth, -1.0).astype(f32),
        var_smoothed=np.where(valid, var, -1.0).astype(f32),
        validity=np.where(valid, rng.uniform(0.0, 60.0, size=shape),
                          0.0).astype(f32),
        blacklisted=rng.integers(-3, 2, size=shape).astype(np.int32),
        valid=valid)
    return planes, mg


@pytest.fixture(scope="module")
def jx():
    """The JAX package's side of the comparisons."""
    import jax.numpy as jnp
    from egomotion_with_local_loop_closures_tpu.config import ELLCConfig
    from egomotion_with_local_loop_closures_tpu.depth import propagate, state
    from egomotion_with_local_loop_closures_tpu.ops import reg_kernel as rk
    return types.SimpleNamespace(
        jnp=jnp, Cfg=ELLCConfig, prop=propagate, reg=rk,
        state=lambda planes: state.DepthMapState(
            **{k: jnp.asarray(v) for k, v in planes.items()}))


def to_torch(planes, device="cpu"):
    return DepthMapState(**{k: torch.as_tensor(v, device=device)
                            for k, v in planes.items()})


def assert_states_match(ref, got):
    """``ref``, ``got``: dicts of numpy arrays keyed by field name."""
    for name in FIELDS:
        a, b = np.asarray(ref[name]), np.asarray(got[name])
        if a.dtype in (np.bool_, np.int32):
            np.testing.assert_array_equal(a, b, err_msg=f"field {name}")
        else:
            np.testing.assert_allclose(a, b, rtol=2e-6, atol=1e-6,
                                       err_msg=f"field {name}")


def jax_fields(st):
    return {k: np.asarray(v) for k, v in st._asdict().items()}


def torch_fields(st):
    return {k: getattr(st, k).cpu().numpy() for k in FIELDS}


@pytest.mark.parametrize("lsd", [False, True])
@pytest.mark.parametrize("occl", [False, True])
def test_plain_matches_jax_xla_and_pallas(jx, occl, lsd):
    planes, mg = random_planes(seed=3 + 2 * occl + lsd)
    jcfg = jx.Cfg(lsd_correct_hole_fill=lsd, **KW)
    cfg = ELLCConfig(lsd_correct_hole_fill=lsd, **KW)
    ref = jax_fields(jx.prop.do_regularization(
        jx.state(planes), jx.jnp.asarray(mg), jcfg, remove_occlusions=occl))
    pallas = jax_fields(jx.reg.do_regularization_pallas(
        jx.state(planes), jx.jnp.asarray(mg), jcfg, remove_occlusions=occl,
        interpret=True))
    got = torch_fields(reg_kernel.do_regularization(
        to_torch(planes), torch.as_tensor(mg), cfg, remove_occlusions=occl))
    assert_states_match(ref, got)
    assert_states_match(pallas, got)
    # both passes had work to do
    assert (got["valid"] & ~planes["valid"]).any()        # holes filled
    assert (planes["valid"] & ~got["valid"]).any()        # pixels dropped


@pytest.mark.parametrize("occl", [False, True])
def test_regularize_alone_matches_jax(jx, occl):
    planes, _ = random_planes(seed=11)
    ref = jax_fields(jx.prop.regularize(jx.state(planes), jx.Cfg(**KW),
                                        remove_occlusions=occl))
    got = torch_fields(reg_kernel.regularize(
        to_torch(planes), ELLCConfig(**KW), remove_occlusions=occl))
    assert_states_match(ref, got)


def test_fill_holes_matches_jax(jx):
    planes, mg = random_planes(seed=5)
    ref = jax_fields(jx.prop.fill_holes(jx.state(planes), jx.jnp.asarray(mg),
                                        jx.Cfg(**KW)))
    got = torch_fields(propagate.fill_holes(to_torch(planes),
                                            torch.as_tensor(mg),
                                            ELLCConfig(**KW)))
    assert_states_match(ref, got)


def test_wrapper_refuses_other_devices():
    planes, mg = random_planes(seed=1)
    st = to_torch(planes, device="meta")
    with pytest.raises(ValueError):
        reg_kernel.do_regularization(st, torch.empty(SHAPE, device="meta"),
                                     ELLCConfig(**KW))
    with pytest.raises(ValueError):
        reg_kernel.regularize(st, ELLCConfig(**KW))


def test_cpu_path_counts_no_launch():
    planes, mg = random_planes(seed=2)
    reg_kernel.reset_launches()
    reg_kernel.do_regularization(to_torch(planes), torch.as_tensor(mg),
                                 ELLCConfig(**KW))
    reg_kernel.regularize(to_torch(planes), ELLCConfig(**KW))
    assert reg_kernel.launches == {"do_regularization": 0, "regularize": 0}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc (the K3 kernel runs only "
                    "on the GPU)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(48, 64), (270, 480)])
@pytest.mark.parametrize("lsd", [False, True])
@pytest.mark.parametrize("occl", [False, True])
def test_cuda_kernel_matches_plain(cuda_device, shape, occl, lsd):
    planes, mg = random_planes(seed=7, shape=shape)
    H, W = shape
    cfg = ELLCConfig(rows=H, cols=W, lsd_correct_hole_fill=lsd)
    st = to_torch(planes, cuda_device)
    mgt = torch.as_tensor(mg, device=cuda_device)
    reg_kernel.reset_launches()
    got = reg_kernel.do_regularization(st, mgt, cfg, remove_occlusions=occl)
    got_r = reg_kernel.regularize(st, cfg, remove_occlusions=occl)
    torch.cuda.synchronize()
    assert reg_kernel.launches == {"do_regularization": 1, "regularize": 1}
    ref = propagate.do_regularization(st, mgt, cfg, remove_occlusions=occl)
    ref_r = propagate.regularize(st, cfg, remove_occlusions=occl)
    assert_states_match(torch_fields(ref), torch_fields(got))
    assert_states_match(torch_fields(ref_r), torch_fields(got_r))
