"""The port's depth state, pyramid fusion and keyframe propagation held
against the JAX package on the same numpy inputs.

Tolerances: the glibc bootstrap is bit-exact; elementwise state maps
agree to atol 1e-6; propagation's scatter sums agree to rtol 1e-5 (XLA's
scatter and the port's merge, which adds each cell's candidates in
ascending source index, need not add them in the same order), with the
discrete valid/blacklisted planes equal.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from egomotion_with_local_loop_closures_tpu.config import ELLCConfig as JCfg
from egomotion_with_local_loop_closures_tpu.depth import fusion as jfusion
from egomotion_with_local_loop_closures_tpu.depth import propagate as jprop
from egomotion_with_local_loop_closures_tpu.depth import state as jstate
from egomotion_with_local_loop_closures_tpu.utils import glibc_rand as jglibc

from egomotion_with_local_loop_closures_tpu_torch.config import ELLCConfig
from egomotion_with_local_loop_closures_tpu_torch.depth import (
    fusion, propagate, state as dstate)
from egomotion_with_local_loop_closures_tpu_torch.utils import glibc_rand

torch.set_num_threads(1)

KW = dict(rows=48, cols=64, fx=60.0, fy=60.0, cx=32.0, cy=24.0,
          bootstrap_rng="glibc")
JCFG, CFG = JCfg(**KW), ELLCConfig(**KW)


def maxgrad(seed, shape=(48, 64)):
    rng = np.random.default_rng(seed)
    return (12.0 * rng.uniform(size=shape)).astype(np.float32)


def fields_equal(jst, tst, atol=1e-6, rtol=0.0):
    for name, a in jst._asdict().items():
        a, b = np.asarray(a), getattr(tst, name).numpy()
        if a.dtype in (np.bool_, np.int32):
            np.testing.assert_array_equal(a, b, err_msg=name)
        else:
            np.testing.assert_allclose(a, b, atol=atol, rtol=rtol,
                                       err_msg=name)


def jax_init(mg):
    return jstate.initialize_random(jax.random.PRNGKey(0), jnp.asarray(mg),
                                    JCFG)


def test_glibc_copy_matches_original():
    np.testing.assert_array_equal(jglibc.glibc_unit_floats(5000),
                                  glibc_rand.glibc_unit_floats(5000))


def test_initialize_random_glibc_is_bit_exact():
    mg = maxgrad(0)
    fields_equal(jax_init(mg),
                 dstate.initialize_random(None, torch.as_tensor(mg), CFG),
                 atol=0.0)


def test_initialize_random_generator_path():
    mg = torch.as_tensor(maxgrad(1))
    cfg = CFG.replace(bootstrap_rng="jax")
    a = dstate.initialize_random(torch.Generator().manual_seed(3), mg, cfg)
    b = dstate.initialize_random(torch.Generator().manual_seed(3), mg, cfg)
    assert torch.equal(a.idepth, b.idepth)
    ids = a.idepth[a.valid]
    assert ids.numel() > 0 and ids.min() >= 0.5 and ids.max() <= 1.5


def test_state_helpers_match_jax():
    mg = maxgrad(2)
    jst = jax_init(mg)
    tst = dstate.initialize_random(None, torch.as_tensor(mg), CFG)
    js2, jd, jv = jstate.to_depth_image(jst, JCFG)
    ts2, td, tv = dstate.to_depth_image(tst, CFG)
    fields_equal(js2, ts2)
    np.testing.assert_allclose(np.asarray(jd), td.numpy(), rtol=1e-6)
    np.testing.assert_allclose(np.asarray(jv), tv.numpy(), rtol=1e-6)
    assert float(jstate.seeds_percent(jst)) == pytest.approx(
        float(dstate.seeds_percent(tst)), abs=1e-5)
    j1, jr = jstate.make_idepth_one(jst)
    t1, tr = dstate.make_idepth_one(tst)
    fields_equal(j1, t1, rtol=1e-6)
    assert float(jr) == pytest.approx(float(tr), rel=1e-6)
    dep = np.where(mg > 6.0, 1.0 / (0.5 + mg / 12.0), 0.0).astype(np.float32)
    var = np.full(mg.shape, 0.01, np.float32)
    fields_equal(jstate.from_depth(jnp.asarray(dep), jnp.asarray(var)),
                 dstate.from_depth(torch.as_tensor(dep), torch.as_tensor(var)))
    e = dstate.empty((4, 5))
    assert e.valid.dtype == torch.bool and float(e.var_smoothed[0, 0]) == -1


def test_fusion_pyramid_matches_jax():
    rng = np.random.default_rng(4)
    shape = (45, 67)
    valid = rng.uniform(size=shape) > 0.4
    d = np.where(valid, rng.uniform(0.5, 3.0, size=shape), 0.0
                 ).astype(np.float32)
    v = np.where(valid, rng.uniform(0.001, 0.1, size=shape), -1.0
                 ).astype(np.float32)
    dj, vj = jfusion.build_depth_var_pyramid(jnp.asarray(d), jnp.asarray(v),
                                             4)
    dt, vt = fusion.build_depth_var_pyramid(torch.as_tensor(d),
                                            torch.as_tensor(v), 4)
    for a, b in zip(dj + vj, dt + vt):
        np.testing.assert_allclose(np.asarray(a), b.numpy(), rtol=2e-6,
                                   atol=1e-7)


@pytest.mark.parametrize("seed", [0, 1])
def test_propagate_matches_jax(seed):
    """Reproject a regularized random state into a moved keyframe; the
    images are integer-valued like decoded video."""
    rng = np.random.default_rng(10 + seed)
    mg = maxgrad(5 + seed)
    old = np.round(255 * rng.uniform(size=mg.shape)).astype(np.float32)
    new = np.round(255 * rng.uniform(size=mg.shape)).astype(np.float32)
    new_mg = (5.0 + 10.0 * rng.uniform(size=mg.shape)).astype(np.float32)
    pose = (rng.normal(size=6) * [0.01, 0.01, 0.01, 0.05, 0.05, 0.05]
            ).astype(np.float32)
    jst = jprop.regularize(jax_init(mg), JCFG)
    tst = propagate.regularize(
        dstate.initialize_random(None, torch.as_tensor(mg), CFG), CFG)
    # loose photometric gate so that many candidates reach the merge
    jcfg = JCFG.replace(max_diff_constant=1e6)
    cfg = CFG.replace(max_diff_constant=1e6)
    ref = jprop.propagate(jst, jnp.asarray(old), jnp.asarray(new),
                          jnp.asarray(new_mg), jnp.asarray(pose), jcfg)
    got = propagate.propagate(tst, torch.as_tensor(old), torch.as_tensor(new),
                              torch.as_tensor(new_mg), torch.as_tensor(pose),
                              cfg)
    fields_equal(ref, got, atol=1e-6, rtol=1e-5)
    assert 0.2 < float(got.valid.float().mean()) < 1.0
