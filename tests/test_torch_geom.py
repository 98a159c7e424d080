"""The port's geom modules (Lie ops, camera, SPD solve) and its config,
held against the JAX package on the same numpy inputs.

Tolerances: float32 closed forms agree to atol 2e-6 (the two frameworks
round the same formulas; trig functions and matrix products may differ by
an ulp).  The 6x6 solve is a different algorithm (LAPACK's Cholesky
against the JAX package's unrolled one) and agrees to rtol 1e-4 on a
well-conditioned system.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from egomotion_with_local_loop_closures_tpu import config as jconfig
from egomotion_with_local_loop_closures_tpu.geom import camera as jcamera
from egomotion_with_local_loop_closures_tpu.geom import lie as jlie
from egomotion_with_local_loop_closures_tpu.geom import linear as jlinear

from egomotion_with_local_loop_closures_tpu_torch import config
from egomotion_with_local_loop_closures_tpu_torch.geom import (camera, lie,
                                                              linear)

torch.set_num_threads(1)

ATOL = 2e-6


def twists(seed, n=64):
    """Random twists over small and ordinary angles, float32."""
    rng = np.random.default_rng(seed)
    scale = np.where(rng.uniform(size=(n, 1)) < 0.5, 1e-3, 0.5)
    return (rng.normal(size=(n, 6)) * scale).astype(np.float32)


def close(jax_out, torch_out, atol=ATOL, rtol=0.0):
    np.testing.assert_allclose(np.asarray(jax_out), torch_out.numpy(),
                               atol=atol, rtol=rtol)


def test_config_copy_matches_jax_config():
    def spec(cls):
        return [(f.name, f.default) for f in dataclasses.fields(cls)]
    assert spec(config.ELLCConfig) == spec(jconfig.ELLCConfig)
    assert (dataclasses.asdict(config.TEST_CONFIG)
            == dataclasses.asdict(jconfig.TEST_CONFIG))
    assert (config.TEST_CONFIG.level_intrinsics(2)
            == jconfig.TEST_CONFIG.level_intrinsics(2))


@pytest.mark.parametrize("name", ["exp_so3", "exp_se3"])
def test_exp_matches_jax(name):
    xi = twists(1)
    arg = xi[:, :3] if name == "exp_so3" else xi
    close(getattr(jlie, name)(jnp.asarray(arg)),
          getattr(lie, name)(torch.as_tensor(arg)))


def test_log_so3_and_log_se3_match_jax():
    T = np.array(jlie.exp_se3(jnp.asarray(twists(2))))
    close(jlie.log_se3(jnp.asarray(T)), lie.log_se3(torch.as_tensor(T)),
          atol=2e-5)
    close(jlie.log_so3(jnp.asarray(T[:, :3, :3])),
          lie.log_so3(torch.as_tensor(T[:, :3, :3])), atol=2e-5)


@pytest.mark.parametrize("name", ["compose", "relative"])
def test_compose_and_relative_match_jax(name):
    a, b = twists(3), twists(4)
    close(getattr(jlie, name)(jnp.asarray(a), jnp.asarray(b)),
          getattr(lie, name)(torch.as_tensor(a), torch.as_tensor(b)),
          atol=2e-5)


@pytest.mark.parametrize("a_shape,b_shape", [
    ((3, 3), (3, 3)), ((8, 3, 3), (8, 3, 3)), ((3, 3), (8, 3, 3)),
    ((8, 3, 3), (8, 3, 1)), ((4, 4), (4, 4)), ((8, 4, 4), (8, 4, 4))])
def test_mm_equals_bmm_bit_for_bit_on_cpu(a_shape, b_shape):
    """``lie.mm`` sums entry by entry (the kernels' order); on the CPU
    that is also ``torch.bmm``'s, so moving off it changed no CPU bit."""
    rng = np.random.default_rng(7)
    a = torch.tensor(rng.normal(size=a_shape).astype(np.float32))
    b = torch.tensor(rng.normal(size=b_shape).astype(np.float32))
    lead = torch.broadcast_shapes(a.shape[:-2], b.shape[:-2])

    def stack(m):
        return m.expand(lead + m.shape[-2:]).reshape((-1,) + m.shape[-2:])
    want = torch.bmm(stack(a), stack(b))
    assert torch.equal(lie.mm(a, b), want.reshape(lead + want.shape[-2:]))


def test_inverse_is_negation_and_round_trips():
    xi = torch.as_tensor(twists(5))
    assert torch.equal(lie.inverse(xi), -xi)
    close(np.zeros((64, 6)), lie.compose(lie.inverse(xi), xi), atol=2e-5)


def test_camera_matches_jax():
    rng = np.random.default_rng(6)
    x = rng.uniform(0, 128, size=(96, 128)).astype(np.float32)
    y = rng.uniform(0, 96, size=(96, 128)).astype(np.float32)
    d = rng.uniform(0.5, 3.0, size=(96, 128)).astype(np.float32)
    intr = (120.0, 121.0, 64.0, 48.0)
    P_j = jcamera.backproject(jnp.asarray(x), jnp.asarray(y),
                              jnp.asarray(d), *intr)
    P_t = camera.backproject(torch.as_tensor(x), torch.as_tensor(y),
                             torch.as_tensor(d), *intr)
    close(P_j, P_t)
    P = np.array(P_j)
    P[0, :3, 2] = [0.0, -1e-12, 1e-12]          # the UNZERO guard
    for a, b in zip(jcamera.project(jnp.asarray(P), *intr),
                    camera.project(torch.as_tensor(P), *intr)):
        close(a, b, rtol=1e-6)
    for a, b in zip(jcamera.pixel_grid(5, 7), camera.pixel_grid(5, 7)):
        close(a, b, atol=0)
    close(jcamera.intrinsics_matrix(*intr), camera.intrinsics_matrix(*intr),
          atol=0)


def test_solve_spd_matches_jax_and_flags_indefinite():
    rng = np.random.default_rng(7)
    M = rng.normal(size=(8, 6, 6)).astype(np.float32)
    A = (M @ M.transpose(0, 2, 1) + 6 * np.eye(6)).astype(np.float32)
    b = rng.normal(size=(8, 6)).astype(np.float32)
    close(jlinear.solve_spd(jnp.asarray(A), jnp.asarray(b)),
          linear.solve_spd(torch.as_tensor(A), torch.as_tensor(b)),
          atol=1e-5, rtol=1e-4)
    # not positive definite: NaN, like the unrolled JAX Cholesky
    bad = A.copy()
    bad[0] = -np.eye(6)
    bad[1] = 0.0
    x = linear.solve_spd(torch.as_tensor(bad), torch.as_tensor(b)).numpy()
    xj = np.asarray(jlinear.solve_spd(jnp.asarray(bad), jnp.asarray(b)))
    assert np.isnan(x[:2]).all() and not np.isfinite(xj[:2]).any()
    assert np.isfinite(x[2:]).all()


def quats(seed, n=64):
    """Random unit quaternions, scalar first, either sign."""
    q = np.random.default_rng(seed).normal(size=(n, 4)).astype(np.float32)
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


@pytest.mark.parametrize("name", ["quat_mul", "quat_conj", "exp_quat",
                                  "matrix_from_quat", "vee_so3",
                                  "view_vector", "rotation_angle_deg"])
def test_quaternion_and_rotation_helpers_match_jax(name):
    """The Lie helpers of loop closure and rotation averaging, at 1e-6
    (rotation_angle_deg in degrees at 1e-4: an arccos-free log of a
    near-identity product, scaled by 57)."""
    a, b, xi = quats(8), quats(9), twists(10)
    R1 = np.array(jlie.exp_so3(jnp.asarray(xi[:, :3])))
    R2 = np.array(jlie.exp_so3(jnp.asarray(twists(11)[:, 3:])))
    args = {"quat_mul": (a, b), "quat_conj": (a,), "exp_quat": (xi[:, :3],),
            "matrix_from_quat": (a,), "vee_so3": (R1 - R1.transpose(0, 2, 1),),
            "view_vector": (xi,), "rotation_angle_deg": (R1, R2)}[name]
    close(getattr(jlie, name)(*map(jnp.asarray, args)),
          getattr(lie, name)(*map(torch.as_tensor, args)),
          atol=1e-4 if name == "rotation_angle_deg" else 1e-6)


def test_vee_inverts_hat():
    w = torch.as_tensor(twists(12)[:, :3])
    assert torch.equal(lie.vee_so3(lie.hat_so3(w)), w)


def test_undistortion_matches_jax():
    """The distortion model, the remap and the undistorted image on a
    seeded image with the configuration's distortion (cv::undistort,
    Frame.cpp:86-96).  The image agrees to 2e-4 grey levels: bilinear
    weights of two libraries on values up to 255."""
    rng = np.random.default_rng(5)
    cfg = config.ELLCConfig(rows=96, cols=128, fx=110.0, fy=110.0, cx=64.0,
                            cy=48.0)
    intr = (cfg.fx, cfg.fy, cfg.cx, cfg.cy)
    xn, yn = (rng.uniform(-0.7, 0.7, size=(2, 50)).astype(np.float32))
    for a, b in zip(jcamera.distort_normalized(jnp.asarray(xn),
                                               jnp.asarray(yn),
                                               cfg.distortion),
                    camera.distort_normalized(torch.as_tensor(xn),
                                              torch.as_tensor(yn),
                                              cfg.distortion)):
        close(a, b)
    for a, b in zip(jcamera.undistort_map(96, 128, *intr, cfg.distortion),
                    camera.undistort_map(96, 128, *intr, cfg.distortion)):
        close(a, b, atol=1e-4)
    img = rng.uniform(0.0, 255.0, size=(96, 128)).astype(np.float32)
    want = np.asarray(jcamera.undistort_image(jnp.asarray(img), *intr,
                                              cfg.distortion))
    got = camera.undistort_image(torch.as_tensor(img), *intr, cfg.distortion)
    close(want, got, atol=2e-4)
    assert not np.allclose(want, img)


@pytest.mark.parametrize("undistort", [False, True])
def test_runner_undistort_source_matches_jax(undistort):
    """``runtime/runner.py::undistort_source``, the runners' frame
    source: the frames as float32 tensors, untouched when the config
    does not ask for undistortion; else each within
    test_undistortion_matches_jax's 2e-4 grey levels of the JAX package's
    undistort_image, and within 4e-3 of the JAX package's source, which
    jit-compiles it (XLA's jit of the remap parts from the same function
    run eagerly by 2.4e-3 on these frames)."""
    from egomotion_with_local_loop_closures_tpu.runtime import (
        runner as jrunner)
    from egomotion_with_local_loop_closures_tpu_torch.runtime import runner
    rng = np.random.default_rng(6)
    frames = [rng.uniform(0.0, 255.0, size=(96, 128)).astype(np.float32)
              for _ in range(3)]
    kw = dict(rows=96, cols=128, fx=110.0, fy=110.0, cx=64.0, cy=48.0,
              do_undistortion=undistort)
    jcfg = jconfig.ELLCConfig(**kw)
    want = list(jrunner.undistort_source(iter(frames), jcfg))
    got = list(runner.undistort_source(iter(frames),
                                       config.ELLCConfig(**kw), "cpu"))
    assert len(got) == len(want) == 3
    for f, a, b in zip(frames, want, got):
        assert b.dtype == torch.float32 and b.device.type == "cpu"
        if not undistort:
            close(a, b, atol=0.0)
            close(f, b, atol=0.0)
            continue
        close(a, b, atol=4e-3)
        close(jcamera.undistort_image(jnp.asarray(f), jcfg.fx, jcfg.fy,
                                      jcfg.cx, jcfg.cy, jcfg.distortion),
              b, atol=2e-4)
        assert not np.allclose(f, b.numpy())
