"""The port's loop closure (histograms, gates, the window closer and the
loop-closure branch of run_sequence) held against the JAX package at
TEST_CONFIG size, under the parity config, on an out-and-back trajectory
whose keyframe 16 revisits keyframe 1 (the scene of tests/test_loop.py).

Both closers run here on the same keyframe snapshots: the port's, packaged
as the JAX package's ``KeyframeSnapshot`` and converted back with
``convert.to_port``.  The JAX package's own run_sequence over the same
frames (its loop edges and the snapshots it pushed) is read from
tests/data/port_golden_lc_test.json (tools/make_port_golden.py --lc-test
writes it and the frames): compiling its programs takes about two minutes
on a CPU, more than this file may spend.

Tolerances: histograms bit for bit (integer counts); KL divergences to
1e-6; view and trigger angles to 1e-4 degrees; on the same keyframe
snapshots, the rematched edge poses to 1e-4 per twist component (32
constant-weight iterations over four levels, float32 reductions in
another order).  The two run_sequence runs track independently, so only
their edge pairs must agree (their poses drift apart by float rounding,
see tests/test_torch_pipeline.py).
"""

import base64
import hashlib
import json
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from egomotion_with_local_loop_closures_tpu.config import TEST_CONFIG as JT
from egomotion_with_local_loop_closures_tpu.loop import closure as jclosure
from egomotion_with_local_loop_closures_tpu.loop import histogram as jhist
from egomotion_with_local_loop_closures_tpu.runtime import pipeline as jpipe
from egomotion_with_local_loop_closures_tpu.track import alignment as jalign

from egomotion_with_local_loop_closures_tpu_torch import convert
from egomotion_with_local_loop_closures_tpu_torch.config import (
    PARITY_OVERRIDES, TEST_CONFIG)
from egomotion_with_local_loop_closures_tpu_torch.loop import (closure,
                                                               histogram)
from egomotion_with_local_loop_closures_tpu_torch.runtime import (
    io as ellc_io, runner)

torch.set_num_threads(1)

KW = dict(PARITY_OVERRIDES, do_loop_closure=True)
JCFG, CFG = JT.replace(**KW), TEST_CONFIG.replace(**KW)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_FRAMES = 25


def sha256(a) -> str:
    return hashlib.sha256(np.ascontiguousarray(a, np.float32).tobytes()
                          ).hexdigest()


def recording(cls, pushes, snapshot):
    """``cls.push_keyframe`` that also records (frame_id, snapshot(its
    other arguments))."""
    orig = cls.push_keyframe

    def push(self, frame_id, *args, **kw):
        pushes.append((frame_id, snapshot(*args, **kw)))
        return orig(self, frame_id, *args, **kw)
    return push


@pytest.fixture(scope="module")
def golden():
    with open(os.path.join(ROOT, "tests", "data",
                           "port_golden_lc_test.json")) as f:
        golden = json.load(f)
    frames = np.load(os.path.join(ROOT, golden["frames_file"]))[
        "frames"].astype(np.float32)
    assert sha256(frames) == golden["frames_sha256"]
    run = golden["run_sequence"]
    assert run["config_overrides"] == KW
    assert run["num_input_frames"] == N_FRAMES
    return list(frames[:N_FRAMES]), run


@pytest.fixture(scope="module")
def frames(golden):
    """Integer-valued frames of a camera that translates away for 8
    frames, back for 8, then stays at the start."""
    return golden[0]


@pytest.fixture(scope="module")
def port_run(frames, tmp_path_factory):
    """The port's runner with loop closure, recording every keyframe
    snapshot it pushes to its window."""
    pushes = []
    out = tmp_path_factory.mktemp("run_sequence")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(closure.LoopCloser, "push_keyframe", recording(
            closure.LoopCloser, pushes, lambda *a, depth_state, match: a))
        res = runner.run_sequence(iter(frames), CFG, "cpu",
                                  out_dir=str(out))
    return res, pushes, out


def jax_snapshots(pushes):
    """The port's pushed keyframes as the JAX package's snapshots."""
    def j(t):
        return jnp.asarray(np.asarray(t))
    return [(fid, jpipe.KeyframeSnapshot(
        j(image), tuple(jalign.KeyframeLevel(*map(j, lv)) for lv in levels),
        tuple(map(j, weights)), j(world), j(rescale), j(seeds), None))
        for fid, (image, levels, weights, world, rescale, seeds) in pushes]


def edge_pairs(edges):
    return [(int(e.frame_id), int(e.matched_kf_id)) for e in edges]


@pytest.mark.parametrize("kind", ["uniform", "rendered"])
def test_histogram_is_bit_equal_to_jax(frames, kind):
    rng = np.random.default_rng(0)
    img = (rng.uniform(-3.0, 259.0, size=(96, 128)).astype(np.float32)
           if kind == "uniform" else frames[5])
    hj = np.asarray(jhist.image_histogram(jnp.asarray(img)))
    ht = histogram.image_histogram(torch.as_tensor(img)).numpy()
    np.testing.assert_array_equal(hj, ht)


def test_kl_divergence_matches_jax():
    rng = np.random.default_rng(1)
    ps = rng.uniform(size=(6, 256)).astype(np.float32)
    ps[:, rng.uniform(size=256) < 0.3] = 0.0          # p == 0 bins skipped
    ps /= ps.sum(axis=1, keepdims=True)
    q = rng.uniform(size=256).astype(np.float32)
    q[rng.uniform(size=256) < 0.2] = 0.0               # q clamped to 1e-10
    q /= q.sum()
    kj = np.asarray(jhist.kl_divergence_batched(jnp.asarray(ps),
                                                jnp.asarray(q)))
    kt = histogram.kl_divergence_batched(torch.as_tensor(ps),
                                         torch.as_tensor(q)).numpy()
    np.testing.assert_allclose(kj, kt, rtol=1e-6, atol=1e-6)
    assert float(histogram.kl_divergence(torch.as_tensor(q),
                                         torch.as_tensor(q))) == 0.0


def test_view_and_trigger_angles_match_jax():
    rng = np.random.default_rng(2)
    a = (rng.normal(size=(32, 6)) * [0.3, 0.3, 0.3, 1, 1, 1]).astype(
        np.float32)
    # view angles of 5-60 degrees: near 0 arccos turns one ulp of the
    # cosine into ~2e-4 degrees at 1 degree, in either package
    b = (a + rng.normal(size=(32, 6)) * 0.3).astype(np.float32)
    np.testing.assert_allclose(
        np.asarray(jclosure.view_angle_deg(jnp.asarray(a), jnp.asarray(b))),
        closure.view_angle_deg(torch.as_tensor(a),
                               torch.as_tensor(b)).numpy(), atol=1e-4)
    want = [float(jclosure.trigger_angle_deg(jnp.asarray(p))) for p in a]
    np.testing.assert_allclose(
        want, closure.trigger_angle_deg(torch.as_tensor(a)).numpy(),
        atol=1e-4)
    # the reference's 180/3.14 degrees (GlobalOptimize.cpp:432)
    x = torch.tensor([0.2, 0.0, 0.0, 0.0, 0.0, 0.0])
    assert float(closure.view_angle_deg(torch.zeros(6), x)) == \
        pytest.approx(0.2 * 180.0 / 3.14, rel=1e-5)


def test_trigger_latch_matches_jax():
    """The on/off hysteresis of triggerRotation over a pose sequence whose
    trigger angle rises past the on level and falls below the off one."""
    cfg = CFG.replace(trigger_loop_closure_on=60.0,
                      trigger_loop_closure_off=30.0)
    poses = np.asarray([[0.0, 0.0, 0.0, 0.1 * s, 0.0, -1.0] for s in
                        (0, 5, 20, 40, 10, 2, 0)], np.float32)
    jc = jclosure.LoopCloser(JCFG.replace(trigger_loop_closure_on=60.0,
                                          trigger_loop_closure_off=30.0))
    pc = closure.LoopCloser(cfg)
    want = [jc.update_trigger(jnp.asarray(p)) for p in poses]
    got = [pc.update_trigger(torch.as_tensor(p)) for p in poses]
    assert got == want and True in got and got[-1] is False


def test_closer_on_converted_snapshots_matches_jax(port_run):
    """The same keyframe snapshots through both closers: the JAX
    package's gets them as its ``KeyframeSnapshot``, the port's after
    ``convert.to_port``; the same edges come out."""
    _, pushes, _ = port_run
    jc, pc = jclosure.LoopCloser(JCFG), closure.LoopCloser(CFG)
    for fid, snap in jax_snapshots(pushes):
        jc.push_keyframe(fid, snap.image, snap.kf_levels, snap.weight_levels,
                         snap.world_pose, jnp.zeros(6), float(snap.rescale),
                         float(snap.seeds))
        s = convert.to_port(convert.as_tree(snap), "cpu")
        pc.push_keyframe(fid, s.image, s.kf_levels, s.weight_levels,
                         s.world_pose, s.rescale, s.seeds)
    want = jc.edges
    assert edge_pairs(want) == [(16, 1)]
    assert edge_pairs(pc.edges) == edge_pairs(want)
    for e, w in zip(pc.edges, want):
        np.testing.assert_allclose(e.pose_wrt_matched,
                                   np.asarray(w.pose_wrt_matched), atol=1e-4)
        assert e.match_value == pytest.approx(w.match_value, abs=1e-6)
        assert e.view_angle == pytest.approx(w.view_angle, abs=1e-4)
        assert e.rms_error == pytest.approx(w.rms_error, abs=1e-6)
        assert (e.rescale, e.seeds) == pytest.approx((w.rescale, w.seeds),
                                                     rel=1e-6)
    assert [e.frame_id for e in pc.entries] == [fid for fid, _ in pushes]


def test_run_sequence_with_loop_closure_matches_jax(port_run, golden):
    """The port's runner against the JAX package's on the same frames:
    the same edge pairs, the edge file in the reference format, and
    keyframe snapshots close to the JAX package's."""
    res, pushes, out = port_run
    _, want = golden
    assert edge_pairs(res.extra["loop_edges"]) == [
        (e["frame_id"], e["matched_kf_id"]) for e in want["edges"]]
    rows = ellc_io.read_pose_file(
        os.path.join(out, "matchframes_globalopt.txt"))
    assert rows.shape == (1, 13) and rows[0, :2].tolist() == [16, 1]
    e = res.extra["loop_edges"][0]
    np.testing.assert_allclose(rows[0, 10:], [e.match_value, e.rms_error,
                                              e.view_angle], rtol=1e-6)
    assert [f for f, _ in pushes] == [p["frame_id"] for p in want["pushes"]] \
        == [1, 8, 16]
    for pj, (_, pt) in zip(want["pushes"], pushes):
        image, kf_levels, weights, world, rescale, seeds = pt
        assert sha256(image.numpy()) == pj["image_sha256"]
        np.testing.assert_allclose(pj["world_pose"], world.numpy(),
                                   atol=1e-3)
        assert float(seeds) == pytest.approx(pj["seeds"], abs=1.0)
        # the averaged weight images: same support, same total weight
        for bits, total, wt in zip(pj["weight_support"], pj["weight_sum"],
                                   weights):
            wt = wt.numpy()
            support = np.unpackbits(np.frombuffer(base64.b64decode(bits),
                                                  np.uint8),
                                    count=wt.size).astype(bool)
            assert np.mean(support != (wt.ravel() > 0)) < 0.03
            assert wt.sum() == pytest.approx(total, rel=0.03)


def test_window_evicts_oldest_first(port_run):
    """A window of one keeps only the newest keyframe, evicting keyframe
    1 before keyframe 16 could match it."""
    _, pushes, _ = port_run
    pc = closure.LoopCloser(CFG.replace(loop_window=1))
    for fid, snap in jax_snapshots(pushes):
        s = convert.to_port(convert.as_tree(snap), "cpu")
        pc.push_keyframe(fid, s.image, s.kf_levels, s.weight_levels,
                         s.world_pose, s.rescale, s.seeds)
        assert [e.frame_id for e in pc.entries] == [fid]
    assert pc.edges == []


def test_rms_rotation_error_matches_jax():
    """The reference's rms_error of two world twists, float32 and
    float64 poses."""
    rng = np.random.default_rng(8)
    for dtype in (np.float32, np.float64):
        a, b = rng.normal(size=(2, 6)).astype(dtype)
        assert closure.rms_rotation_error(a, b) == \
            jclosure.rms_rotation_error(a, b)
    assert closure.rms_rotation_error(a, a) == 0.0
