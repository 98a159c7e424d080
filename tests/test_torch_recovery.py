"""The port's connection recovery (loop/recovery.py and run_sequence with
``restore_connection``) held against the JAX package at 96x128 under the
parity config, on a sideways-translating camera (the scene of
tests/test_recovery.py) whose frames 24 and 25 are a flat gray image:
keyframe 24 is built on the flat frame with no seeds, frame 25 cannot be
re-localized and is dropped, and frame 26 is recovered against keyframe
16.

The JAX package's run over these frames, every recovery attempt, and the
three keyframe snapshots in its window at the recovery (with their depth
states) come from tests/data/port_golden_recovery_test.json and
tests/data/port_recovery_test.npz (tools/make_port_golden.py
--recovery-test, about two minutes of JAX compiles on a CPU).  The JAX
window is handed to the port through ``convert.to_port``.

Tolerances: on the JAX window, the recovered pose within 1e-4 per twist
component (32 constant-weight iterations over four levels, float32 sums
in another order) and seeds% within 0.1 points (that pose decides which
pixel each hypothesis lands on); measured on a CPU at one thread,
2.9e-6 and 4e-6.  The two whole runs track independently and drift
apart by float rounding (tests/test_torch_pipeline.py), so there the
events must be the same, the poses within 1e-3 and seeds% within 0.5
points (measured 6.1e-5 and 0.008).  A batch of candidates must give
each what it gives alone, bit for bit, and a run resumed from a
checkpoint before the flat frames must give what an uninterrupted run
gives, bit for bit.
"""

import hashlib
import json
import os

import numpy as np
import pytest
import torch

from egomotion_with_local_loop_closures_tpu_torch import convert
from egomotion_with_local_loop_closures_tpu_torch.config import ELLCConfig
from egomotion_with_local_loop_closures_tpu_torch.depth import propagate
from egomotion_with_local_loop_closures_tpu_torch.depth import state as dstate
from egomotion_with_local_loop_closures_tpu_torch.depth.state import FIELDS
from egomotion_with_local_loop_closures_tpu_torch.image import pyramid
from egomotion_with_local_loop_closures_tpu_torch.loop import (closure,
                                                               recovery)
from egomotion_with_local_loop_closures_tpu_torch.ops import reg_kernel
from egomotion_with_local_loop_closures_tpu_torch.runtime import (
    checkpoint, io as ellc_io, runner)

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, "tests", "data")
RECOVERED, DROPPED = 26, 25


@pytest.fixture(scope="module")
def golden():
    with open(os.path.join(DATA, "port_golden_recovery_test.json")) as f:
        golden = json.load(f)
    with np.load(os.path.join(ROOT, golden["arrays_file"])) as z:
        arrays = {k: z[k] for k in z.files}
    frames = arrays.pop("frames").astype(np.float32)
    assert hashlib.sha256(frames.tobytes()).hexdigest() \
        == golden["frames_sha256"]
    cfg = ELLCConfig().replace(**golden["config_overrides"])
    return golden, cfg, list(frames), arrays


def unflatten(arrays, prefix):
    """The ``prefix``-ed entries of a flat {"a.b.0": array} dict as nested
    dicts and lists (the shape convert.as_tree gives)."""
    tree = {}
    for key, v in arrays.items():
        if not key.startswith(prefix):
            continue
        node, parts = tree, key[len(prefix):].split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v

    def lists(node):
        if not isinstance(node, dict):
            return node
        if all(k.isdigit() for k in node):
            return [lists(node[str(i)]) for i in range(len(node))]
        return {k: lists(v) for k, v in node.items()}
    return lists(tree)


@pytest.fixture(scope="module")
def window(golden):
    """A port closer holding the JAX package's window at the recovery."""
    g, cfg, _, arrays = golden
    closer = closure.LoopCloser(cfg)
    for k in range(len(g["window_frame_ids"])):
        tree = unflatten(arrays, f"push{k}.")
        snap = convert.to_port(tree, "cpu")
        closer.push_keyframe(int(tree["frame_id"]), snap.image,
                             snap.kf_levels, snap.weight_levels,
                             snap.world_pose, snap.rescale, snap.seeds,
                             depth_state=snap.depth_state, match=False)
    assert [e.frame_id for e in closer.entries] == g["window_frame_ids"] \
        == [1, 8, 16]
    assert closer.edges == []
    return closer


def attempt(g, frame_id):
    return next(a for a in g["attempts"] if a["frame_id"] == frame_id)


def test_check_connection_threshold(golden):
    _, cfg, _, _ = golden
    assert recovery.check_connection(0.0, cfg)
    assert not recovery.check_connection(0.01, cfg)


def test_find_connection_on_the_jax_window_matches_jax(golden, window):
    """The stray frames against the JAX package's window: the flat frame
    finds no candidate, the next frame the same keyframe, pose and seeds
    as the JAX package's find_connection."""
    g, cfg, frames, _ = golden
    assert recovery.find_connection(window, DROPPED,
                                    torch.as_tensor(frames[DROPPED - 1]),
                                    cfg) is None
    assert attempt(g, DROPPED)["matched_kf_id"] is None
    want = attempt(g, RECOVERED)
    assert want["candidates"] == [16, 8, 1]
    rec = recovery.find_connection(window, RECOVERED,
                                   torch.as_tensor(frames[RECOVERED - 1]),
                                   cfg)
    assert rec.matched_kf_id == want["matched_kf_id"] == 16
    np.testing.assert_allclose(rec.pose_wrt_matched.numpy(),
                               want["pose_wrt_matched"], atol=1e-4, rtol=0)
    np.testing.assert_allclose(rec.world_pose.numpy(), want["world_pose"],
                               atol=1e-4, rtol=0)
    assert rec.seeds == pytest.approx(want["seeds"], abs=0.1)
    assert float(rec.rescale) == pytest.approx(want["rescale"], rel=1e-2)
    assert float(dstate.seeds_percent(rec.depth_state)) == rec.seeds


def test_find_connection_respects_the_id_gap(golden, window, monkeypatch):
    """Every window keyframe within min_match_difference of the frame:
    no trial runs at all."""
    _, cfg, frames, _ = golden
    monkeypatch.setattr(recovery, "_batched_trials", None)
    assert recovery.find_connection(window, 1 + cfg.min_match_difference,
                                    torch.as_tensor(frames[0]), cfg) is None


def test_batch_equals_each_candidate_alone(golden, window):
    """propagate and both K3 wrappers over the three candidates at once
    equal them run candidate by candidate, bit for bit (the trials'
    steps after the aligner, at distinct poses)."""
    _, cfg, frames, _ = golden
    image = torch.as_tensor(frames[RECOVERED - 1])
    gx, gy = pyramid.gradients(image)
    mg = pyramid.max_abs_gradient(gx, gy)
    ents = window.entries[::-1]
    poses = torch.as_tensor(np.random.default_rng(0).normal(
        scale=[0.01] * 3 + [0.05] * 3, size=(3, 6)).astype(np.float32))

    def trial(st, kf_image, pose):
        st = propagate.propagate(st, kf_image, image, mg, pose, cfg)
        st = reg_kernel.regularize(st, cfg, remove_occlusions=True)
        return dstate.make_idepth_one(reg_kernel.do_regularization(
            st, mg.expand(st.idepth.shape).contiguous(), cfg))

    batch = dstate.DepthMapState(**{
        n: torch.stack([getattr(e.depth_state, n) for e in ents])
        for n in FIELDS})
    got, rescales = trial(batch, torch.stack([e.kf_levels[0].image
                                              for e in ents]), poses)
    assert rescales.shape == (3,)
    for b, e in enumerate(ents):
        ref, rescale = trial(e.depth_state, e.kf_levels[0].image, poses[b])
        assert torch.equal(rescales[b], rescale)
        for n in FIELDS:
            torch.testing.assert_close(getattr(got, n)[b], getattr(ref, n),
                                       rtol=0, atol=0, equal_nan=True)
    assert float(dstate.seeds_percent(got).min()) > 0.0


@pytest.fixture(scope="module")
def port_run(golden, tmp_path_factory):
    """The port's runner over the 34 frames, counting the K3 wrappers'
    calls; returns (result, calls, output directory)."""
    _, cfg, frames, _ = golden
    out = tmp_path_factory.mktemp("recovery_run")
    calls = {"do_regularization": 0, "regularize": 0}
    with pytest.MonkeyPatch.context() as mp:
        for name in calls:
            def counted(*a, _f=getattr(reg_kernel, name), _n=name, **kw):
                calls[_n] += 1
                return _f(*a, **kw)
            mp.setattr(reg_kernel, name, counted)
        res = runner.run_sequence(iter(frames), cfg, "cpu", out_dir=str(out))
    return res, calls, out


def test_run_sequence_with_recovery_matches_jax(golden, port_run):
    """The port's runner over the 34 frames: the same drop and recovery
    as the JAX package's, the same frame ids, no pose line for the
    dropped frame, and K3 called as a hand count of the schedule says:
    init 1 regularize; keyframe steps at 8, 16, 24, 32 (2 + 1 each); 27
    track_refine steps; one trial batch at frames 25 and 26 (1 + 1
    each): 27 + 8 + 2 = 37 and 1 + 4 + 2 = 7."""
    g, cfg, frames, _ = golden
    res, calls, tmp_path = port_run
    assert calls == {"do_regularization": 37, "regularize": 7}
    assert res.extra["dropped_frames"] == g["dropped_frames"] == [DROPPED]
    recs = res.extra["recoveries"]
    assert [(r["frame_id"], r["matched_kf_id"]) for r in recs] == [
        (r["frame_id"], r["matched_kf_id"]) for r in g["recoveries"]] == [
        (RECOVERED, 16)]
    assert res.frame_ids.tolist() == g["frame_ids"]
    assert res.kf_ids.tolist() == g["kf_ids"]
    assert float(res.seeds[res.frame_ids == 24][0]) == 0.0
    np.testing.assert_allclose(recs[0]["pose_wrt_matched"],
                               attempt(g, RECOVERED)["pose_wrt_matched"],
                               atol=1e-3, rtol=0)
    assert recs[0]["seeds"] == pytest.approx(g["recoveries"][0]["seeds"],
                                             abs=0.5)
    np.testing.assert_allclose(res.seeds, g["seeds"], atol=0.5, rtol=0)
    np.testing.assert_allclose(res.world_poses, g["world_poses"], atol=1e-3,
                               rtol=0)
    assert np.isfinite(res.world_poses).all()
    rows = ellc_io.read_pose_file(str(tmp_path / "poses_orig.txt"))
    np.testing.assert_array_equal(rows[:, 0], res.frame_ids)
    assert DROPPED not in rows[:, 0]


def test_resume_into_recovery_equals_an_uninterrupted_run(golden, tmp_path):
    """Frames 2..20 with a checkpoint every two intervals (keyframe 16;
    with restore_connection the run stops on frame max_frames, as the JAX
    runner does), then a resumed run over the same source: it restores
    keyframe 16 and gives frames 17..34 (the flat keyframe 24, the drop of
    25, the recovery of 26 against keyframe 16, the adopted keyframe's
    frames) bit for bit what an uninterrupted run gives.  A resumed run
    starts with an empty loop window, so both runs keep a window of one
    keyframe: at frame 25 each holds keyframe 16 alone."""
    _, cfg, frames, _ = golden
    cfg = cfg.replace(loop_window=1)
    whole = runner.run_sequence(iter(frames), cfg, "cpu")
    ckpt = str(tmp_path / "ckpt")
    first = runner.run_sequence(iter(frames), cfg, "cpu", max_frames=20,
                                checkpoint_dir=ckpt, checkpoint_every=2)
    assert first.frame_ids.tolist() == list(range(2, 21))
    assert checkpoint.CheckpointManager(ckpt).all_steps() == [16]
    resumed = runner.run_sequence(iter(frames), cfg, "cpu",
                                  checkpoint_dir=ckpt, resume=True)
    assert resumed.extra["dropped_frames"] == [DROPPED]
    for got, want in zip(resumed.extra["recoveries"],
                         whole.extra["recoveries"], strict=True):
        assert (got["frame_id"], got["matched_kf_id"], got["seeds"]) == (
            want["frame_id"], want["matched_kf_id"], want["seeds"])
        assert (got["frame_id"], got["matched_kf_id"]) == (RECOVERED, 16)
        np.testing.assert_array_equal(got["pose_wrt_matched"],
                                      want["pose_wrt_matched"])
    tail = whole.frame_ids > 16
    assert resumed.frame_ids.tolist() == whole.frame_ids[tail].tolist() \
        == [f for f in range(17, 35) if f != DROPPED]
    assert resumed.kf_ids.tolist() == whole.kf_ids[tail].tolist()
    for name in ("world_poses", "seeds", "rescales"):
        np.testing.assert_array_equal(getattr(resumed, name),
                                      getattr(whole, name)[tail])
