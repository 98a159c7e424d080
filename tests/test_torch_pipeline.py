"""The port's pipeline, runner, CLI and state converter held against the
JAX package on integer-valued rendered frames at TEST_CONFIG size, under
the parity config (exact warps, dense stereo, float samples, glibc
bootstrap).

Tolerances (the whole slice over 16 frames): per-frame world poses agree
to 1e-3 per twist component and seeds% to 1 point.  The two runs start
bit-equal and drift apart only through float rounding: a stereo pixel
whose SSD minimum is a near-tie may pick another step, which moves the
depth map slightly (measured on this sequence: poses within ~2e-4, seeds%
within ~0.3 points, valid planes differing on ~1 % of pixels).
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from egomotion_with_local_loop_closures_tpu.config import TEST_CONFIG as JT
from egomotion_with_local_loop_closures_tpu.runtime import io as jio
from egomotion_with_local_loop_closures_tpu.runtime import pipeline as jpipe
from egomotion_with_local_loop_closures_tpu.utils import synthetic

from egomotion_with_local_loop_closures_tpu_torch import convert
from egomotion_with_local_loop_closures_tpu_torch.config import (
    ELLCConfig, PARITY_OVERRIDES, TEST_CONFIG)
from egomotion_with_local_loop_closures_tpu_torch.runtime import (
    cli, io as ellc_io, pipeline, runner)

torch.set_num_threads(1)

JCFG = JT.replace(**PARITY_OVERRIDES)
CFG = TEST_CONFIG.replace(**PARITY_OVERRIDES)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
POSE_TOL, SEEDS_TOL = 1e-3, 1.0


@pytest.fixture(scope="module")
def frames():
    scene = synthetic.make_room_scene(seed=11, depth=1.25, half_width=1.7,
                                      half_height=1.15)
    gt = synthetic.trajectory(16, seed=4, rot_step=0.0015, trans_step=0.02)
    fx, fy, cx, cy = JCFG.level_intrinsics(0)
    return [np.round(np.asarray(synthetic.render(
        scene, p, JCFG.rows, JCFG.cols, fx, fy, cx, cy)[0])).astype(
            np.float32) for p in gt]


@pytest.fixture(scope="module")
def jax_run(frames):
    """The JAX package: init_pipeline, then two 8-frame intervals."""
    js = jpipe.init_pipeline(jnp.asarray(frames[0]), jax.random.PRNGKey(0),
                             JCFG)
    states, outs = [js], []
    for lo in (0, 8):
        js, jo, _ = jpipe.process_interval(
            js, jnp.asarray(np.stack(frames[lo:lo + 8])), JCFG)
        states.append(js)
        outs.append(jo)
    return states, outs


def assert_outputs_close(jo, po):
    np.testing.assert_allclose(np.asarray(jo.pose_wrt_world),
                               po.pose_wrt_world.numpy(), atol=POSE_TOL,
                               rtol=0)
    np.testing.assert_allclose(np.asarray(jo.seeds), po.seeds.numpy(),
                               atol=SEEDS_TOL, rtol=0)
    np.testing.assert_allclose(np.asarray(jo.rescale), po.rescale.numpy(),
                               rtol=1e-3)


def test_two_intervals_match_jax(frames, jax_run):
    """init_pipeline + two process_interval calls in both packages."""
    states, outs = jax_run
    ps = pipeline.init_pipeline(frames[0], CFG, "cpu")
    for lo, jo in zip((0, 8), outs):
        ps, po, _ = pipeline.process_interval(ps, frames[lo:lo + 8], CFG)
        assert_outputs_close(jo, po)
    jtree, ptree = convert.as_tree(states[-1]), convert.to_numpy(ps)
    assert np.mean(jtree["depth"]["valid"] != ptree["depth"]["valid"]) < 0.02
    np.testing.assert_allclose(jtree["kf"]["world_pose"],
                               ptree["kf"]["world_pose"], atol=POSE_TOL)


def test_convert_round_trip_and_shared_start(frames, jax_run):
    """The JAX state after the first interval, carried into the port and
    back, is unchanged; the port's second interval from it matches the
    JAX package's."""
    states, outs = jax_run
    tree = convert.as_tree(states[1])
    ps = convert.to_port(tree, "cpu")
    back = convert.to_numpy(ps)
    for key in ("prev_wrt_kf", "global_scale"):
        np.testing.assert_array_equal(tree[key], back[key])
    for k, v in tree["depth"].items():
        np.testing.assert_array_equal(v, back["depth"][k])
    for k, v in back["kf"].items():
        if isinstance(v, list):
            assert len(v) == len(tree["kf"][k]) == CFG.num_levels
            for a, b in zip(tree["kf"][k], v):
                np.testing.assert_array_equal(a, b)
        else:
            np.testing.assert_array_equal(tree["kf"][k], v)
    assert torch.equal(convert.to_port(tree["depth"], "cpu").valid,
                       ps.depth.valid)
    ps, po, _ = pipeline.process_interval(ps, frames[8:16], CFG)
    assert_outputs_close(outs[1], po)


def test_init_from_depth_matches_jax(frames):
    rng = np.random.default_rng(0)
    depth = np.where(rng.uniform(size=CFG.shape) < 0.6,
                     rng.uniform(0.5, 3.0, size=CFG.shape), 0.0
                     ).astype(np.float32)
    var = np.full(CFG.shape, 0.02, np.float32)
    pose = np.asarray([0.01, 0.0, -0.02, 0.1, 0.0, 0.05], np.float32)
    js = jpipe.init_from_depth(jnp.asarray(frames[0]), jnp.asarray(depth),
                               jnp.asarray(var), jnp.asarray(pose), JCFG)
    ps = pipeline.init_from_depth(frames[0], depth, var, pose, CFG, "cpu")
    jtree, ptree = convert.as_tree(js), convert.to_numpy(ps)
    for k, v in jtree["depth"].items():
        np.testing.assert_allclose(v, ptree["depth"][k], rtol=1e-6)
    for k in ("depths", "vars_", "images"):
        for a, b in zip(jtree["kf"][k], ptree["kf"][k]):
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-4)
    np.testing.assert_array_equal(jtree["kf"]["world_pose"],
                                  ptree["kf"]["world_pose"])


def test_run_sequence_writes_reference_format(frames, tmp_path):
    res = runner.run_sequence(iter(frames[:11]), CFG, "cpu",
                              out_dir=str(tmp_path))
    assert res.frame_ids.tolist() == list(range(2, 12))
    # frames 2-8 track KF 1, 9-11 KF 8 (keyframes on ids divisible by 8)
    assert res.kf_ids.tolist() == [1] * 7 + [8] * 3
    poses = ellc_io.read_pose_file(str(tmp_path / "poses_orig.txt"))
    assert poses.shape == (10, 10)
    matches = ellc_io.read_pose_file(str(tmp_path / "matchframes.txt"))
    assert matches.shape == (1, 13) and matches[0, :2].tolist() == [8, 1]
    assert np.isfinite(poses).all() and (res.seeds > 0).all()
    # byte-identical to what the JAX package's writer makes of the numbers
    ref = tmp_path / "jax_poses_orig.txt"
    with jio.PoseWriter(str(ref)) as w:
        for j, fid in enumerate(res.frame_ids):
            w.write(int(fid), int(res.kf_ids[j]), res.world_poses[j],
                    res.rescales[j], res.seeds[j])
    assert (tmp_path / "poses_orig.txt").read_bytes() == ref.read_bytes()
    assert len(res.extra["block_times"]) == 2


@pytest.mark.parametrize("field", ["restore_connection", "do_undistortion"])
def test_features_outside_the_slice_raise(frames, field):
    with pytest.raises(NotImplementedError):
        runner.run_sequence(iter(frames[:3]), CFG.replace(**{field: True}),
                            "cpu")


def test_replay_and_checkpoints_raise(frames):
    """Replay runs now (test_replay_step_matches_jax); checkpoints are
    still outside the port's slice."""
    with pytest.raises(NotImplementedError):
        runner.run_sequence(iter(frames[:3]), CFG, "cpu",
                            checkpoint_dir="ckpt")


def test_replay_step_matches_jax(frames, jax_run):
    """A replayed frame (the {5,1,1,1} schedule) whose rotation is seeded
    from a corrected world pose, from the same converted state."""
    states, outs = jax_run
    rot = np.asarray(outs[0].pose_wrt_world[-1]) + np.asarray(
        [0.004, -0.003, 0.002, 0, 0, 0], np.float32)
    js, jo = jpipe.track_refine_step(states[1], jnp.asarray(frames[9]), JCFG,
                                     replay=True,
                                     init_rotation=jnp.asarray(rot))
    ps, po = pipeline.track_refine_step(
        convert.to_port(convert.as_tree(states[1]), "cpu"), frames[9], CFG,
        replay=True, init_rotation=rot)
    np.testing.assert_allclose(np.asarray(jo.pose_wrt_world),
                               po.pose_wrt_world.numpy(), atol=POSE_TOL)
    assert float(po.seeds) == pytest.approx(float(jo.seeds), abs=SEEDS_TOL)
    # the seeded rotation changed the start, so the result differs from
    # the unseeded step's
    _, plain = pipeline.track_refine_step(
        convert.to_port(convert.as_tree(states[1]), "cpu"), frames[9], CFG,
        replay=True)
    assert not torch.equal(plain.pose_wrt_kf, po.pose_wrt_kf)


def test_loop_window_state_converts_both_ways(frames):
    """With loop closure on, the keyframe carries per-level weight
    accumulators; they survive the trip JAX -> port -> numpy, and one
    tracked frame accumulates the same weights in both packages."""
    jcfg, cfg = (c.replace(do_loop_closure=True) for c in (JCFG, CFG))
    js = jpipe.init_pipeline(jnp.asarray(frames[0]), jax.random.PRNGKey(0),
                             jcfg)
    tree = convert.as_tree(js)
    ps = convert.to_port(tree, "cpu")
    back = convert.to_numpy(ps)
    assert len(back["kf"]["weight_acc"]) == cfg.num_levels
    for a, b in zip(tree["kf"]["weight_acc"], back["kf"]["weight_acc"]):
        np.testing.assert_array_equal(a, b)
    ps, _ = pipeline.track_refine_step(ps, frames[1], cfg)
    assert float(ps.kf.weight_count) == 1.0
    fresh = pipeline.init_pipeline(frames[0], cfg, "cpu")
    assert float(fresh.kf.weight_count) == 0.0
    assert all(float(a.abs().sum()) == 0.0 for a in fresh.kf.weight_acc)
    assert float(ps.kf.weight_acc[0].sum()) > 0.0


def test_cli_on_image_directory(frames, tmp_path, capsys):
    from PIL import Image
    src = tmp_path / "frames"
    src.mkdir()
    for i, f in enumerate(frames[:9]):
        Image.fromarray(f.astype(np.uint8)).save(src / f"{i:04d}.png")
    out = tmp_path / "out"
    assert cli.main(["--frames", str(src), "--out", str(out),
                     "--fx", "120", "--fy", "120", "--device", "cpu"]) == 0
    assert "tracked 8 frames" in capsys.readouterr().out
    assert ellc_io.read_pose_file(str(out / "poses_orig.txt")).shape == (8, 10)


def test_runner_imports_without_jax():
    code = ("import sys, egomotion_with_local_loop_closures_tpu_torch."
            "runtime.runner, egomotion_with_local_loop_closures_tpu_torch."
            "runtime.ellc_lc, egomotion_with_local_loop_closures_tpu_torch."
            "runtime.cli, egomotion_with_local_loop_closures_tpu_torch."
            "loop.closure, egomotion_with_local_loop_closures_tpu_torch."
            "graph.rotation_averaging, egomotion_with_local_loop_closures_"
            "tpu_torch.convert; print(sorted(m for m in sys.modules if m == "
            "'jax' or "
            "m.startswith(('jax.', 'egomotion_with_local_loop_closures_tpu.'"
            ")) or m == 'egomotion_with_local_loop_closures_tpu'))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]"


@pytest.mark.slow
def test_golden_480x270_on_cpu():
    """The port on the CPU over the first 17 frames of run_gn against the
    JAX package's output (tools/make_port_golden.py)."""
    with open(os.path.join(ROOT, "tests", "data",
                           "port_golden_run_gn.json")) as f:
        golden = json.load(f)
    frames = np.load(os.path.join(ROOT, golden["frames_file"]))["frames"]
    cfg = ELLCConfig().replace(**PARITY_OVERRIDES)
    res = runner.run_sequence(iter(frames[:golden["num_input_frames"]]),
                              cfg, "cpu")
    assert res.frame_ids.tolist() == golden["frame_ids"]
    first = res.frame_ids <= cfg.keyframe_interval
    d_pose = np.abs(res.world_poses - np.asarray(golden["world_poses"]))
    assert d_pose[first].max() <= POSE_TOL
    # 2 seeds% points, not 1: frame 17, the first stereo pass against the
    # new keyframe 16, has a one-frame baseline, so which pixels pass the
    # epipolar gates hangs on the last bits of the pose; measured on this
    # CPU with one thread: 1.05 points there, <= 0.1 on the other frames
    np.testing.assert_allclose(res.seeds, golden["seeds"], atol=2.0, rtol=0)
