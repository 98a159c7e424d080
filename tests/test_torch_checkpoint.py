"""The port's checkpoints (runtime/checkpoint.py) and resume in
run_sequence, at TEST_CONFIG size under the parity config.

A state survives save and load bit for bit under its field paths, a
state of another configuration fails to load by name, the manager keeps
the newest three snapshots, and a run resumed from a checkpoint gives the
frames after it bit for bit what an uninterrupted run gives (both on the
CPU, where every sum runs in one order).  The reference-format text mats
are byte for byte the JAX package's.
"""

import os

import numpy as np
import pytest
import torch

from egomotion_with_local_loop_closures_tpu.runtime import (
    checkpoint as jcheckpoint)
from egomotion_with_local_loop_closures_tpu.utils import synthetic

from egomotion_with_local_loop_closures_tpu_torch.config import (
    PARITY_OVERRIDES, TEST_CONFIG)
from egomotion_with_local_loop_closures_tpu_torch.runtime import (
    checkpoint, pipeline, runner)

torch.set_num_threads(1)

CFG = TEST_CONFIG.replace(**PARITY_OVERRIDES)


@pytest.fixture(scope="module")
def frames():
    """20 integer-valued frames of a camera translating sideways."""
    import jax.numpy as jnp
    scene = synthetic.make_room_scene(seed=5, depth=1.25, half_width=1.7,
                                      half_height=1.15)
    fx, fy, cx, cy = CFG.level_intrinsics(0)
    return [np.round(np.asarray(synthetic.render(
        scene, jnp.asarray([0, 0, 0, 0.004 * i, 0, 0], jnp.float32),
        CFG.rows, CFG.cols, fx, fy, cx, cy)[0])).astype(np.float32)
        for i in range(20)]


@pytest.fixture(scope="module")
def interval_state(frames):
    """The loop-window pipeline state after one interval (keyframe 8)."""
    cfg = CFG.replace(do_loop_closure=True)
    st = pipeline.init_pipeline(frames[0], cfg, "cpu")
    st, _, _ = pipeline.process_interval(st, frames[1:8], cfg)
    return cfg, st


def test_state_round_trip_by_field_path(interval_state, tmp_path):
    cfg, st = interval_state
    path = str(tmp_path / "snap")
    checkpoint.save(path, st, meta={"frame_id": 8, "kf_id": 8})
    with np.load(path + ".npz") as z:
        names = set(z.files)
    assert {"kf.images.0", "kf.weight_acc.3", "depth.valid",
            "global_scale"} <= names
    back = checkpoint.load(path, cfg, "cpu")
    want, got = checkpoint.flatten(st), checkpoint.flatten(back)
    assert list(got) == list(want) and len(want) == 31
    for k, v in want.items():
        assert got[k].dtype == v.dtype, k
        torch.testing.assert_close(got[k], v, rtol=0, atol=0)
    assert checkpoint.load_meta(path) == {"frame_id": 8, "kf_id": 8}


def test_config_mismatch_fails_by_name(interval_state, tmp_path):
    """A loop-window state is not a plain GN state, nor one of another
    image size: load names what differs."""
    cfg, st = interval_state
    path = str(tmp_path / "snap")
    checkpoint.save(path, st)
    with pytest.raises(ValueError, match="unexpected kf.weight_acc.0"):
        checkpoint.load(path, CFG, "cpu")
    with pytest.raises(ValueError, match=r"depth\.idepth is torch.float32 "
                       r"\(96, 128\), expected torch.float32 \(48, 64\)"):
        checkpoint.load(path, cfg.replace(rows=48, cols=64), "cpu")


def test_manager_keeps_the_newest_three(interval_state, tmp_path):
    cfg, st = interval_state
    mgr = checkpoint.CheckpointManager(str(tmp_path / "ckpt"))
    assert mgr.latest_step() is None
    for step in (8, 16, 24, 32, 40):
        mgr.save(step, st, meta={"frame_id": step, "kf_id": step})
    assert mgr.all_steps() == [24, 32, 40] and mgr.latest_step() == 40
    assert sorted(os.listdir(tmp_path / "ckpt")) == [
        "latest"] + [f"step_{s:09d}.{e}" for s in (24, 32, 40)
                     for e in ("json", "npz")]
    state, meta = mgr.restore(cfg, "cpu", step=32)
    assert meta == {"frame_id": 32, "kf_id": 32, "step": 32}
    torch.testing.assert_close(state.depth.idepth, st.depth.idepth)


def test_resume_equals_an_uninterrupted_run(frames, tmp_path):
    """Frames 2..16 with a checkpoint after every interval (max_frames=15
    stops there: as in the JAX runner, the frame that reaches the limit
    is still tracked), then a resumed run over the same source: it
    restores keyframe 16, skips frames 1..16 and tracks 17..20 exactly as
    the uninterrupted run does."""
    whole = runner.run_sequence(iter(frames), CFG, "cpu")
    ckpt = str(tmp_path / "ckpt")
    first = runner.run_sequence(iter(frames), CFG, "cpu", max_frames=15,
                                checkpoint_dir=ckpt, checkpoint_every=1)
    assert first.frame_ids.tolist() == list(range(2, 17))
    assert checkpoint.CheckpointManager(ckpt).all_steps() == [8, 16]
    resumed = runner.run_sequence(iter(frames), CFG, "cpu",
                                  checkpoint_dir=ckpt, resume=True)
    assert resumed.frame_ids.tolist() == list(range(17, 21))
    assert resumed.kf_ids.tolist() == [16] * 4
    tail = slice(15, 19)
    assert whole.frame_ids[tail].tolist() == resumed.frame_ids.tolist()
    for name in ("world_poses", "seeds", "rescales"):
        np.testing.assert_array_equal(getattr(resumed, name),
                                      getattr(whole, name)[tail])


def test_mat_text_matches_jax_bytes(tmp_path):
    rng = np.random.default_rng(0)
    mat = rng.normal(size=(7, 9)).astype(np.float32) * [1e-6, 1, 1e6, 3,
                                                        0, -2, 5e-3, 7, 1]
    mat[2, 4] = 0.0
    ours = checkpoint.save_mat_text(mat, 8, "depth", str(tmp_path / "port"))
    theirs = jcheckpoint.save_mat_text(mat, 8, "depth", str(tmp_path / "jax"))
    assert os.path.basename(ours) == os.path.basename(theirs) == "8_depth.txt"
    with open(ours, "rb") as a, open(theirs, "rb") as b:
        assert a.read() == b.read()
    back = checkpoint.load_mat_text(8, "depth", str(tmp_path / "port"),
                                    shape=(7, 9))
    np.testing.assert_array_equal(
        back, jcheckpoint.load_mat_text(8, "depth", str(tmp_path / "jax")))
    with pytest.raises(ValueError):
        checkpoint.load_mat_text(8, "depth", str(tmp_path / "port"),
                                 shape=(9, 7))
