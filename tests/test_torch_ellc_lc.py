"""The port's LC mode (run_ellc_lc: GN batches with the loop window,
rotation averaging, replay) held against the JAX package at TEST_CONFIG
size under the parity config, with batches of two keyframe intervals, on
an out-and-back trajectory whose later keyframes revisit the first.

The JAX package's run over the same frames is read from
tests/data/port_golden_lc_test.json (tools/make_port_golden.py --lc-test
writes it and the frames): compiling its LC programs takes about three
minutes on a CPU, more than this file may spend.

Tolerances: the same batches, frame ids and loop-edge pairs; corrected
and raw world poses within 2e-3 per twist component over 43 frames,
three batches, two replays and a 4-frame tail (measured on this CPU:
3.2e-4; the two runs track independently and stereo near-ties move the
depth maps slightly, see tests/test_torch_pipeline.py).

Streams that end on a batch boundary or short of one are checked against
the frame ids they must produce, not against the JAX package, which
fails on the first (ROADMAP Queue 3).
"""

import hashlib
import json
import os

import numpy as np
import pytest
import torch

from egomotion_with_local_loop_closures_tpu_torch.config import (
    ELLCConfig, PARITY_OVERRIDES, TEST_CONFIG)
from egomotion_with_local_loop_closures_tpu_torch.ops import reg_kernel
from egomotion_with_local_loop_closures_tpu_torch.runtime import (
    cli, ellc_lc, io as ellc_io)

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, "tests", "data")
KW = dict(PARITY_OVERRIDES, ra_batch_size_bootstrap=2, ra_batch_size=2)
CFG = TEST_CONFIG.replace(**KW)
POSE_TOL = 2e-3
N_FRAMES = 44


@pytest.fixture(scope="module")
def golden():
    with open(os.path.join(DATA, "port_golden_lc_test.json")) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def frames(golden):
    """Integer-valued frames: out for 8 frames, back for 8, then still;
    the frames the JAX package ran on."""
    frames = np.load(os.path.join(ROOT, golden["frames_file"]))[
        "frames"].astype(np.float32)
    assert hashlib.sha256(frames.tobytes()).hexdigest() \
        == golden["frames_sha256"]
    assert len(frames) == N_FRAMES
    return list(frames)


@pytest.fixture(scope="module")
def jax_lc(golden):
    """The JAX package's LC mode over all frames."""
    run = golden["run_ellc_lc"]
    assert run["config_overrides"] == KW
    return run


def pairs(edges):
    return [(int(e.frame_id), int(e.matched_kf_id)) for e in edges]


def test_run_ellc_lc_matches_jax(frames, jax_lc, tmp_path):
    stats = {}
    res = ellc_lc.run_ellc_lc(iter(frames), CFG, "cpu", out_dir=str(tmp_path),
                              max_frames=len(frames), stats=stats)
    # bootstrap 15 frames, two batches of 16 and 8 frames, a 4-frame tail
    assert res.num_batches == jax_lc["num_batches"] == 3
    assert res.frame_ids.tolist() == jax_lc["frame_ids"] \
        == list(range(2, N_FRAMES + 1))
    assert pairs(res.loop_edges) == [(e["frame_id"], e["matched_kf_id"])
                                     for e in jax_lc["edges"]]
    assert res.num_loop_edges == len(jax_lc["edges"]) >= 3
    np.testing.assert_allclose(res.world_poses, jax_lc["world_poses"],
                               atol=POSE_TOL, rtol=0)
    np.testing.assert_allclose(res.raw_world_poses, jax_lc["raw_world_poses"],
                               atol=POSE_TOL, rtol=0)
    assert set(stats) == {"track", "window", "ra", "replay", "tail"}
    rows = ellc_io.read_pose_file(str(tmp_path / "poses_corrected.txt"))
    np.testing.assert_array_equal(rows[:, 0], res.frame_ids)


# K3 calls counted by hand (K = 8, batches of two intervals; the init calls
# regularize once, a track_refine step do_regularization once, a keyframe
# step do_regularization twice and regularize once).  12 frames: frames
# 2..8 (6 track_refine + 1 keyframe step), the stream ends, no replay, a
# tail of frames 9..12: 6 + 2 + 4 = 12 and 1 + 1 = 2.  32 frames: frames
# 2..16 (13 + 2 steps) and its replay, frames 17..32 (14 + 2) and its
# replay: 2 x 17 + 2 x 18 = 70 and 1 + 4 x 2 = 9.
K3_CALLS = {12: {"do_regularization": 12, "regularize": 2},
            32: {"do_regularization": 70, "regularize": 9}}


@pytest.mark.parametrize("n,batches", [(12, 1), (32, 2)])
def test_every_frame_gets_one_corrected_pose(frames, n, batches,
                                             monkeypatch):
    """12 frames: a 7-frame bootstrap batch and a 4-frame tail; 32: the
    stream ends exactly on the second batch's boundary, after its
    replay.  The K3 calls equal the hand count of the schedule."""
    calls = {"do_regularization": 0, "regularize": 0}
    for name in calls:
        def counted(*a, _f=getattr(reg_kernel, name), _n=name, **kw):
            calls[_n] += 1
            return _f(*a, **kw)
        monkeypatch.setattr(reg_kernel, name, counted)
    res = ellc_lc.run_ellc_lc(iter(frames[:n]), CFG, "cpu")
    assert calls == K3_CALLS[n]
    assert res.num_batches == batches
    assert res.frame_ids.tolist() == list(range(2, n + 1))
    assert res.world_poses.shape == (n - 1, 6)
    assert np.isfinite(res.world_poses).all()


def test_sim3_refinement_raises(frames, tmp_path):
    """Sim(3) refinement runs now (against the JAX package:
    tests/test_torch_sim3.py); a stream of fewer than K tracked frames
    has no graph to refine, so it gives None and no poses_sim3.txt, and
    raises nothing."""
    stats = {}
    res = ellc_lc.run_ellc_lc(iter(frames[:3]), CFG.replace(do_sim3_refine=True),
                              "cpu", out_dir=str(tmp_path), stats=stats)
    assert res.frame_ids.tolist() == [2, 3]
    assert res.sim3_world_poses is None and "sim3" not in stats
    assert sorted(os.listdir(tmp_path)) == ["poses_corrected.txt"]


def test_cli_lc_on_image_directory(frames, tmp_path, capsys):
    from PIL import Image
    src = tmp_path / "frames"
    src.mkdir()
    for i, f in enumerate(frames[:12]):
        Image.fromarray(f.astype(np.uint8)).save(src / f"{i:04d}.png")
    out = tmp_path / "out"
    assert cli.main(["--frames", str(src), "--out", str(out), "--lc",
                     "--fx", "120", "--fy", "120", "--device", "cpu"]) == 0
    assert "LC mode: 11 corrected poses, 1 batches" in capsys.readouterr().out
    rows = ellc_io.read_pose_file(str(out / "poses_corrected.txt"))
    assert rows.shape == (11, 10)


# Tolerances of the 480x270 bootstrap, from nine runs of
# tools/lc_golden_spread.py (this CPU at 1, 2, 4 and 8 threads, and five
# runs on an H100): every run agrees with the golden file to 1e-5 up to
# keyframe 8; the order of the sums (thread count, atomic adds) then
# moves the propagated depth, the raw poses part by 1e-4 from frames
# 11-18 and by 1e-3 from frames 20-34 in seven runs, and the gap levels
# off at 2-6e-3.  The edges of keyframes 16 and 24 stayed within 3.0e-4
# rad in every run, all edges within 5.73e-3 rad (two threads), and the
# corrected poses within 8.11e-3.
EARLY_EDGE_FRAMES, EARLY_EDGE_TOL = 24, 1e-3
EDGE_TOL, CORRECTED_TOL = 8e-3, 1e-2


@pytest.mark.slow
def test_golden_lc_bootstrap_480x270_on_cpu():
    """The port on the CPU over the 80-frame LC bootstrap of run_lc
    against the JAX package's output (tools/make_port_golden.py --lc):
    the same loop-edge pairs, KL within 1e-4, and the edge rotations and
    corrected poses within the tolerances above."""
    with open(os.path.join(DATA, "port_golden_run_lc.json")) as f:
        golden = json.load(f)
    frames = np.load(os.path.join(ROOT, golden["frames_file"]))["frames"]
    cfg = ELLCConfig().replace(**golden["config_overrides"])
    n = golden["num_input_frames"]
    res = ellc_lc.run_ellc_lc(iter(frames[:n]), cfg, "cpu",
                              max_frames=golden["max_frames"])
    assert res.num_batches == golden["num_batches"]
    assert res.frame_ids.tolist() == golden["frame_ids"]
    g_edges = golden["edges"]
    assert pairs(res.loop_edges) == [(e["frame_id"], e["matched_kf_id"])
                                     for e in g_edges]
    assert g_edges[0]["frame_id"] <= EARLY_EDGE_FRAMES
    for e, g in zip(res.loop_edges, g_edges):
        assert e.match_value == pytest.approx(g["match_value"], abs=1e-4)
        tol = (EARLY_EDGE_TOL if e.frame_id <= EARLY_EDGE_FRAMES
               else EDGE_TOL)
        np.testing.assert_allclose(e.pose_wrt_matched[:3],
                                   g["pose_wrt_matched"][:3], atol=tol)
    np.testing.assert_allclose(res.world_poses, golden["world_poses"],
                               atol=CORRECTED_TOL, rtol=0)
