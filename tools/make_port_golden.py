"""Write the golden files that the PyTorch port is checked against.

GN mode (default): runs the JAX package's ``runner.run_sequence`` on the
CPU over the first 17 frames of
``reference_build/run_gn/frames_480x270.npz`` (480x270) under the parity
config (exact warps, dense stereo, float samples, the glibc bootstrap),
and writes the tracked frames' world poses, seeds% and rescale factors to
``tests/data/port_golden_run_gn.json``.

LC mode (``--lc``): runs the JAX package's ``ellc_lc.run_ellc_lc`` on the
CPU under the parity config over the first 80 frames of
``reference_build/run_lc`` with ``max_frames=80``: the reference binary's
``1 10 1`` bootstrap batch (79 tracked frames, one rotation averaging, no
replay).  It writes the corrected and raw world poses, the frame ids and
the loop edges (pair, pose, KL, rms, view angle) to
``tests/data/port_golden_run_lc.json``, and prints how many of the edge
pairs the binary's ``matchframes_globalopt.txt`` has too.

LC tests (``--lc-test``): renders the 44 integer-valued 96x128 frames of
an out-and-back camera in the scene of ``tests/test_loop.py`` (away for 8
frames, back for 8, then still) into ``tests/data/port_lc_test_frames.npz``
and runs the JAX package on them at ``TEST_CONFIG`` under the parity
config: ``runner.run_sequence`` with the loop window over the first 25
frames (its loop edges and a summary of every keyframe snapshot pushed to
the window) and ``ellc_lc.run_ellc_lc`` over all 44 with batches of two
keyframe intervals (batches, frame ids, corrected and raw world poses,
loop edges).  It writes them to ``tests/data/port_golden_lc_test.json``
(about 6 minutes on a CPU, most of it compiling the JAX programs, which
is why ``tests/test_torch_loop.py`` and
``tests/test_torch_ellc_lc.py`` read the file instead of running the JAX
package themselves).

The LC run above also refines the corrected trajectory with Sim(3)
(``do_sim3_refine``, which runs after the corrected poses and leaves them
as they are) and writes the refined poses as ``sim3_world_poses``.

Recovery (``--recovery``): runs the JAX package's ``runner.run_sequence``
on the CPU with ``restore_connection`` under the parity config over the
first 48 frames of ``reference_build/run_gn`` at 480x270, with frames 40
and 41 replaced by a flat gray image (128): keyframe 40 is built on the
flat frame with no seeds, so the next frames go through connection
recovery.  It writes the tracked frames, the recoveries (with the
recovered pose w.r.t. the matched keyframe), the dropped frames and the
candidates of every recovery attempt to
``tests/data/port_golden_recovery.json``.

Recovery tests (``--recovery-test``): the same at 96x128 over 34
integer-valued frames of the scene of ``tests/test_recovery.py`` (a slow
sideways translation), frames 24 and 25 flat, into
``tests/data/port_golden_recovery_test.json``; the frames and every
keyframe snapshot pushed to the loop window before the first recovery
(with its depth state) go to ``tests/data/port_recovery_test.npz`` so a
test can hand the JAX package's window to the port.

Batched videos (``--batched``): the reference of ``chip_smoke.py``'s phase
9.  Runs the JAX package on the CPU under the parity config (glibc
bootstrap) on each of 8 videos of ``reference_build/run_gn`` at 480x270,
video v being frames 64v..64v+31: ``pipeline.init_pipeline`` and four
``process_interval`` calls (7, 8, 8 and 8 frames), one video at a time,
and writes every video's per-frame world poses, seeds% and rescale
factors to ``tests/data/port_golden_batched_run_gn.json`` (about 4
minutes on a CPU).

Batched tests (``--batched-test``): runs the JAX package's multi-video
path, ``parallel.sharded.batched_init`` and two
``batched_process_interval`` calls (7 and 8 frames), on a 3-device CPU
mesh (``--xla_force_host_platform_device_count=3``, set before jax is
imported) at ``TEST_CONFIG`` under the parity config with the glibc
bootstrap.  Video ``v`` is 16 frames of ``tests/data/port_lc_test_frames.npz``
from frame 14v on.  The init state's arrays go to
``tests/data/port_batched_test.npz`` under their field paths
(``kf.images.0``, ``depth.valid``, ...), and each interval's outputs to
``tests/data/port_golden_batched_test.json``.

Parity on run_gn (``--parity-gn``): the reference of
``tools/port_parity_eval.py`` and ``chip_smoke.py``'s phase 11.  Runs the
JAX package's ``runner.run_sequence`` on the CPU under the parity config
over every frame of ``reference_build/run_gn`` (``--frames N``: the first
N) and writes the tracked frames' world poses, seeds% and rescale factors
and the run's seconds to ``tests/data/port_golden_parity_gn.json``.

Synthetic scenes (``--synthetic``): the reference of ``chip_smoke.py``'s
phase 10 and of ``tests/test_torch_synthetic.py``.  Two runs of the JAX
package on the CPU, both on the scene and trajectory of the JAX CLI's
``--synthetic`` (seed 0, ``depth=1.25, half_width=1.7, half_height=1.15,
rot_step=0.0015, trans_step=0.02``): 65 frames at 480x270 rendered by
``utils.synthetic.render`` and tracked by ``runner.run_sequence`` under
the parity config, and the JAX CLI itself, ``--synthetic 17`` at its
96x128 default.  For each it writes the ground-truth poses, the tracked
world poses and seeds%, and the ATE against the ground truth to
``tests/data/port_golden_synthetic.json``.

``chip_smoke.py`` and the port's tests compare the port's runs with these
files.

Usage: python tools/make_port_golden.py [--lc | --lc-test | --recovery |
       --recovery-test | --batched | --batched-test | --parity-gn |
       --synthetic] [--frames N] [--out PATH]
"""

from __future__ import annotations

import argparse
import base64
import dataclasses
import hashlib
import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FRAMES = os.path.join(ROOT, "reference_build", "run_gn", "frames_480x270.npz")
LC_FRAMES = os.path.join(ROOT, "reference_build", "run_lc",
                         "frames_480x270.npz")
LC_EDGES = os.path.join(ROOT, "reference_build", "run_lc", "outputs",
                        "matchframes_globalopt.txt")
DEFAULT_OUT = os.path.join(ROOT, "tests", "data", "port_golden_run_gn.json")
DEFAULT_LC_OUT = os.path.join(ROOT, "tests", "data", "port_golden_run_lc.json")
LC_TEST_OUT = os.path.join(ROOT, "tests", "data", "port_golden_lc_test.json")
LC_TEST_FRAMES = os.path.join(ROOT, "tests", "data", "port_lc_test_frames.npz")
LC_TEST_N, LC_TEST_N_WINDOW = 44, 25
RECOVERY_OUT = os.path.join(ROOT, "tests", "data", "port_golden_recovery.json")
RECOVERY_TEST_OUT = os.path.join(ROOT, "tests", "data",
                                 "port_golden_recovery_test.json")
RECOVERY_TEST_NPZ = os.path.join(ROOT, "tests", "data",
                                 "port_recovery_test.npz")
BATCHED_OUT = os.path.join(ROOT, "tests", "data",
                           "port_golden_batched_run_gn.json")
# chip_smoke.py phase 9: video v is frames BATCHED_STRIDE * v onwards
BATCHED_VIDEOS, BATCHED_STRIDE, BATCHED_INTERVALS = 8, 64, (7, 8, 8, 8)
BATCHED_TEST_OUT = os.path.join(ROOT, "tests", "data",
                                "port_golden_batched_test.json")
BATCHED_TEST_NPZ = os.path.join(ROOT, "tests", "data",
                                "port_batched_test.npz")
# first frame of each video in the LC test frames, frames a video
BATCHED_TEST_OFFSETS, BATCHED_TEST_N = (0, 14, 28), 16
PARITY_GN_OUT = os.path.join(ROOT, "tests", "data",
                             "port_golden_parity_gn.json")
SYNTHETIC_OUT = os.path.join(ROOT, "tests", "data",
                             "port_golden_synthetic.json")
# the JAX CLI's --synthetic scene and trajectory (runtime/cli.py:75-80)
SYNTHETIC_SCENE = dict(depth=1.25, half_width=1.7, half_height=1.15)
SYNTHETIC_TRAJ = dict(rot_step=0.0015, trans_step=0.02)
SYNTHETIC_N, SYNTHETIC_TEST_N = 65, 17
# frame ids (1-based) replaced by a flat gray image, and the frame counts
RECOVERY_FLAT, RECOVERY_N = (40, 41), 48
RECOVERY_TEST_FLAT, RECOVERY_TEST_N = (24, 25), 34
FLAT_GRAY = 128.0


def _common(cfg, frames_file, n, source, overrides):
    return {
        "source": source,
        "frames_file": os.path.relpath(frames_file, ROOT),
        "num_input_frames": int(n),
        "config_overrides": overrides,
        "config": {k: v for k, v in dataclasses.asdict(cfg).items()
                   if not isinstance(v, tuple)},
    }


def golden_gn(n, PARITY_OVERRIDES):
    from egomotion_with_local_loop_closures_tpu.config import ELLCConfig
    from egomotion_with_local_loop_closures_tpu.runtime import runner

    cfg = ELLCConfig().replace(**PARITY_OVERRIDES)
    frames = np.load(FRAMES)["frames"][:n]
    res = runner.run_sequence(iter(frames), cfg)
    golden = _common(cfg, FRAMES, n, "egomotion_with_local_loop_closures_tpu"
                     " runner.run_sequence on the CPU, "
                     "tools/make_port_golden.py", PARITY_OVERRIDES)
    golden.update(frame_ids=res.frame_ids.tolist(),
                  kf_ids=res.kf_ids.tolist(),
                  world_poses=np.asarray(res.world_poses,
                                         np.float64).tolist(),
                  seeds=res.seeds.tolist(), rescales=res.rescales.tolist())
    print(f"{len(res.frame_ids)} tracked frames")
    return golden


def _edges(edges):
    return [{"frame_id": int(e.frame_id),
             "matched_kf_id": int(e.matched_kf_id),
             "pose_wrt_matched": np.asarray(e.pose_wrt_matched,
                                            np.float64).tolist(),
             "match_value": float(e.match_value),
             "rms_error": float(e.rms_error),
             "view_angle": float(e.view_angle)} for e in edges]


def sha256(a) -> str:
    """Hex digest of an array's float32 bytes."""
    return hashlib.sha256(np.ascontiguousarray(a, np.float32).tobytes()
                          ).hexdigest()


def support_bits(w) -> str:
    """Where a weight image is positive, as base64 of the packed bits."""
    return base64.b64encode(np.packbits(np.asarray(w).ravel() > 0)
                            ).decode("ascii")


def out_and_back_frames(cfg, n):
    """Integer-valued frames of a camera that translates away for 8
    frames, back for 8, then stays at the start."""
    import jax.numpy as jnp
    from egomotion_with_local_loop_closures_tpu.utils import synthetic
    scene = synthetic.make_room_scene(seed=11, depth=1.25, half_width=1.7,
                                      half_height=1.15)
    fx, fy, cx, cy = cfg.level_intrinsics(0)
    frames = []
    for i in range(n):
        k = min(i, 16)
        mag = (k if k <= 8 else 16 - k) * 0.018
        pose = jnp.asarray([0.0, 0.0, 0.0, mag, mag * 0.3, 0.0], jnp.float32)
        frames.append(np.round(np.asarray(synthetic.render(
            scene, pose, cfg.rows, cfg.cols, fx, fy, cx, cy)[0])))
    frames = np.stack(frames).astype(np.float32)
    assert frames.min() >= 0 and frames.max() <= 255
    return frames


def golden_lc_test(PARITY_OVERRIDES):
    from egomotion_with_local_loop_closures_tpu.config import TEST_CONFIG
    from egomotion_with_local_loop_closures_tpu.loop import closure
    from egomotion_with_local_loop_closures_tpu.runtime import (ellc_lc,
                                                                runner)

    frames = out_and_back_frames(TEST_CONFIG, LC_TEST_N)
    np.savez_compressed(LC_TEST_FRAMES, frames=frames.astype(np.uint8))

    window = dict(PARITY_OVERRIDES, do_loop_closure=True)
    pushes = []
    push = closure.LoopCloser.push_keyframe

    def recording(self, frame_id, image, kf_levels, weight_levels,
                  world_pose, *args, **kw):
        pushes.append({
            "frame_id": int(frame_id), "image_sha256": sha256(image),
            "world_pose": np.asarray(world_pose, np.float64).tolist(),
            "seeds": float(args[2]),
            "weight_support": [support_bits(w) for w in weight_levels],
            "weight_sum": [float(np.asarray(w, np.float64).sum())
                           for w in weight_levels]})
        return push(self, frame_id, image, kf_levels, weight_levels,
                    world_pose, *args, **kw)

    closure.LoopCloser.push_keyframe = recording
    res = runner.run_sequence(iter(frames[:LC_TEST_N_WINDOW]),
                              TEST_CONFIG.replace(**window))
    closure.LoopCloser.push_keyframe = push
    seq = {"num_input_frames": LC_TEST_N_WINDOW, "config_overrides": window,
           "edges": _edges(res.extra["loop_edges"]), "pushes": pushes}

    closers = []

    class RecordingCloser(closure.LoopCloser):
        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            closers.append(self)

    ellc_lc.closure.LoopCloser = RecordingCloser
    batches = dict(PARITY_OVERRIDES, ra_batch_size_bootstrap=2,
                   ra_batch_size=2)
    res = ellc_lc.run_ellc_lc(iter(frames), TEST_CONFIG.replace(**batches),
                              max_frames=LC_TEST_N)
    lc = {"num_input_frames": LC_TEST_N, "max_frames": LC_TEST_N,
          "config_overrides": batches, "num_batches": int(res.num_batches),
          "frame_ids": res.frame_ids.tolist(),
          "world_poses": np.asarray(res.world_poses, np.float64).tolist(),
          "raw_world_poses": np.asarray(res.raw_world_poses,
                                        np.float64).tolist(),
          "edges": _edges(closers[0].edges)}
    print(f"run_sequence: {len(pushes)} pushes, {len(seq['edges'])} loop "
          f"edges; run_ellc_lc: {res.num_batches} batches, "
          f"{len(lc['edges'])} loop edges")
    return {"source": "egomotion_with_local_loop_closures_tpu on the CPU at "
                      "TEST_CONFIG, tools/make_port_golden.py --lc-test",
            "frames_file": os.path.relpath(LC_TEST_FRAMES, ROOT),
            "frames_sha256": sha256(frames),
            "run_sequence": seq, "run_ellc_lc": lc}


def golden_lc(n, PARITY_OVERRIDES):
    from egomotion_with_local_loop_closures_tpu.config import ELLCConfig
    from egomotion_with_local_loop_closures_tpu.runtime import ellc_lc

    closers = []

    class RecordingCloser(ellc_lc.closure.LoopCloser):
        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            closers.append(self)

    ellc_lc.closure.LoopCloser = RecordingCloser
    cfg = ELLCConfig().replace(**PARITY_OVERRIDES, do_loop_closure=True)
    frames = np.load(LC_FRAMES)["frames"][:n]
    res = ellc_lc.run_ellc_lc(iter(frames), cfg.replace(do_sim3_refine=True),
                              max_frames=n)
    edges = closers[0].edges
    golden = _common(cfg, LC_FRAMES, n, "egomotion_with_local_loop_closures_tpu"
                     " ellc_lc.run_ellc_lc on the CPU with max_frames = "
                     "num_input_frames, tools/make_port_golden.py --lc",
                     dict(PARITY_OVERRIDES, do_loop_closure=True))
    golden.update(
        max_frames=int(n), num_batches=int(res.num_batches),
        frame_ids=res.frame_ids.tolist(),
        world_poses=np.asarray(res.world_poses, np.float64).tolist(),
        raw_world_poses=np.asarray(res.raw_world_poses, np.float64).tolist(),
        edges=_edges(edges),
        sim3_world_poses=np.asarray(res.sim3_world_poses,
                                    np.float64).tolist())
    ours = {(int(e.frame_id), int(e.matched_kf_id)) for e in edges}
    ref = {(int(r[0]), int(r[1]))
           for r in np.atleast_2d(np.loadtxt(LC_EDGES))}
    print(f"{len(res.frame_ids)} corrected poses, {res.num_batches} batch(es),"
          f" {len(edges)} loop edges; pairs in common with the binary's "
          f"{os.path.relpath(LC_EDGES, ROOT)}: {len(ours & ref)} of "
          f"{len(ref)} (only the binary's: {sorted(ref - ours)}, only "
          f"these: {sorted(ours - ref)})")
    return golden


def flat_frames(frames, flat_ids):
    """``frames`` with the given 1-based frame ids replaced by a flat gray
    image."""
    frames = np.array(frames, np.float32)
    for fid in flat_ids:
        frames[fid - 1] = FLAT_GRAY
    return frames


def sideways_frames(cfg, n):
    """Integer-valued frames of tests/test_recovery.py's scene with the
    camera translating 0.004 a frame along x."""
    import jax.numpy as jnp
    from egomotion_with_local_loop_closures_tpu.utils import synthetic
    scene = synthetic.make_room_scene(seed=3, depth=1.25, half_width=1.7,
                                      half_height=1.15)
    fx, fy, cx, cy = cfg.level_intrinsics(0)
    return np.stack([np.round(np.asarray(synthetic.render(
        scene, jnp.asarray([0, 0, 0, 0.004 * i, 0, 0], jnp.float32),
        cfg.rows, cfg.cols, fx, fy, cx, cy)[0])) for i in range(n)]
                    ).astype(np.float32)


def run_recovery(frames, cfg):
    """The JAX package's run_sequence with connection recovery on
    ``frames``, recording every keyframe pushed to the loop window (with
    its depth state) and every recovery attempt."""
    from egomotion_with_local_loop_closures_tpu.loop import closure, recovery
    from egomotion_with_local_loop_closures_tpu.runtime import runner

    pushes, attempts = [], []
    push, find = closure.LoopCloser.push_keyframe, recovery.find_connection

    def recording_push(self, frame_id, image, kf_levels, weight_levels,
                       world_pose, origin_pose, rescale, seeds, **kw):
        pushes.append({"frame_id": int(frame_id), "image": image,
                       "kf_levels": kf_levels, "weight_levels": weight_levels,
                       "world_pose": world_pose, "rescale": rescale,
                       "seeds": seeds, "depth_state": kw["depth_state"]})
        return push(self, frame_id, image, kf_levels, weight_levels,
                    world_pose, origin_pose, rescale, seeds, **kw)

    def recording_find(closer, frame_id, image, cfg):
        cands = [e.frame_id for e in reversed(closer.entries)
                 if frame_id - e.frame_id > cfg.min_match_difference
                 and e.depth_state is not None]
        rec = find(closer, frame_id, image, cfg)
        attempts.append({
            "frame_id": int(frame_id), "candidates": cands,
            "window": [e.frame_id for e in closer.entries],
            "matched_kf_id": None if rec is None else int(rec.matched_kf_id),
            "pose_wrt_matched": None if rec is None else np.asarray(
                rec.pose_wrt_matched, np.float64).tolist(),
            "world_pose": None if rec is None else np.asarray(
                rec.world_pose, np.float64).tolist(),
            "rescale": None if rec is None else float(rec.rescale),
            "seeds": None if rec is None else float(rec.seeds)})
        return rec

    closure.LoopCloser.push_keyframe = recording_push
    recovery.find_connection = recording_find
    try:
        res = runner.run_sequence(iter(frames), cfg)
    finally:
        closure.LoopCloser.push_keyframe = push
        recovery.find_connection = find
    golden = {
        "frame_ids": res.frame_ids.tolist(), "kf_ids": res.kf_ids.tolist(),
        "world_poses": np.asarray(res.world_poses, np.float64).tolist(),
        "seeds": res.seeds.tolist(), "rescales": res.rescales.tolist(),
        "recoveries": [{"frame_id": int(r["frame_id"]),
                        "matched_kf_id": int(r["matched_kf_id"]),
                        "seeds": float(r["seeds"])}
                       for r in res.extra["recoveries"]],
        "dropped_frames": [int(f) for f in res.extra["dropped_frames"]],
        "attempts": attempts}
    print(f"{len(res.frame_ids)} tracked frames; recoveries "
          f"{[(r['frame_id'], r['matched_kf_id']) for r in golden['recoveries']]}"
          f", dropped {golden['dropped_frames']}, attempts "
          f"{[(a['frame_id'], a['candidates']) for a in attempts]}")
    return golden, pushes


def golden_recovery(PARITY_OVERRIDES):
    from egomotion_with_local_loop_closures_tpu.config import ELLCConfig

    overrides = dict(PARITY_OVERRIDES, restore_connection=True)
    cfg = ELLCConfig().replace(**overrides)
    frames = np.load(FRAMES)["frames"][:RECOVERY_N]
    golden = _common(cfg, FRAMES, RECOVERY_N,
                     "egomotion_with_local_loop_closures_tpu runner."
                     "run_sequence with restore_connection on the CPU, "
                     "tools/make_port_golden.py --recovery", overrides)
    run, _ = run_recovery(flat_frames(frames, RECOVERY_FLAT), cfg)
    golden.update(flat_frame_ids=list(RECOVERY_FLAT), flat_gray=FLAT_GRAY,
                  **run)
    return golden


def golden_recovery_test(PARITY_OVERRIDES):
    from egomotion_with_local_loop_closures_tpu.config import ELLCConfig

    # tests/test_recovery.py's camera
    overrides = dict(PARITY_OVERRIDES, rows=96, cols=128, fx=110.0,
                     fy=110.0, cx=64.0, cy=48.0, restore_connection=True)
    cfg = ELLCConfig().replace(**overrides)
    frames = flat_frames(sideways_frames(cfg, RECOVERY_TEST_N),
                         RECOVERY_TEST_FLAT)
    assert frames.min() >= 0 and frames.max() <= 255
    run, pushes = run_recovery(frames, cfg)
    first = next(a for a in run["attempts"] if a["matched_kf_id"])
    arrays = {"frames": frames.astype(np.uint8)}
    window = [p for p in pushes if p["frame_id"] in first["window"]]
    for k, p in enumerate(window):
        for l, lv in enumerate(p["kf_levels"]):
            for f in ("image", "depth", "var"):
                arrays[f"push{k}.kf_levels.{l}.{f}"] = np.asarray(
                    getattr(lv, f))
        for l, w in enumerate(p["weight_levels"]):
            arrays[f"push{k}.weight_levels.{l}"] = np.asarray(w)
        for f in ("image", "world_pose", "rescale", "seeds"):
            arrays[f"push{k}.{f}"] = np.asarray(p[f], np.float32)
        arrays[f"push{k}.frame_id"] = np.asarray(p["frame_id"])
        for f, v in p["depth_state"]._asdict().items():
            arrays[f"push{k}.depth_state.{f}"] = np.asarray(v)
    np.savez_compressed(RECOVERY_TEST_NPZ, **arrays)
    golden = {"source": "egomotion_with_local_loop_closures_tpu runner."
                        "run_sequence with restore_connection on the CPU, "
                        "tools/make_port_golden.py --recovery-test",
              "arrays_file": os.path.relpath(RECOVERY_TEST_NPZ, ROOT),
              "frames_sha256": sha256(frames), "num_input_frames":
              RECOVERY_TEST_N, "config_overrides": overrides,
              "flat_frame_ids": list(RECOVERY_TEST_FLAT),
              "flat_gray": FLAT_GRAY,
              "window_frame_ids": [p["frame_id"] for p in window], **run}
    return golden


def field_paths(tree, prefix=""):
    """Nested dicts and lists of arrays -> {field path: array}."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, list):
        items = enumerate(tree)
    else:
        return {prefix[:-1]: np.asarray(tree)}
    out = {}
    for k, v in items:
        out.update(field_paths(v, f"{prefix}{k}."))
    return out


def golden_batched(PARITY_OVERRIDES):
    import jax
    import jax.numpy as jnp
    from egomotion_with_local_loop_closures_tpu.config import ELLCConfig
    from egomotion_with_local_loop_closures_tpu.runtime import pipeline

    cfg = ELLCConfig().replace(**PARITY_OVERRIDES)
    frames = np.load(FRAMES)["frames"].astype(np.float32)
    n = 1 + sum(BATCHED_INTERVALS)
    videos = []
    for v in range(BATCHED_VIDEOS):
        f = frames[BATCHED_STRIDE * v:BATCHED_STRIDE * v + n]
        state = pipeline.init_pipeline(jnp.asarray(f[0]),
                                       jax.random.PRNGKey(v), cfg)
        outs, start = [], 1
        for k in BATCHED_INTERVALS:
            state, o, _ = pipeline.process_interval(
                state, jnp.asarray(f[start:start + k]), cfg)
            outs.append(o)
            start += k
        videos.append({k: np.concatenate([np.asarray(getattr(o, k),
                                                     np.float64)
                                          for o in outs]).tolist()
                       for k in ("pose_wrt_world", "seeds", "rescale")})
        ends = np.cumsum(BATCHED_INTERVALS) - 1
        print(f"video {v}: seeds% at the interval ends "
              f"{[round(videos[-1]['seeds'][e], 3) for e in ends]}")
    golden = _common(cfg, FRAMES, len(frames),
                     "egomotion_with_local_loop_closures_tpu pipeline."
                     "init_pipeline and process_interval on the CPU, one "
                     "video at a time, tools/make_port_golden.py --batched",
                     PARITY_OVERRIDES)
    golden.update(stride=BATCHED_STRIDE, intervals=list(BATCHED_INTERVALS),
                  videos=videos)
    return golden


def golden_batched_test(PARITY_OVERRIDES):
    import jax
    import jax.numpy as jnp
    from egomotion_with_local_loop_closures_tpu.config import TEST_CONFIG
    from egomotion_with_local_loop_closures_tpu.parallel import (mesh,
                                                                 sharded)
    from egomotion_with_local_loop_closures_tpu_torch.convert import as_tree

    cfg = TEST_CONFIG.replace(**PARITY_OVERRIDES)
    frames = np.load(LC_TEST_FRAMES)["frames"].astype(np.float32)
    V = len(BATCHED_TEST_OFFSETS)
    batch = np.stack([frames[o:o + BATCHED_TEST_N]
                      for o in BATCHED_TEST_OFFSETS])
    m = mesh.make_mesh(video=V, pixel=1)
    keys = jax.random.split(jax.random.PRNGKey(0), V)
    states = sharded.batched_init(jnp.asarray(batch[:, 0]), keys, cfg, m)
    np.savez_compressed(BATCHED_TEST_NPZ, **field_paths(as_tree(states)))
    K = cfg.keyframe_interval
    intervals, start = [], 1
    for n in (K - 1, K):
        states, outs = sharded.batched_process_interval(
            states, jnp.asarray(batch[:, start:start + n]), cfg, m)
        intervals.append({k: np.asarray(v, np.float64).tolist()
                          for k, v in as_tree(outs).items()})
        start += n
    print(f"{V} videos, intervals of {K - 1} and {K} frames; last seeds% "
          f"{[round(s[-1], 3) for s in intervals[-1]['seeds']]}")
    return {"source": "egomotion_with_local_loop_closures_tpu "
                      "parallel.sharded on a 3-device CPU mesh at TEST_CONFIG,"
                      " tools/make_port_golden.py --batched-test",
            "frames_file": os.path.relpath(LC_TEST_FRAMES, ROOT),
            "frames_sha256": sha256(frames),
            "arrays_file": os.path.relpath(BATCHED_TEST_NPZ, ROOT),
            "offsets": list(BATCHED_TEST_OFFSETS),
            "frames_per_video": BATCHED_TEST_N,
            "config_overrides": PARITY_OVERRIDES,
            "intervals": intervals}


def golden_parity_gn(n, PARITY_OVERRIDES):
    import time

    from egomotion_with_local_loop_closures_tpu.config import ELLCConfig
    from egomotion_with_local_loop_closures_tpu.runtime import runner

    cfg = ELLCConfig().replace(**PARITY_OVERRIDES)
    frames = np.load(FRAMES)["frames"]
    n = n or len(frames)
    t0 = time.perf_counter()
    res = runner.run_sequence(iter(frames[:n]), cfg)
    seconds = time.perf_counter() - t0
    golden = _common(cfg, FRAMES, n, "egomotion_with_local_loop_closures_tpu"
                     " runner.run_sequence on the CPU, "
                     "tools/make_port_golden.py --parity-gn",
                     PARITY_OVERRIDES)
    golden.update(frame_ids=res.frame_ids.tolist(),
                  kf_ids=res.kf_ids.tolist(),
                  world_poses=np.asarray(res.world_poses,
                                         np.float64).tolist(),
                  seeds=res.seeds.tolist(), rescales=res.rescales.tolist(),
                  seconds=seconds)
    print(f"{len(res.frame_ids)} tracked frames in {seconds:.1f} s")
    return golden


def _ate(world_poses, frame_ids, gt):
    """ATE of the tracked frames (ids 2..) against the ground truth, whose
    row i is frame i + 1."""
    import jax.numpy as jnp
    from egomotion_with_local_loop_closures_tpu.utils import metrics
    ids = np.asarray(frame_ids)
    return float(metrics.ate_rmse(jnp.asarray(world_poses, jnp.float32),
                                  jnp.asarray(gt[ids - 1], jnp.float32)))


def golden_synthetic(PARITY_OVERRIDES):
    import tempfile

    import jax
    import jax.numpy as jnp
    from egomotion_with_local_loop_closures_tpu.config import ELLCConfig
    from egomotion_with_local_loop_closures_tpu.runtime import cli, runner
    from egomotion_with_local_loop_closures_tpu.utils import synthetic

    cfg = ELLCConfig().replace(**PARITY_OVERRIDES)
    scene = synthetic.make_room_scene(seed=0, **SYNTHETIC_SCENE)
    gt = np.asarray(synthetic.trajectory(SYNTHETIC_N, seed=0,
                                         **SYNTHETIC_TRAJ))
    fx, fy, cx, cy = cfg.level_intrinsics(0)
    render = jax.jit(lambda p: synthetic.render(
        scene, p, cfg.rows, cfg.cols, fx, fy, cx, cy)[0])
    frames = [np.asarray(render(jnp.asarray(p))) for p in gt]
    res = runner.run_sequence(iter(frames), cfg)
    full = {"rows": cfg.rows, "cols": cfg.cols,
            "num_input_frames": SYNTHETIC_N,
            "config_overrides": PARITY_OVERRIDES,
            "poses_gt": gt.astype(np.float64).tolist(),
            "frame_ids": res.frame_ids.tolist(),
            "world_poses": np.asarray(res.world_poses, np.float64).tolist(),
            "seeds": res.seeds.tolist(),
            "ate": _ate(res.world_poses, res.frame_ids, gt)}
    print(f"{cfg.rows}x{cfg.cols}, {SYNTHETIC_N} frames: ATE {full['ate']:.5g}"
          f", seeds% min {res.seeds.min():.3f}")
    with tempfile.TemporaryDirectory() as out:
        cli.main(["--synthetic", str(SYNTHETIC_TEST_N), "--out", out,
                  "--platform", "cpu"])
        gt_t = np.loadtxt(os.path.join(out, "poses_gt.txt"))
        orig = np.loadtxt(os.path.join(out, "poses_orig.txt"))
    test = {"argv": ["--synthetic", str(SYNTHETIC_TEST_N)],
            "poses_gt": gt_t.tolist(),
            "frame_ids": orig[:, 0].astype(int).tolist(),
            "world_poses": orig[:, 2:8].tolist(),
            "seeds": orig[:, 9].tolist(),
            "ate": _ate(orig[:, 2:8], orig[:, 0].astype(int), gt_t)}
    print(f"JAX CLI --synthetic {SYNTHETIC_TEST_N}: ATE {test['ate']:.5g}")
    return {"source": "egomotion_with_local_loop_closures_tpu on the CPU: "
                      "utils.synthetic and runner.run_sequence at 480x270, "
                      "runtime.cli --synthetic at 96x128, "
                      "tools/make_port_golden.py --synthetic",
            "scene": dict(seed=0, **SYNTHETIC_SCENE),
            "trajectory": dict(seed=0, **SYNTHETIC_TRAJ),
            "full_width": full, "cli_test": test}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--lc", action="store_true",
                      help="the LC bootstrap golden file instead of GN mode")
    mode.add_argument("--lc-test", action="store_true",
                      help="the 96x128 LC test frames and golden file")
    mode.add_argument("--recovery", action="store_true",
                      help="the 480x270 connection-recovery golden file")
    mode.add_argument("--recovery-test", action="store_true",
                      help="the 96x128 recovery test arrays and golden file")
    mode.add_argument("--batched", action="store_true",
                      help="the 480x270 eight-video golden file")
    mode.add_argument("--batched-test", action="store_true",
                      help="the 96x128 multi-video test arrays and golden "
                           "file")
    mode.add_argument("--parity-gn", action="store_true",
                      help="the JAX package's run over run_gn under the "
                           "parity config")
    mode.add_argument("--synthetic", action="store_true",
                      help="the synthetic-scene golden file")
    ap.add_argument("--frames", type=int, default=None,
                    help="input frames (default 17, or 80 with --lc)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    sys.path.insert(0, ROOT)
    if args.batched_test:
        # one CPU device per video, before jax is imported
        os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") + " "
                                   "--xla_force_host_platform_device_count="
                                   f"{len(BATCHED_TEST_OFFSETS)}").strip()
    import jax
    jax.config.update("jax_platforms", "cpu")
    from egomotion_with_local_loop_closures_tpu_torch.config import (
        PARITY_OVERRIDES)

    if args.lc_test:
        golden = golden_lc_test(PARITY_OVERRIDES)
        out = args.out or LC_TEST_OUT
    elif args.recovery:
        golden = golden_recovery(PARITY_OVERRIDES)
        out = args.out or RECOVERY_OUT
    elif args.recovery_test:
        golden = golden_recovery_test(PARITY_OVERRIDES)
        out = args.out or RECOVERY_TEST_OUT
    elif args.batched:
        golden = golden_batched(PARITY_OVERRIDES)
        out = args.out or BATCHED_OUT
    elif args.batched_test:
        golden = golden_batched_test(PARITY_OVERRIDES)
        out = args.out or BATCHED_TEST_OUT
    elif args.parity_gn:
        golden = golden_parity_gn(args.frames, PARITY_OVERRIDES)
        out = args.out or PARITY_GN_OUT
    elif args.synthetic:
        golden = golden_synthetic(PARITY_OVERRIDES)
        out = args.out or SYNTHETIC_OUT
    elif args.lc:
        golden = golden_lc(args.frames or 80, PARITY_OVERRIDES)
        out = args.out or DEFAULT_LC_OUT
    else:
        golden = golden_gn(args.frames or 17, PARITY_OVERRIDES)
        out = args.out or DEFAULT_OUT
    os.makedirs(os.path.dirname(out), exist_ok=True)
    with open(out, "w") as f:
        json.dump(golden, f, indent=1)
        f.write("\n")
    print(f"wrote {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
