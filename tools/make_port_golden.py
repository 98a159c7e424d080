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

``chip_smoke.py`` and the port's tests compare the port's runs with these
files.

Usage: python tools/make_port_golden.py [--lc | --lc-test] [--frames N]
       [--out PATH]
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
    res = ellc_lc.run_ellc_lc(iter(frames), cfg, max_frames=n)
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
        edges=_edges(edges))
    ours = {(int(e.frame_id), int(e.matched_kf_id)) for e in edges}
    ref = {(int(r[0]), int(r[1]))
           for r in np.atleast_2d(np.loadtxt(LC_EDGES))}
    print(f"{len(res.frame_ids)} corrected poses, {res.num_batches} batch(es),"
          f" {len(edges)} loop edges; pairs in common with the binary's "
          f"{os.path.relpath(LC_EDGES, ROOT)}: {len(ours & ref)} of "
          f"{len(ref)} (only the binary's: {sorted(ref - ours)}, only "
          f"these: {sorted(ours - ref)})")
    return golden


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--lc", action="store_true",
                      help="the LC bootstrap golden file instead of GN mode")
    mode.add_argument("--lc-test", action="store_true",
                      help="the 96x128 LC test frames and golden file")
    ap.add_argument("--frames", type=int, default=None,
                    help="input frames (default 17, or 80 with --lc)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    sys.path.insert(0, ROOT)
    import jax
    jax.config.update("jax_platforms", "cpu")
    from egomotion_with_local_loop_closures_tpu_torch.config import (
        PARITY_OVERRIDES)

    if args.lc_test:
        golden = golden_lc_test(PARITY_OVERRIDES)
        out = args.out or LC_TEST_OUT
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
