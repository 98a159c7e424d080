"""LC mode's rate, its Sim(3) refinement's time and the batched videos'
aggregate rate of the port, in one process, for the package of a given
checkout: run it once for each of two checkouts, in turns, in one call on
one card, to compare them.

Measures what ``chip_smoke.py``'s phases 6, 7 and 9 measure once each:

- the Sim(3) refinement of the LC golden file's inputs
  (``ellc_lc._sim3_refine_trajectory``, phase 6), ``--sim3-reps`` times
  after one untimed refinement, host clock with the card synchronized;
- LC mode over 144 frames of ``reference_build/run_lc``
  (``ellc_lc.run_ellc_lc``, phase 7), ``--lc-reps`` times, after the
  80-frame LC bootstrap with the Sim(3) refinement as a warm-up (so the
  kernels are built and the step graphs captured, as in chip_smoke);
  corrected poses a second, and each run's phases (s);
- 8 videos of ``reference_build/run_gn`` through
  ``sharded.batched_init`` and four ``batched_process_interval`` calls
  (31 frames a video, phase 9), ``--video-reps`` times, the video axis's
  graphs released before each run so the captures count, as in phase 9;
  aggregate tracked frames a second.

The data comes from this checkout; the package timed is ``--root``'s
(default: this checkout).  Prints one JSON line, with the package's path,
and the card's name and power limit (nvidia-smi).

Usage, from the root of a checkout, with a second checkout in DIR:

  for r in DIR . . DIR; do python3 tools/rate_turns.py --root $r; done

``--device cpu --lc-frames 12 --videos 2`` runs a short version on the
CPU (a check of the script, not a measurement).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
import types

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = "egomotion_with_local_loop_closures_tpu_torch"
FRAMES = os.path.join(ROOT, "reference_build", "run_gn", "frames_480x270.npz")
LC_GOLDEN = os.path.join(ROOT, "tests", "data", "port_golden_run_lc.json")
# chip_smoke.py's phases 7 and 9
LC_FRAMES = 144
BATCH_STRIDE, BATCH_INTERVALS = 64, (7, 8, 8, 8)


def card_name() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.TimeoutExpired):
        return "no nvidia-smi"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=ROOT,
                    help="checkout whose package is timed")
    ap.add_argument("--label", default=None)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--sim3-reps", type=int, default=5)
    ap.add_argument("--lc-reps", type=int, default=2)
    ap.add_argument("--lc-frames", type=int, default=LC_FRAMES)
    ap.add_argument("--video-reps", type=int, default=5)
    ap.add_argument("--videos", type=int, default=8)
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch

    mod = __import__(PKG)
    if not os.path.abspath(mod.__file__).startswith(root + os.sep):
        raise SystemExit(f"{PKG} came from {mod.__file__}, not {root}")
    from egomotion_with_local_loop_closures_tpu_torch.config import (
        ELLCConfig, PARITY_OVERRIDES)
    from egomotion_with_local_loop_closures_tpu_torch.parallel import sharded
    from egomotion_with_local_loop_closures_tpu_torch.runtime import (
        ellc_lc, graphs)
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA card")

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    with open(LC_GOLDEN) as f:
        lc_golden = json.load(f)
    lc_cfg = ELLCConfig().replace(**lc_golden["config_overrides"])
    lc_frames = np.load(os.path.join(ROOT, lc_golden["frames_file"]))[
        "frames"]
    sim3_cfg = lc_cfg.replace(do_sim3_refine=True)

    # warm-up: phase 6's bootstrap with the Sim(3) refinement
    n_boot = min(lc_golden["num_input_frames"], args.lc_frames)
    ellc_lc.run_ellc_lc(iter(lc_frames[:n_boot]), sim3_cfg, dev,
                        max_frames=lc_golden["max_frames"])

    def refine():
        return ellc_lc._sim3_refine_trajectory(
            np.asarray(lc_golden["frame_ids"]),
            np.asarray(lc_golden["world_poses"], np.float32),
            [types.SimpleNamespace(**e) for e in lc_golden["edges"]],
            sim3_cfg, dev)

    first = refine()
    sim3_s, same = [], True
    for _ in range(args.sim3_reps):
        sync()
        t0 = time.perf_counter()
        nodes = refine()
        sync()
        sim3_s.append(time.perf_counter() - t0)
        same = same and bool(np.array_equal(nodes, first))

    lc_fps, lc_phases = [], []
    for _ in range(args.lc_reps):
        stats = {}
        sync()
        t0 = time.perf_counter()
        res = ellc_lc.run_ellc_lc(iter(lc_frames[:args.lc_frames]), lc_cfg,
                                  dev, stats=stats)
        sync()
        lc_fps.append(len(res.frame_ids) / (time.perf_counter() - t0))
        lc_phases.append({k: round(v, 4) for k, v in stats.items()})

    cfg = ELLCConfig().replace(**PARITY_OVERRIDES)
    frames = np.load(FRAMES)["frames"]
    n_per = 1 + sum(BATCH_INTERVALS)
    V = args.videos
    vids = np.stack([frames[BATCH_STRIDE * v:BATCH_STRIDE * v + n_per]
                     for v in range(V)])
    video_fps = []
    for _ in range(args.video_reps):
        graphs.release((V,))
        sync()
        t0 = time.perf_counter()
        states = sharded.batched_init(vids[:, 0], cfg, dev)
        start = 1
        for n in BATCH_INTERVALS:
            states, _ = sharded.batched_process_interval(
                states, vids[:, start:start + n], cfg)
            start += n
        sync()
        video_fps.append(V * (n_per - 1) / (time.perf_counter() - t0))
        del states
    graphs.release((V,))

    print(json.dumps({
        "label": args.label or root, "package": os.path.dirname(mod.__file__),
        "device": str(dev), "card": card_name(),
        "sim3_s": sim3_s, "sim3_reps_bit_equal": same,
        "lc_frames": args.lc_frames, "lc_fps": lc_fps,
        "lc_phases": lc_phases, "videos": V, "video_fps": video_fps}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
