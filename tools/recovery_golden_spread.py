"""How far the port's connection-recovery run lands from the JAX golden
file, run after run.

Runs ``runner.run_sequence`` of the PyTorch port with
``restore_connection`` over the frames that
``tests/data/port_golden_recovery.json`` holds (the first 48 frames of
``reference_build/run_gn`` with frames 40 and 41 flat, written by
``tools/make_port_golden.py --recovery``) several times: on the CPU once
per thread count in ``--threads``, or on a CUDA card ``--runs`` times
(``index_add_`` in ``propagate`` sums in another order each run).  For
each run it prints one JSON line: whether the recoveries, dropped frames
and frame ids equal the golden file's, each recovery's rotation,
translation and seeds% difference, and the world-pose difference at
every keyframe before it (the drift the recovery starts from).

Usage:
  python tools/recovery_golden_spread.py --device cpu --threads 1,4
  python tools/recovery_golden_spread.py --device cuda --runs 5 [--out FILE]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "tests", "data", "port_golden_recovery.json")


def spread(res, golden, K):
    """The differences of one run from the golden file."""
    recs = res.extra["recoveries"]
    same = ([(r["frame_id"], r["matched_kf_id"]) for r in recs]
            == [(r["frame_id"], r["matched_kf_id"])
                for r in golden["recoveries"]])
    attempts = {a["frame_id"]: a for a in golden["attempts"]}
    per = []
    if same:
        for r, g in zip(recs, golden["recoveries"]):
            want = np.asarray(attempts[g["frame_id"]]["pose_wrt_matched"])
            d = np.abs(r["pose_wrt_matched"] - want)
            per.append({"frame_id": r["frame_id"],
                        "rotation": float(d[:3].max()),
                        "translation": float(d[3:].max()),
                        "seeds": float(r["seeds"] - g["seeds"])})
    ids = np.asarray(golden["frame_ids"])
    same_ids = res.frame_ids.tolist() == golden["frame_ids"]
    world = (np.abs(res.world_poses - np.asarray(golden["world_poses"]))
             .max(axis=1) if same_ids else None)
    first = recs[0]["frame_id"] if recs else ids[-1] + 1
    return {
        "same_recoveries": same,
        "same_dropped": (res.extra["dropped_frames"]
                         == golden["dropped_frames"]),
        "same_frame_ids": same_ids,
        "recoveries": per,
        "world_at_keyframes_before": (
            {int(f): float(d) for f, d in zip(ids, world)
             if f % K == 0 and f < first} if same_ids else None),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cpu", "cuda"))
    ap.add_argument("--threads", default="1",
                    help="CPU thread counts, one run each")
    ap.add_argument("--runs", type=int, default=3, help="runs on the card")
    ap.add_argument("--out", help="also write the lines to this file")
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    from egomotion_with_local_loop_closures_tpu_torch.config import (
        ELLCConfig)
    from egomotion_with_local_loop_closures_tpu_torch.runtime import runner

    with open(GOLDEN) as f:
        golden = json.load(f)
    cfg = ELLCConfig().replace(**golden["config_overrides"])
    frames = np.load(os.path.join(ROOT, golden["frames_file"]))["frames"][
        :golden["num_input_frames"]].copy()
    for fid in golden["flat_frame_ids"]:
        frames[fid - 1] = golden["flat_gray"]
    if args.device == "cuda":
        if not torch.cuda.is_available():
            print("recovery_golden_spread: no CUDA device", file=sys.stderr)
            return 2
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        settings = [("cuda", None)] * args.runs
    else:
        settings = [("cpu", int(t)) for t in args.threads.split(",")]
    lines = []
    for i, (device, threads) in enumerate(settings):
        if threads is not None:
            torch.set_num_threads(threads)
        t0 = time.perf_counter()
        res = runner.run_sequence(iter(frames), cfg, device)
        line = {"run": i, "device": device, "threads": threads,
                "seconds": time.perf_counter() - t0,
                **spread(res, golden, cfg.keyframe_interval)}
        if device == "cuda":
            line["gpu"] = subprocess.run(
                ["nvidia-smi", "--query-gpu=name,power.limit",
                 "--format=csv,noheader"], capture_output=True, text=True,
                check=True).stdout.splitlines()[0]
        print(json.dumps(line), flush=True)
        lines.append(line)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write("".join(json.dumps(x) + "\n" for x in lines))
    return 0


if __name__ == "__main__":
    sys.exit(main())
