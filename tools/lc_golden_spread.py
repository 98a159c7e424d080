"""How far the port's LC bootstrap lands from the JAX golden file, and where
its trajectory parts from it.

Runs ``ellc_lc.run_ellc_lc`` of the PyTorch port over the 80-frame LC
bootstrap of ``reference_build/run_lc`` (the run that
``tests/data/port_golden_run_lc.json`` holds, written by
``tools/make_port_golden.py --lc``) several times: on the CPU once per
thread count in ``--threads`` (each count sums in its own order), or on a
CUDA card ``--runs`` times (the same bits each run since propagate's
merge and the Sim(3) sums run in a fixed order; before, float atomic
adds summed in a different order each run).  For each run it prints one JSON line with the largest edge
rotation, corrected-pose and KL differences from the golden file, the
raw (pre-averaging) world-pose difference at every keyframe, the first
frames where that difference passes 1e-4 and 1e-3, and each edge's
rotation difference beside its frame id.

Usage:
  python tools/lc_golden_spread.py --device cpu --threads 1,2,4,8
  python tools/lc_golden_spread.py --device cuda --runs 4 [--out FILE]
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
GOLDEN = os.path.join(ROOT, "tests", "data", "port_golden_run_lc.json")


def first_frame_over(frame_ids, diff, limit):
    over = np.nonzero(diff > limit)[0]
    return int(frame_ids[over[0]]) if len(over) else None


def spread(res, golden, K):
    """The differences of one run from the golden file."""
    ids = np.asarray(golden["frame_ids"])
    raw = np.abs(res.raw_world_poses
                 - np.asarray(golden["raw_world_poses"])).max(axis=1)
    cor = np.abs(res.world_poses - np.asarray(golden["world_poses"]))
    pairs = [(int(e.frame_id), int(e.matched_kf_id)) for e in res.loop_edges]
    g_edges = golden["edges"]
    same = pairs == [(e["frame_id"], e["matched_kf_id"]) for e in g_edges]
    edges = []
    if same:
        edges = [[int(e.frame_id), float(np.abs(
            np.asarray(e.pose_wrt_matched[:3])
            - np.asarray(g["pose_wrt_matched"][:3])).max())]
            for e, g in zip(res.loop_edges, g_edges)]
    return {
        "same_edge_pairs": same,
        "max_edge_rotation": max((d for _, d in edges), default=None),
        "max_corrected_pose": float(cor.max()),
        "max_kl": (max(abs(e.match_value - g["match_value"])
                       for e, g in zip(res.loop_edges, g_edges))
                   if same else None),
        "raw_at_keyframes": {int(f): float(d) for f, d in zip(ids, raw)
                             if f % K == 0},
        "first_raw_over_1e-4": first_frame_over(ids, raw, 1e-4),
        "first_raw_over_1e-3": first_frame_over(ids, raw, 1e-3),
        "edge_rotation_by_frame": edges,
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
    from egomotion_with_local_loop_closures_tpu_torch.runtime import ellc_lc

    with open(GOLDEN) as f:
        golden = json.load(f)
    cfg = ELLCConfig().replace(**golden["config_overrides"])
    frames = np.load(os.path.join(ROOT, golden["frames_file"]))["frames"]
    n = golden["num_input_frames"]
    if args.device == "cuda":
        if not torch.cuda.is_available():
            print("lc_golden_spread: no CUDA device", file=sys.stderr)
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
        res = ellc_lc.run_ellc_lc(iter(frames[:n]), cfg, device,
                                  max_frames=golden["max_frames"])
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
