"""How far the port's run of one video of ``chip_smoke.py``'s phase 9
lands from the JAX package's run of it, run after run.

Runs the PyTorch port's single-video path, ``pipeline.init_pipeline`` and
four ``pipeline.process_interval`` calls (7, 8, 8 and 8 frames), on video
``--video`` of ``tests/data/port_golden_batched_run_gn.json`` (frames
64v..64v+31 of ``reference_build/run_gn`` at 480x270 under the parity
config, written by ``tools/make_port_golden.py --batched``) several
times: on the CPU once per thread count in ``--threads``, or on a CUDA
card ``--runs`` times (the same bits each run since propagate's merge
sums in a fixed order; before, its ``index_add_`` summed in another
order each run).  ``--perturb EPS --draws N`` makes N more runs of each
setting on frames with seeded uniform noise in [-EPS, EPS] grey levels
added, and ``--package jax`` runs the JAX package's own single-video path
on the CPU instead of the port's, so the JAX package's spread on these
frames can be measured the same way.  For each run it prints one JSON
line: the largest world-pose difference from the golden file and from the
first run over each interval, and the seeds% of the run and of the golden
file at each interval's end.

Usage:
  python tools/batched_golden_spread.py --device cpu --threads 1,2,4,8
  python tools/batched_golden_spread.py --device cuda --runs 3 [--out FILE]
  python tools/batched_golden_spread.py --package jax --perturb 0.01 \
      --draws 3
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
GOLDEN = os.path.join(ROOT, "tests", "data",
                      "port_golden_batched_run_gn.json")


def run_video_jax(frames, intervals, overrides, video):
    """The JAX package's single-video path over ``frames`` on the CPU, as
    ``tools/make_port_golden.py --batched`` runs it."""
    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    from egomotion_with_local_loop_closures_tpu.config import (
        ELLCConfig as JaxConfig)
    from egomotion_with_local_loop_closures_tpu.runtime import pipeline
    cfg = JaxConfig().replace(**overrides)
    state = pipeline.init_pipeline(jnp.asarray(frames[0]),
                                   jax.random.PRNGKey(video), cfg)
    poses, seeds, start = [], [], 1
    for n in intervals:
        state, out, _ = pipeline.process_interval(
            state, jnp.asarray(frames[start:start + n]), cfg)
        poses.append(np.asarray(out.pose_wrt_world, np.float64))
        seeds.append(np.asarray(out.seeds, np.float64))
        start += n
    return np.concatenate(poses), np.concatenate(seeds)


def run_video(frames, intervals, cfg, device):
    """The port's single-video path over ``frames``: (poses (N, 6), seeds
    (N,)) of the tracked frames."""
    import torch

    from egomotion_with_local_loop_closures_tpu_torch.runtime import pipeline
    state = pipeline.init_pipeline(frames[0], cfg, device)
    poses, seeds, start = [], [], 1
    for n in intervals:
        state, out, _ = pipeline.process_interval(
            state, list(frames[start:start + n]), cfg)
        poses.append(out.pose_wrt_world)
        seeds.append(out.seeds)
        start += n
    return (torch.cat(poses).cpu().numpy().astype(np.float64),
            torch.cat(seeds).cpu().numpy().astype(np.float64))


def spread(poses, seeds, video, intervals, first_poses):
    """Per interval: the largest |pose component difference| from the
    golden video and from the first run, and both seeds% at the
    interval's end."""
    g_pose = np.asarray(video["pose_wrt_world"])
    g_seeds = np.asarray(video["seeds"])
    ends = np.cumsum(intervals)
    starts = ends - np.asarray(intervals)
    return {
        "pose_gap": [float(np.abs(poses[a:b] - g_pose[a:b]).max())
                     for a, b in zip(starts, ends)],
        "pose_gap_to_first_run": [
            float(np.abs(poses[a:b] - first_poses[a:b]).max())
            for a, b in zip(starts, ends)],
        "seeds_at_ends": [float(seeds[b - 1]) for b in ends],
        "golden_seeds_at_ends": [float(g_seeds[b - 1]) for b in ends],
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--video", type=int, default=6)
    ap.add_argument("--device", default="cuda", choices=("cpu", "cuda"))
    ap.add_argument("--threads", default="1",
                    help="CPU thread counts, one run each")
    ap.add_argument("--runs", type=int, default=3, help="runs on the card")
    ap.add_argument("--package", default="port", choices=("port", "jax"),
                    help="whose single-video path to run (jax: on the CPU)")
    ap.add_argument("--perturb", type=float, default=0.0,
                    help="amplitude of the uniform noise of the extra runs")
    ap.add_argument("--draws", type=int, default=0,
                    help="extra runs of each setting on perturbed frames")
    ap.add_argument("--out", help="also write the lines to this file")
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    from egomotion_with_local_loop_closures_tpu_torch.config import (
        ELLCConfig)

    with open(GOLDEN) as f:
        golden = json.load(f)
    cfg = ELLCConfig().replace(**golden["config_overrides"])
    intervals = golden["intervals"]
    first = golden["stride"] * args.video
    frames = np.load(os.path.join(ROOT, golden["frames_file"]))["frames"][
        first:first + 1 + sum(intervals)].astype(np.float32)
    if args.package == "jax":
        settings = [("cpu", None)]
    elif args.device == "cuda":
        if not torch.cuda.is_available():
            print("batched_golden_spread: no CUDA device", file=sys.stderr)
            return 2
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        settings = [("cuda", None)] * args.runs
    else:
        settings = [("cpu", int(t)) for t in args.threads.split(",")]
    runs = [(d, t, draw) for d, t in settings
            for draw in [None] + list(range(1, args.draws + 1))]
    lines, first_poses = [], None
    for i, (device, threads, draw) in enumerate(runs):
        f = frames
        if draw is not None:
            noise = np.random.default_rng(draw).uniform(
                -args.perturb, args.perturb, frames.shape)
            f = (frames + noise).astype(np.float32)
        if threads is not None:
            torch.set_num_threads(threads)
        t0 = time.perf_counter()
        if args.package == "jax":
            poses, seeds = run_video_jax(f, intervals,
                                         golden["config_overrides"],
                                         args.video)
        else:
            poses, seeds = run_video(f, intervals, cfg, device)
        if first_poses is None:
            first_poses = poses
        line = {"run": i, "package": args.package, "video": args.video,
                "frames": f"{first}..{first + sum(intervals)}",
                "device": device, "threads": threads,
                "perturb": args.perturb if draw is not None else 0.0,
                "draw": draw, "seconds": time.perf_counter() - t0,
                **spread(poses, seeds, golden["videos"][args.video],
                         intervals, first_poses)}
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
