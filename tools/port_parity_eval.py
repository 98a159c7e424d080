"""The PyTorch port's accuracy against the reference binary on ``run_gn``,
beside the JAX package's under the same configuration.

Runs the port's ``runner.run_sequence`` over
``reference_build/run_gn/frames_480x270.npz`` at 480x270 under the parity
config (exact warps, dense stereo, float samples, the glibc bootstrap) on
``--device`` (the card by default) and scores it against the binary's
``reference_build/run_gn/outputs/poses_orig.txt`` with the port's
``utils/metrics.py``:

* RPE-8f and RPE-40f: the rotation error of the relative pose over
  windows of one and five keyframe intervals (mean, median, p95, max in
  degrees), which factors out the drift of the bootstrap;
* ATE: the RMSE of camera centres after a similarity (Umeyama) alignment;
* the rotation error of the whole trajectory (CompareRotations.m);
* seeds%: the mean depth-map occupancy of each run over the window.

Each run is scored over the window where both it and the binary track
(seeds > 0 and a finite rescale), and both runs again over the window
where all three track ("common_window").  The JAX package's run under
the same config is read from ``tests/data/port_golden_parity_gn.json``
(``tools/make_port_golden.py --parity-gn``, ~11 minutes on a CPU).  The
``--out`` file also holds the port's tracked poses and seeds%.  This tool
imports neither jax nor the JAX package.

Usage:
  python tools/port_parity_eval.py [--device cuda] [--frames N]
                                   [--out FILE]
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
RUN_DIR = os.path.join(ROOT, "reference_build", "run_gn")
FRAMES = os.path.join(RUN_DIR, "frames_480x270.npz")
REFERENCE = os.path.join(RUN_DIR, "outputs", "poses_orig.txt")
JAX_GOLDEN = os.path.join(ROOT, "tests", "data", "port_golden_parity_gn.json")


def load_reference(path: str = REFERENCE):
    """poses_orig.txt rows: frameId kfId wx wy wz vx vy vz rescale seeds
    (main.cpp:361-384); "-nan" reads as NaN."""
    a = np.loadtxt(path, ndmin=2, converters=lambda s: float(
        s.replace(b"-nan", b"nan") if isinstance(s, bytes)
        else s.replace("-nan", "nan")))
    return {"frame_id": a[:, 0].astype(int), "pose": a[:, 2:8],
            "rescale": a[:, 8], "seeds": a[:, 9]}


def rotmats(poses6: np.ndarray) -> np.ndarray:
    """Rotation blocks (N, 3, 3) of world->camera twists, float64."""
    import torch

    from egomotion_with_local_loop_closures_tpu_torch.geom import lie
    T = lie.exp_se3(torch.as_tensor(np.asarray(poses6, np.float32)))
    return T[..., :3, :3].numpy().astype(np.float64)


def angle_deg(Ra: np.ndarray, Rb: np.ndarray) -> np.ndarray:
    """Geodesic angle between rotation arrays (N, 3, 3), degrees."""
    tr = np.einsum("nij,nij->n", Ra, Rb)
    return np.degrees(np.arccos(np.clip((tr - 1.0) / 2.0, -1.0, 1.0)))


def rpe_rotation(Ra: np.ndarray, Rb: np.ndarray, L: int) -> np.ndarray:
    """Relative-pose rotation error over windows of L frames:
    angle(Ra_i^T Ra_{i+L}, Rb_i^T Rb_{i+L})."""
    dRa = np.einsum("nji,njk->nik", Ra[:-L], Ra[L:])
    dRb = np.einsum("nji,njk->nik", Rb[:-L], Rb[L:])
    return angle_deg(dRa, dRb)


def score(ref, frame_ids, world_poses, seeds, K: int = 8,
          last_frame: int | None = None) -> dict:
    """Scores of one run (tracked frame ids, world poses, seeds%) against
    the binary's, over the frames where both track, up to ``last_frame``
    when it is given."""
    import torch

    from egomotion_with_local_loop_closures_tpu_torch.utils import metrics
    frame_ids = np.asarray(frame_ids)
    world_poses = np.asarray(world_poses, np.float64)
    seeds = np.asarray(seeds, np.float64)
    ok = np.isfinite(ref["rescale"]) & (ref["seeds"] > 0)
    ref_last = int(ref["frame_id"][ok].max()) if ok.any() else 0
    ours_last = (int(frame_ids[seeds > 0].max()) if (seeds > 0).any()
                 else 0)
    until = min(ref_last, ours_last, last_frame or ours_last)
    common = sorted(f for f in set(ref["frame_id"].tolist())
                    & set(frame_ids.tolist()) if f <= until)
    out = {"reference_tracks_until": ref_last, "run_tracks_until": ours_last,
           "compared_until": until, "frames_compared": len(common)}
    if len(common) < 3:
        return out
    ri = {f: k for k, f in enumerate(ref["frame_id"])}
    oi = {f: k for k, f in enumerate(frame_ids)}
    idx_r = np.asarray([ri[f] for f in common])
    idx_o = np.asarray([oi[f] for f in common])
    pose_r, pose_o = ref["pose"][idx_r], world_poses[idx_o]
    Rr, Ro = rotmats(pose_r), rotmats(pose_o)
    out["rotation"] = {k: float(v) for k, v in metrics.compare_rotations(
        torch.as_tensor(Rr, dtype=torch.float32),
        torch.as_tensor(Ro, dtype=torch.float32)).items()}
    out["ate"] = float(metrics.ate_rmse(torch.as_tensor(pose_o),
                                        torch.as_tensor(pose_r)))
    for L in (K, 5 * K):
        if len(common) > L:
            e = rpe_rotation(Rr, Ro, L)
            out[f"rpe_{L}f"] = {"mean_deg": float(e.mean()),
                                "median_deg": float(np.median(e)),
                                "p95_deg": float(np.percentile(e, 95)),
                                "max_deg": float(e.max())}
    out["seeds_mean"] = float(np.mean(seeds[idx_o]))
    out["seeds_reference_mean"] = float(np.nanmean(ref["seeds"][idx_r]))
    return out


def jax_scores(ref, n_frames: int, K: int = 8) -> dict:
    """The JAX package's parity-config run (the golden file) scored over
    its tracked frames up to frame ``n_frames``."""
    with open(JAX_GOLDEN) as f:
        g = json.load(f)
    return score(ref, g["frame_ids"], g["world_poses"], g["seeds"], K,
                 last_frame=n_frames)


def report(ref, frame_ids, world_poses, seeds, n_frames: int, K: int = 8
           ) -> dict:
    """The port run's scores and the JAX package's, each over its own
    window, then both over the window where all three track."""
    port = score(ref, frame_ids, world_poses, seeds, K, last_frame=n_frames)
    jax = jax_scores(ref, n_frames, K)
    until = min(port["compared_until"], jax["compared_until"])
    return {"port": port, "jax_package": jax, "common_window": {
        "until": until,
        "port": score(ref, frame_ids, world_poses, seeds, K,
                      last_frame=until),
        "jax_package": jax_scores(ref, until, K)}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--frames", type=int, default=None,
                    help="input frames (default: all 520)")
    ap.add_argument("--out", help="also write the JSON to this file")
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    from egomotion_with_local_loop_closures_tpu_torch.config import (
        ELLCConfig, PARITY_OVERRIDES)
    from egomotion_with_local_loop_closures_tpu_torch.runtime import runner

    if args.device.startswith("cuda"):
        if not torch.cuda.is_available():
            print("port_parity_eval: no CUDA device", file=sys.stderr)
            return 2
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    cfg = ELLCConfig().replace(**PARITY_OVERRIDES)
    frames = np.load(FRAMES)["frames"]
    n = args.frames or len(frames)
    ref = load_reference()
    t0 = time.perf_counter()
    res = runner.run_sequence(iter(frames[:n]), cfg, args.device)
    wall = time.perf_counter() - t0
    out = {"device": args.device, "input_frames": n,
           "tracked_frames": len(res.frame_ids), "seconds": wall,
           **report(ref, res.frame_ids, res.world_poses, res.seeds, n,
                    cfg.keyframe_interval)}
    if args.device.startswith("cuda"):
        out["gpu"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.splitlines()[0]
    print(json.dumps(out, indent=1))
    if args.out:
        out["port_run"] = {"frame_ids": res.frame_ids.tolist(),
                           "world_poses": np.asarray(
                               res.world_poses, np.float64).tolist(),
                           "seeds": np.asarray(res.seeds,
                                               np.float64).tolist()}
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
            f.write("\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
