"""Command-line entry point of the PyTorch port.

Usage:
    python -m egomotion_with_local_loop_closures_tpu_torch.runtime.cli \
        (--frames <image_dir> | --video <file> [--skip N] | --synthetic N) \
        --out <out_dir> [--lc] [--max-frames N] [--device cuda] [--seed S] \
        [--glibc-init] [--rows R --cols C --fx FX --fy FY]

Port of ``egomotion_with_local_loop_closures_tpu/runtime/cli.py``: the
default mode tracks the frames in GN mode and writes ``poses_orig.txt``
and ``matchframes.txt``; ``--lc`` runs the alternating GN /
rotation-averaging mode and writes ``poses_corrected.txt``, all in the
reference formats.  The frames come from a directory of images, a video
decoded like the reference's (resize by 1/4, BGR -> gray; ``--skip``
fast-forwards), or ``--synthetic N`` frames rendered on the device from
the JAX CLI's room scene and random-walk trajectory, whose ground truth
goes to ``poses_gt.txt`` (96x128 unless ``--rows``/``--cols`` are given).
For files the camera model follows the decoded frame size unless
``--rows``/``--cols`` pin it.  ``--glibc-init`` starts the depth map from
the reference's glibc ``rand()`` draws (``bootstrap_rng="glibc"``, the
parity configuration's) instead of a torch generator seeded by
``--seed``.
"""

from __future__ import annotations

import argparse
import itertools
import os
import sys
import time


# the JAX CLI's synthetic sequence: its camera when --rows is not given,
# its room and its trajectory (runtime/cli.py:75-80)
SYNTHETIC_CAMERA = dict(rows=96, cols=128, fx=110.0, fy=110.0, cx=64.0,
                        cy=48.0)
SYNTHETIC_SCENE = dict(depth=1.25, half_width=1.7, half_height=1.15)
SYNTHETIC_TRAJECTORY = dict(rot_step=0.0015, trans_step=0.02)


def synthetic_frames(n: int, cfg, seed: int, device, out_dir: str):
    """``n`` frames of the synthetic room rendered on ``device`` in one
    batched pass, as an iterator of (H, W) tensors; the ground-truth
    poses go to ``out_dir/poses_gt.txt``."""
    import numpy as np
    import torch

    from egomotion_with_local_loop_closures_tpu_torch.utils import synthetic
    scene = synthetic.make_room_scene(seed=seed, **SYNTHETIC_SCENE)
    gt = synthetic.trajectory(n, seed=seed, **SYNTHETIC_TRAJECTORY)
    np.savetxt(os.path.join(out_dir, "poses_gt.txt"), gt.numpy(), fmt="%.9g")
    fx, fy, cx, cy = cfg.level_intrinsics(0)
    images, _ = synthetic.render_sequence(
        scene, gt.to(torch.device(device)), cfg.rows, cfg.cols, fx, fy, cx,
        cy)
    return iter(images.unbind(0))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="ELLC sequence runner (PyTorch port)")
    src_arg = ap.add_mutually_exclusive_group(required=True)
    src_arg.add_argument("--frames", help="directory of image frames")
    src_arg.add_argument("--video", help="video file (decoded like the "
                         "reference: resize 1/4, BGR->gray)")
    src_arg.add_argument("--synthetic", type=int,
                         help="render N synthetic frames instead of reading "
                              "files")
    ap.add_argument("--skip", type=int, default=0,
                    help="with --video: fast-forward N frames before "
                         "tracking (the reference's BATCH_START_ID skip)")
    ap.add_argument("--out", required=True, help="output directory")
    ap.add_argument("--max-frames", type=int, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--rows", type=int, default=None)
    ap.add_argument("--cols", type=int, default=None)
    ap.add_argument("--fx", type=float, default=None)
    ap.add_argument("--fy", type=float, default=None)
    ap.add_argument("--lc", action="store_true",
                    help="alternating GN/rotation-averaging mode "
                         "(the reference's 'ELLC LC' + MATLAB loop)")
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default: cuda)")
    ap.add_argument("--glibc-init", action="store_true",
                    help="bootstrap the depth map from glibc rand() draws, "
                         "as the reference does (bootstrap_rng='glibc')")
    args = ap.parse_args(argv)

    from egomotion_with_local_loop_closures_tpu_torch.config import ELLCConfig
    from egomotion_with_local_loop_closures_tpu_torch.runtime import (
        ellc_lc, io as ellc_io, runner)

    cfg = ELLCConfig()
    overrides = {}
    if args.rows:
        overrides.update(rows=args.rows, cy=args.rows / 2.0)
    if args.cols:
        overrides.update(cols=args.cols, cx=args.cols / 2.0)
    if args.fx:
        overrides["fx"] = args.fx
    if args.fy:
        overrides["fy"] = args.fy
    if overrides:
        cfg = cfg.replace(**overrides)

    if args.glibc_init:
        cfg = cfg.replace(bootstrap_rng="glibc")
    os.makedirs(args.out, exist_ok=True)
    if args.synthetic:
        if not args.rows:
            cfg = cfg.replace(**SYNTHETIC_CAMERA)
        frames = synthetic_frames(args.synthetic, cfg, args.seed,
                                  args.device, args.out)
    else:
        src = (ellc_io.video_frames(args.video, skip=args.skip)
               if args.video else ellc_io.image_dir_frames(args.frames))
        first = next(src, None)
        if first is None:
            ap.error(f"no frames in {args.video or args.frames}")
        # the camera model follows the decoded frame size unless pinned
        h, w = first.shape[:2]
        fixes = {}
        if not args.rows and cfg.rows != h:
            fixes.update(rows=h, cy=h / 2.0)
        if not args.cols and cfg.cols != w:
            fixes.update(cols=w, cx=w / 2.0)
        if fixes:
            cfg = cfg.replace(**fixes)
            print(f"camera model set to decoded frame size {h}x{w}")
        frames = itertools.chain([first], src)

    t0 = time.perf_counter()
    if args.lc:
        result = ellc_lc.run_ellc_lc(frames, cfg, args.device,
                                     out_dir=args.out, seed=args.seed,
                                     max_frames=args.max_frames)
        dt = time.perf_counter() - t0
        n = len(result.frame_ids)
        print(f"LC mode: {n} corrected poses, {result.num_batches} batches, "
              f"{result.num_loop_edges} loop edges in {dt:.2f}s "
              f"({n / max(dt, 1e-9):.2f} fps) on {args.device}")
    else:
        result = runner.run_sequence(frames, cfg, args.device,
                                     out_dir=args.out, seed=args.seed,
                                     max_frames=args.max_frames)
        dt = time.perf_counter() - t0
        n = len(result.frame_ids)
        print(f"tracked {n} frames in {dt:.2f}s ({n / max(dt, 1e-9):.2f} "
              f"fps) on {args.device}")
    print(f"outputs written to {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
