"""Command-line entry point of the PyTorch port.

Usage:
    python -m egomotion_with_local_loop_closures_tpu_torch.runtime.cli \
        --frames <image_dir> --out <out_dir> [--lc] [--max-frames N] \
        [--device cuda] [--seed S] [--rows R --cols C --fx FX --fy FY]

Port of ``egomotion_with_local_loop_closures_tpu/runtime/cli.py`` for
image directories: the default mode tracks the frames in GN mode and
writes ``poses_orig.txt`` and ``matchframes.txt``; ``--lc`` runs the
alternating GN / rotation-averaging mode and writes
``poses_corrected.txt``, all in the reference formats.  The camera model
follows the decoded frame size unless ``--rows``/``--cols`` pin it.
"""

from __future__ import annotations

import argparse
import itertools
import os
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="ELLC sequence runner (PyTorch port)")
    ap.add_argument("--frames", required=True,
                    help="directory of image frames")
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

    src = ellc_io.image_dir_frames(args.frames)
    first = next(src, None)
    if first is None:
        ap.error(f"no image frames in {args.frames}")
    h, w = first.shape[:2]
    fixes = {}
    if not args.rows and cfg.rows != h:
        fixes.update(rows=h, cy=h / 2.0)
    if not args.cols and cfg.cols != w:
        fixes.update(cols=w, cx=w / 2.0)
    if fixes:
        cfg = cfg.replace(**fixes)
        print(f"camera model set to decoded frame size {h}x{w}")

    os.makedirs(args.out, exist_ok=True)
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
