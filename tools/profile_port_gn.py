"""Where the PyTorch port's GN main path spends its time on a CUDA card.

Runs ``runner.run_sequence`` over the first frames of
``reference_build/run_gn/frames_480x270.npz`` (480x270, parity config)
twice after a warm-up:

1. with each stage of the frame loop wrapped in ``torch.cuda.synchronize()``
   and a host clock (align, stereo.observe, K3, keyframe propagation,
   depth-pyramid refresh): per-stage wall time per tracked frame;
2. under ``torch.profiler`` without the synchronizing wrappers: the
   device's busy time (sum of kernel times) against the wall time, and the
   kernels that took most of it.

Usage (on the card): python tools/profile_port_gn.py [--frames N] [--out F]
Writes the report as JSON to F (default profile_port_gn.json) and prints it.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=41)
    ap.add_argument("--out", default="profile_port_gn.json")
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("profile_port_gn: needs a CUDA card", file=sys.stderr)
        return 2
    from egomotion_with_local_loop_closures_tpu_torch.config import (
        ELLCConfig, PARITY_OVERRIDES)
    from egomotion_with_local_loop_closures_tpu_torch.depth import (
        propagate, stereo)
    from egomotion_with_local_loop_closures_tpu_torch.ops import reg_kernel
    from egomotion_with_local_loop_closures_tpu_torch.runtime import (
        pipeline, runner)
    from egomotion_with_local_loop_closures_tpu_torch.track import alignment

    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    cfg = ELLCConfig().replace(**PARITY_OVERRIDES)
    frames = np.load(os.path.join(ROOT, "reference_build", "run_gn",
                                  "frames_480x270.npz"))["frames"]
    frames = frames[:args.frames]
    dev = torch.device("cuda")
    runner.run_sequence(iter(frames[:9]), cfg, dev)          # warm-up

    # 1. per-stage host time, each stage ended by a synchronize
    stages = collections.defaultdict(float)
    wrapped = [(alignment, "align"), (stereo, "observe"),
               (reg_kernel, "do_regularization"), (reg_kernel, "regularize"),
               (propagate, "propagate"), (pipeline, "_refresh_kf_depth")]
    originals = [(mod, name, getattr(mod, name)) for mod, name in wrapped]

    def timed(name, fn):
        def inner(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            stages[name] += time.perf_counter() - t0
            return out
        return inner

    for mod, name, fn in originals:
        setattr(mod, name, timed(name, fn))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = runner.run_sequence(iter(frames), cfg, dev)
    torch.cuda.synchronize()
    wall_sync = time.perf_counter() - t0
    for mod, name, fn in originals:
        setattr(mod, name, fn)
    n = len(res.frame_ids)

    # 2. device busy share under the profiler, no synchronizing wrappers
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        runner.run_sequence(iter(frames), cfg, dev)
        torch.cuda.synchronize()
        wall_prof = time.perf_counter() - t0
    # device-side events only (kernels, copies, sets): no double counting
    # with the host-side ops that launched them
    from torch.autograd import DeviceType
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA]
    if not events:
        print("profile_port_gn: the profiler recorded no device time",
              file=sys.stderr)
        return 1
    busy_us = sum(e.device_time_total for e in events)
    top = sorted(events, key=lambda e: -e.device_time_total)[:12]
    launches = sum(e.count for e in events)

    report = {
        "gpu": gpu, "frames_tracked": n,
        "stage_ms_per_frame": {k: 1e3 * v / n for k, v in stages.items()},
        "wall_ms_per_frame_with_stage_syncs": 1e3 * wall_sync / n,
        "wall_ms_per_frame_profiled": 1e3 * wall_prof / n,
        "device_busy_ms_per_frame": busy_us / 1e3 / n,
        "device_busy_share": busy_us / 1e6 / wall_prof,
        "device_kernel_launches_per_frame": launches / n,
        "top_device_ops": [{"name": e.key[:90],
                            "ms_per_frame": e.device_time_total / 1e3 / n,
                            "calls_per_frame": e.count / n} for e in top],
    }
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps(report, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
