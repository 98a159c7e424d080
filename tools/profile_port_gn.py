"""Where the PyTorch port's GN main path spends its time on a CUDA card.

Runs ``runner.run_sequence`` over the first frames of
``reference_build/run_gn/frames_480x270.npz`` (480x270, parity config)
twice after a warm-up:

1. with the frame steps run eagerly (``pipeline._track_refine_step`` and
   ``_keyframe_step``, the bodies the CUDA graphs capture) and each stage
   wrapped in ``torch.cuda.synchronize()`` and a host clock (align,
   stereo.observe, K3, keyframe propagation, depth-pyramid refresh):
   per-stage wall time per tracked frame;
2. as users run it, every frame step a graph replay, under
   ``torch.profiler``: the device's busy time (sum of kernel times)
   against the wall time, the kernels that took most of it, K1's time
   and launches a frame (its kernels found by name), each captured
   graph's kernel nodes (``runtime/graphs.py::stats``), and the device
   time inside the graphs' replays against the copies around them (each
   step's copy-in and clone-out);
3. the frame steps run eagerly once more under ``torch.profiler``, each
   stage inside a ``record_function`` range (no synchronize): the device
   time and kernel launches a tracked frame of each stage (align with
   K1, the SE(3) compose, the depth-pyramid refresh, the current frame's
   pyramid and gradients, observe, K3, keyframe propagation), each
   device operation given to the innermost range around the call that
   launched it (from the Chrome trace: the launch's correlation id and
   the ranges' host times).  A step body launches the same kernels
   eagerly as its graph holds, so the launches a frame by stage are also
   the graphs' kernel nodes by stage.

Usage (on the card): python tools/profile_port_gn.py [--frames N] [--out F]
[--root DIR]
Writes the report as JSON to F (default profile_port_gn.json) and prints it.
``--root`` profiles another checkout's package (e.g. the parent commit
unpacked with ``git archive`` into an ignored directory) on this
checkout's frames.
"""

from __future__ import annotations

import argparse
import bisect
import collections
import json
import os
import re
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the stages of part 3: (module path under the package, function, stage);
# functions that a checkout does not have are skipped, so the tool runs on
# the trees before and after the K4 kernels
STAGES = (("track.alignment", "align", "align (K1)"),
          ("geom.lie", "compose", "compose"),
          ("geom.lie", "relative", "compose"),
          ("runtime.pipeline", "_refresh_kf_depth", "depth-pyramid refresh"),
          ("image.pyramid", "build_levels", "pyramid and gradients"),
          ("image.pyramid", "build_pyramid", "pyramid"),
          ("image.pyramid", "max_abs_gradient", "pyramid"),
          ("track.alignment", "make_current_levels", "gradients"),
          ("image.pyramid", "gradients", "gradients"),
          ("depth.stereo", "observe", "observe (K2)"),
          ("ops.reg_kernel", "do_regularization", "K3"),
          ("ops.reg_kernel", "regularize", "K3"),
          ("depth.propagate", "propagate", "propagate"))
# Chrome-trace categories of the device's work
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


def _load_trace(path):
    with open(path) as f:
        events = json.load(f).get("traceEvents", [])
    dev = [e for e in events if e.get("cat") in DEVICE_CATEGORIES
           and e.get("ph") == "X"]
    launch = {e["args"]["correlation"]: e for e in events
              if e.get("cat") in ("cuda_runtime", "cuda_driver")
              and "correlation" in e.get("args", {})}
    return events, dev, launch


def stage_split(path, n_frames):
    """Per stage: device ms and operations a frame.  Each device operation
    goes to the innermost ``stage:`` range, on the launching thread, whose
    host span holds its launch call."""
    events, dev, launch = _load_trace(path)
    ranges = collections.defaultdict(list)
    for e in events:
        if e.get("cat") == "user_annotation" and \
                str(e.get("name", "")).startswith("stage:"):
            ranges[e["tid"]].append((float(e["ts"]),
                                     float(e["ts"]) + float(e["dur"]),
                                     e["name"][len("stage:"):]))
    for r in ranges.values():
        r.sort()
    longest = max((end - start for r in ranges.values()
                   for start, end, _ in r), default=0.0)
    ms = collections.defaultdict(float)
    ops = collections.defaultdict(int)
    for e in dev:
        call = launch.get(e.get("args", {}).get("correlation"))
        name = "other (outside the stages)"
        if call is not None:
            r = ranges.get(call["tid"], [])
            ts = float(call["ts"])
            # the innermost range holding ts starts last among those that
            # hold it: walk back from the last range starting by ts
            for i in range(bisect.bisect_right(r, (ts, float("inf"), "")) - 1,
                           -1, -1):
                start, end, label = r[i]
                if start < ts - longest:
                    break
                if ts <= end:
                    name = label
                    break
        ms[name] += float(e.get("dur", 0.0)) / 1e3
        ops[name] += 1
    return ({k: v / n_frames for k, v in sorted(ms.items())},
            {k: ops[k] / n_frames for k in sorted(ops)})


def graph_split(path, n_frames):
    """Device ms a frame inside graph replays (operations launched by a
    graph launch) and outside them (each step's copies, the runner's own
    operations)."""
    _, dev, launch = _load_trace(path)
    ms = collections.defaultdict(float)
    for e in dev:
        call = launch.get(e.get("args", {}).get("correlation"))
        inside = call is not None and "GraphLaunch" in str(call.get("name"))
        ms["graph replays" if inside else "outside the graphs"] += \
            float(e.get("dur", 0.0)) / 1e3
    return {k: v / n_frames for k, v in ms.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=41)
    ap.add_argument("--out", default="profile_port_gn.json")
    ap.add_argument("--root", default=ROOT,
                    help="the checkout whose package is profiled")
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.root))
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
        graphs, pipeline, runner)
    from egomotion_with_local_loop_closures_tpu_torch.track import alignment

    import egomotion_with_local_loop_closures_tpu_torch as port
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

    # a stage clock syncs the card, which a graph capture refuses: the
    # steps run their bodies eagerly here
    originals += [(pipeline, name, getattr(pipeline, name))
                  for name in ("track_refine_step", "keyframe_step")]
    for mod, name, fn in originals[:len(wrapped)]:
        setattr(mod, name, timed(name, fn))
    pipeline.track_refine_step = pipeline._track_refine_step
    pipeline.keyframe_step = pipeline._keyframe_step
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = runner.run_sequence(iter(frames), cfg, dev)
    torch.cuda.synchronize()
    wall_sync = time.perf_counter() - t0
    for mod, name, fn in originals:
        setattr(mod, name, fn)
    n = len(res.frame_ids)

    # 2. device busy share under the profiler, no synchronizing wrappers
    from torch.profiler import ProfilerActivity, profile, record_function
    tmp = tempfile.mkdtemp(prefix="profile_port_gn_")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        runner.run_sequence(iter(frames), cfg, dev)
        torch.cuda.synchronize()
        wall_prof = time.perf_counter() - t0
    prof.export_chrome_trace(os.path.join(tmp, "graphed.json"))
    graphed = graph_split(os.path.join(tmp, "graphed.json"), n)

    # 3. per-stage device time, the steps eager, each stage a range
    import importlib
    pkg = "egomotion_with_local_loop_closures_tpu_torch"
    ranged = []
    for mod_name, fn_name, label in STAGES:
        mod = importlib.import_module(f"{pkg}.{mod_name}")
        if hasattr(mod, fn_name):
            ranged.append((mod, fn_name, getattr(mod, fn_name), label))

    def in_range(label, fn):
        def inner(*a, **k):
            with record_function(f"stage:{label}"):
                return fn(*a, **k)
        return inner

    for mod, fn_name, fn, label in ranged:
        setattr(mod, fn_name, in_range(label, fn))
    pipeline.track_refine_step = pipeline._track_refine_step
    pipeline.keyframe_step = pipeline._keyframe_step
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof3:
            runner.run_sequence(iter(frames), cfg, dev)
            torch.cuda.synchronize()
    finally:
        for mod, fn_name, fn, _ in ranged:
            setattr(mod, fn_name, fn)
        for mod, name, fn in originals[len(wrapped):]:
            setattr(mod, name, fn)
    prof3.export_chrome_trace(os.path.join(tmp, "stages.json"))
    stage_ms, stage_ops = stage_split(os.path.join(tmp, "stages.json"), n)
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
    # K1's kernels by name: the two-kernel version's and the level and
    # step kernels that replaced them
    k1 = [e for e in events
          if re.search(r"gn_(linearize|finish|level_cluster|step)\b", e.key)]

    report = {
        "gpu": gpu, "package": os.path.dirname(port.__file__),
        "frames_tracked": n,
        "stage_ms_per_frame": {k: 1e3 * v / n for k, v in stages.items()},
        "wall_ms_per_frame_with_stage_syncs": 1e3 * wall_sync / n,
        "wall_ms_per_frame_profiled": 1e3 * wall_prof / n,
        "device_busy_ms_per_frame": busy_us / 1e3 / n,
        "device_busy_share": busy_us / 1e6 / wall_prof,
        "device_kernel_launches_per_frame": launches / n,
        "k1_ms_per_frame": sum(e.device_time_total for e in k1) / 1e3 / n,
        "k1_launches_per_frame": sum(e.count for e in k1) / n,
        "graphed_device_ms_per_frame": graphed,
        "eager_stage_device_ms_per_frame": stage_ms,
        "eager_stage_device_ops_per_frame": stage_ops,
        "graph_kernel_nodes": [
            {"step": r["step"], "replay": r["replay"], "lead": r["lead"],
             "window": pipeline._needs_window(r["cfg"]),
             "nodes": r["nodes"].get("kernel", 0), "k1": r["k1"]}
            for r in graphs.stats()],
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
