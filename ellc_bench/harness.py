"""One run of one benchmark cell: load, warm up, measure, check, report.

``run.py`` calls :func:`main`; the tests call :func:`run_cell` on the CPU
at a small size.  Everything that belongs to one configuration, traffic
mix, entry point or per-layer metric lives in a file of its own, found by
the names in ``BENCHMARK.json``:

- ``ellc_bench/configs/<config>.json``: the deployment (``ELLCConfig``
  overrides, the entry it drives, the comparison's limits);
- ``ellc_bench/traffic/<traffic>.json``: the mix (videos at once, frames a
  clip, scene kind, trajectory and texture);
- ``ellc_bench/drivers/<entry>.py``: the window's entry point, a
  ``Driver`` class (see ``drivers/__init__.py``);
- ``ellc_bench/metrics/<metric>.py``: a per-layer metric, a function
  ``read(ctx)`` that returns its value or None.

A run is a closed loop of passes: a pass is one clip set, from a fresh
init to its end, its outputs read back.  The window ends when the pass in
flight at ``--seconds`` ends, and the rate divides the frames of every
pass in it by that elapsed time.  With ``--trace 1`` the window's second
pass runs under ``torch.profiler`` and the run reports the per-layer
metrics instead of the end-to-end ones.
"""

from __future__ import annotations

import contextlib
import importlib.util
import json
import os
import subprocess
import sys
import tempfile
import time
from typing import Dict, List, Optional, Tuple

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "egomotion_with_local_loop_closures_tpu")
TRACE_SPAN = "ellc_bench.pass"
TRACED_PASS = 1


def process_seconds() -> float:
    """Seconds since this process started (``/proc/self/stat``'s start
    time, in clock ticks since boot)."""
    with open("/proc/self/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    start = int(fields[19]) / os.sysconf("SC_CLK_TCK")
    return time.clock_gettime(time.CLOCK_BOOTTIME) - start


def set_environment(root: str) -> None:
    """Caches inside the checkout at fixed paths, one host thread for the
    CPU's operator pools (idle pool threads spinning beside the main one
    spread a host-paced rate by up to 20 % between runs of one seed), and
    no JAX pulled in by a library: set before torch is imported."""
    cache = os.path.join(root, "ellc_bench", ".cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache,
                                                      "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["OMP_NUM_THREADS"] = "1"
    os.environ["MKL_NUM_THREADS"] = "1"
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def _load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: str, name: str):
    """A module of the benchmark loaded from its file (names may hold
    dots, as ``idle_pct.gn`` does)."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_spec(workload: str, root: str = ROOT) -> dict:
    """The cell named ``workload`` with its configuration, traffic and
    metrics, each loaded by its name from its file."""
    bench = _load_json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    config_file = {c["name"]: c["file"] for c in bench["configs"]}[
        cell["config"]]
    config = _load_json(os.path.join(root, config_file))
    traffic = _load_json(os.path.join(root, "ellc_bench", "traffic",
                                      cell["traffic"] + ".json"))

    def in_cell(m):
        return "workloads" not in m or workload in m["workloads"]

    return dict(root=root, cell=cell, config=config, traffic=traffic,
                end_to_end=[m for m in bench["end_to_end"] if in_cell(m)],
                per_layer=[m for m in bench["per_layer"] if in_cell(m)])


def load_driver(entry: str, root: str = ROOT):
    """The driver of an entry point, ``ellc_bench/drivers/<entry>.py``."""
    return load_module(os.path.join(root, "ellc_bench", "drivers",
                                    entry + ".py"),
                       "ellc_bench_driver_" + entry)


def load_metric(name: str, root: str = ROOT):
    """The reader of a per-layer metric, ``ellc_bench/metrics/<name>.py``."""
    return load_module(os.path.join(root, "ellc_bench", "metrics",
                                    name + ".py"),
                       "ellc_bench_metric_" + name.replace(".", "_"))


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's, its libraries' or the
    JAX package's (whole names: the port's name begins with the JAX
    package's)."""
    return sorted({m for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


def power_limit() -> Optional[str]:
    """nvidia-smi's name and power limit of card 0, or None."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", "-i", "0"], capture_output=True,
            text=True, timeout=30, check=True).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return None
    return out or None


def _trace_pass(drv, spans: Dict[str, list], counters: dict
                ) -> Tuple[int, object]:
    """One pass with the part of it that the driver holds ``profiled``
    around under the profiler; its frames and the trace summary of that
    part."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from ellc_bench import trace

    acts = [ProfilerActivity.CPU]
    if drv.device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    path = os.path.join(tempfile.gettempdir(), "ellc_bench_trace.json")
    traced = []

    @contextlib.contextmanager
    def profiled():
        with profile(activities=acts) as prof:
            with record_function(TRACE_SPAN):
                yield
        prof.export_chrome_trace(path)
        traced.append(True)

    frames = drv.run_pass(spans, counters, profiled)
    if not traced:
        raise RuntimeError("the driver traced no part of its pass")
    try:
        summary = trace.summarize(path, TRACE_SPAN)
    finally:
        os.remove(path)
    return frames, summary


def run_cell(spec: dict, seed: int, seconds: float, traced: bool,
             device: str = "cuda", t_start: Optional[float] = None
             ) -> Tuple[dict, List[Tuple[str, float, float]]]:
    """Run one cell once; returns the result line's object (without
    ``checks``) and the compared numbers as (name, value, limit)."""
    import torch

    from ellc_bench import trace

    mod = load_driver(spec["config"]["entry"], spec["root"])
    drv = mod.Driver(spec["config"], spec["traffic"], seed, device)
    if drv.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(drv.device)
    drv.setup()
    if drv.device.type == "cuda":
        torch.cuda.synchronize(drv.device)
    setup_s = (process_seconds() if t_start is None
               else time.perf_counter() - t_start)

    spans: Dict[str, list] = {}
    counters: Dict[str, float] = {}
    frames = passes = 0
    summary = None
    t0 = time.perf_counter()
    while True:
        if traced and passes == TRACED_PASS:
            # the traced pass: its spans and counters stay apart
            n, summary = _trace_pass(drv, {}, {})
        else:
            n = drv.run_pass(spans, counters)
        frames += n
        passes += 1
        elapsed = time.perf_counter() - t0
        if elapsed >= seconds and (not traced or passes > TRACED_PASS):
            break
    peak = (torch.cuda.max_memory_allocated(drv.device)
            if drv.device.type == "cuda" else 0)
    for line in drv.report_lines():
        print(line, file=sys.stderr, flush=True)
    drv.release()
    checks = drv.check(_limits(spec))

    result = {"correct": all(v <= lim for _, v, lim in checks),
              "attempted": drv.attempted, "failed": drv.failed}
    if traced:
        ctx = dict(trace=summary, spans=spans, counters=counters,
                   work=drv.pass_work(), config=drv.cfg, seconds=elapsed)
        metrics = {}
        for m in spec["per_layer"]:
            value = load_metric(m["name"], spec["root"]).read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = {"setup_s": setup_s, drv.RATE_METRIC: frames / elapsed}
        metrics = {}
        for m in spec["end_to_end"]:
            if m["name"] not in values:
                raise RuntimeError(f"this run measures no {m['name']}")
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
    result["metrics"] = metrics
    dev = {"platform": "gpu" if drv.device.type == "cuda" else "cpu",
           "kind": (torch.cuda.get_device_name(drv.device)
                    if drv.device.type == "cuda" else "cpu"),
           "count": int(spec["cell"]["chips"]),
           "memory_peak_bytes": int(peak)}
    if traced and summary is not None:
        dev["busy_s"] = summary.busy_s
        dev["window_s"] = summary.window_s
        result["breakdown"] = trace.breakdown(summary)
    limit = power_limit() if drv.device.type == "cuda" else None
    if limit:
        dev["nvidia_smi"] = limit
    result["device"] = dev
    result["window"] = {"seconds": elapsed, "passes": passes,
                        "frames": frames}
    return result, checks


def apply_sets(spec: dict, traffic_sets) -> dict:
    """``spec`` with traffic parameters given as NAME=VALUE strings (VALUE
    in JSON) replaced: for the sweep that reruns a cell at other sizes."""
    for item in traffic_sets:
        name, value = item.split("=", 1)
        spec["traffic"][name] = json.loads(value)
    return spec


def _limits(spec: dict) -> dict:
    limits = dict(spec["config"].get("limits", {}))
    limits.update(spec["traffic"].get("limits", {}))
    return limits


def main(argv: Optional[List[str]] = None, t_start: Optional[float] = None
         ) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    set_environment(ROOT)
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    spec = cell_spec(args.workload)
    import torch

    chips = int(spec["cell"]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"ellc_bench: {chips} CUDA device(s) needed, "
              f"{torch.cuda.device_count()} available; no result",
              file=sys.stderr)
        return 3
    result, checks = run_cell(spec, args.seed, args.seconds,
                              bool(args.trace), "cuda", t_start)
    bad = forbidden_modules()
    if bad:
        print(f"ellc_bench: JAX or the JAX package was loaded: {bad}; "
              "no result", file=sys.stderr)
        return 4
    for name, value, limit in checks:
        print(f"check {name} {value!r} limit {limit!r} "
              f"{'ok' if value <= limit else 'FAIL'}", file=sys.stderr)
    result["checks"] = {name: {"value": value, "limit": limit}
                        for name, value, limit in checks}
    print(json.dumps(result), flush=True)
    return 0
