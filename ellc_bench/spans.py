"""The program's own ranges in a ``torch.profiler`` Chrome trace.

The port names its phases while a profiler records
(``utils/profiling.span``): ``ellc.init``, ``ellc.interval``,
``ellc.step.track_refine`` and ``ellc.step.keyframe``, and inside a
graphed step ``ellc.graph.capture``, ``ellc.graph.copy_in``,
``ellc.graph.replay`` and ``ellc.graph.clone_out``.  This module reduces
a trace to what those ranges own:

- :func:`span_times`: the device seconds by the innermost ``ellc.*``
  range that launched each device operation (its ``args.correlation``
  matched to the CUDA runtime or driver call that launched it, and the
  innermost range of that call's thread covering the call's start: a CUDA
  graph's own nodes fall under ``ellc.graph.replay`` through its
  ``cudaGraphLaunch``), and for each range name the host seconds of each
  instance outside CUDA runtime and driver calls (the host's own Python
  and ATen work, without the waits on a full launch queue);
- :func:`graph_copy_pct`: the device time of the copies in and clones out
  of the step graphs as a share of the device's busy time;
- :func:`host_step_ms`: the median host time of a frame step.

``trace.py`` does not call these, so no result line carries them.  As a
script, one traced pass of a cell, as the harness traces it:

    python ellc_bench/spans.py --workload gn_backlog --seed 7

prints one JSON line: the pass's window and busy seconds, the device and
host seconds by range, both readings above, the longest idle gaps (by
the trace's host event and by ``ellc.*`` range, :func:`gap_spans`), the
program's counters (``k1_live`` as live iterations an align at each
level) and each step graph's bytes copied in and cloned out a replay.
"""

from __future__ import annotations

import bisect
import contextlib
import json
import os
import statistics
import sys
import tempfile
from typing import Dict, List, Optional, Tuple

if __package__ in (None, ""):
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))

from ellc_bench import trace  # noqa: E402

PREFIX = "ellc."
RUNTIME_CATS = ("cuda_runtime", "cuda_driver")
COPY_SPANS = ("ellc.graph.copy_in", "ellc.graph.clone_out")
STEP_PREFIX = "ellc.step."


class _Ranges:
    """One thread's ``ellc.*`` ranges, for the innermost one at a time."""

    def __init__(self, ranges: List[Tuple[float, float, str]]):
        ranges = sorted(ranges, key=lambda r: (r[0], -r[1]))
        self.starts = [a for a, _, _ in ranges]
        self.ends = [b for _, b, _ in ranges]
        self.names = [n for _, _, n in ranges]
        # each range's enclosing range, -1 for none
        self.parent: List[int] = []
        stack: List[int] = []
        for i, (a, _, _) in enumerate(ranges):
            while stack and self.ends[stack[-1]] < a:
                stack.pop()
            self.parent.append(stack[-1] if stack else -1)
            stack.append(i)

    def innermost(self, t: float) -> Optional[str]:
        i = bisect.bisect_right(self.starts, t) - 1
        while i >= 0 and self.ends[i] < t:
            i = self.parent[i]
        return self.names[i] if i >= 0 else None


class _Union:
    """The union of one thread's runtime calls, for the part of an
    interval they cover."""

    def __init__(self, intervals: List[Tuple[float, float]]):
        self.merged = trace._union(intervals)
        self.starts = [a for a, _ in self.merged]
        self.before = [0.0]          # covered length before each interval
        for a, b in self.merged:
            self.before.append(self.before[-1] + (b - a))

    def _upto(self, x: float) -> float:
        j = bisect.bisect_right(self.starts, x) - 1
        if j < 0:
            return 0.0
        a, b = self.merged[j]
        return self.before[j] + min(x, b) - a

    def covered(self, a: float, b: float) -> float:
        return self._upto(b) - self._upto(a)


def _thread(e: dict) -> Tuple:
    return (e.get("pid"), e.get("tid"))


def _parse(events: List[dict], t0: float, t1: float):
    """The ``ellc.*`` ranges over the window and the runtime and driver
    calls, each by thread; each launch's (thread, start) by correlation
    id; the device operations clipped to the window, (correlation id or
    None, start, end)."""
    ranges: Dict[Tuple, List[Tuple[float, float, str]]] = {}
    calls: Dict[Tuple, List[Tuple[float, float]]] = {}
    launched: Dict[int, Tuple[Tuple, float]] = {}
    device: List[Tuple[Optional[int], float, float]] = []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        a = float(e["ts"])
        b = a + float(e["dur"])
        cat = e.get("cat")
        corr = (e.get("args") or {}).get("correlation")
        if cat == "user_annotation" and e.get("name", "").startswith(PREFIX):
            if b > t0 and a < t1:
                ranges.setdefault(_thread(e), []).append(
                    (a, b, e["name"]))
        elif cat in RUNTIME_CATS:
            calls.setdefault(_thread(e), []).append((a, b))
            if corr is not None:
                launched[corr] = (_thread(e), a)
        elif cat in trace.DEVICE_CATS:
            a, b = max(a, t0), min(b, t1)
            if b > a:
                device.append((corr, a, b))
    return ranges, calls, launched, device


def span_times(events: List[dict], t0: float, t1: float
               ) -> Tuple[Dict[str, float], Dict[str, List[float]]]:
    """(device seconds by the innermost ``ellc.*`` range, host seconds
    outside runtime and driver calls of each range instance by name) over
    the window [t0, t1] (microseconds, the trace's clock).  Device
    operations are clipped to the window, as ``trace.summarize`` clips
    them; an operation whose launch lies in no ``ellc.*`` range, or whose
    launch is not in the trace, counts for no range."""
    ranges, calls, launched, device = _parse(events, t0, t1)
    by_thread = {k: _Ranges(v) for k, v in ranges.items()}
    device_us: Dict[str, float] = {}
    for corr, a, b in device:
        if corr not in launched:
            continue
        thread, t = launched[corr]
        name = by_thread[thread].innermost(t) if thread in by_thread else None
        if name is not None:
            device_us[name] = device_us.get(name, 0.0) + (b - a)
    host_s: Dict[str, List[float]] = {}
    for thread, rs in ranges.items():
        union = _Union(calls.get(thread, []))
        for a, b, name in rs:
            a, b = max(a, t0), min(b, t1)
            host_s.setdefault(name, []).append(
                (b - a - union.covered(a, b)) * 1e-6)
    return {k: v * 1e-6 for k, v in device_us.items()}, host_s


def gap_spans(events: List[dict], t0: float, t1: float, top: int = 10
              ) -> List[Tuple[Optional[str], float, float]]:
    """The ``top`` longest gaps of the window in which the device ran
    nothing, longest first, as ``trace.summarize`` finds them: (the
    innermost ``ellc.*`` range of a host thread at the gap's start, or
    None; seconds; the gap's start in seconds from the window's)."""
    ranges, _, _, device = _parse(events, t0, t1)
    by_thread = [_Ranges(v) for v in ranges.values()]
    merged = trace._union([(a, b) for _, a, b in device])
    edges = [t0] + [x for iv in merged for x in iv] + [t1]
    gaps = sorted(((b - a, a) for a, b in zip(edges[0::2], edges[1::2])
                   if b > a), reverse=True)[:top]
    out = []
    for d, a in gaps:
        names = [r.innermost(a) for r in by_thread]
        out.append((next((n for n in names if n is not None), None),
                    d * 1e-6, (a - t0) * 1e-6))
    return out


def window(events: List[dict], span_name: str) -> Tuple[float, float]:
    """The [start, end] of the first host range named ``span_name``."""
    for e in events:
        if (e.get("ph") == "X" and e.get("name") == span_name
                and e.get("cat") == "user_annotation"):
            return float(e["ts"]), float(e["ts"]) + float(e["dur"])
    raise RuntimeError(f"no {span_name!r} range in the trace")


def graph_copy_pct(span_device_s: Dict[str, float],
                   busy_s: float) -> Optional[float]:
    """The device time launched under ``ellc.graph.copy_in`` and
    ``ellc.graph.clone_out`` as a share (%) of the busy time; None where
    the trace has neither."""
    if busy_s <= 0 or not any(n in span_device_s for n in COPY_SPANS):
        return None
    return 100.0 * sum(span_device_s.get(n, 0.0) for n in COPY_SPANS) \
        / busy_s


def host_step_ms(span_host_s: Dict[str, List[float]]) -> Optional[float]:
    """The median over every ``ellc.step.*`` instance of its host time
    outside runtime and driver calls, in ms; None where there is none."""
    steps = [s for n, v in span_host_s.items() if n.startswith(STEP_PREFIX)
             for s in v]
    return 1e3 * statistics.median(steps) if steps else None


def _traced_pass(workload: str, seed: int, keep: Optional[str]) -> dict:
    """Set-up, one untraced pass and one traced pass of the cell on the
    card, as ``harness.run_cell`` makes them; the reduction of the
    trace."""
    from ellc_bench import harness
    harness.set_environment(harness.ROOT)
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from egomotion_with_local_loop_closures_tpu_torch.runtime import graphs
    from egomotion_with_local_loop_closures_tpu_torch.utils import profiling

    if not torch.cuda.is_available():
        raise SystemExit("spans.py: needs a CUDA device; no result")
    spec = harness.cell_spec(workload)
    drv = harness.load_driver(spec["config"]["entry"]).Driver(
        spec["config"], spec["traffic"], seed, "cuda")
    drv.setup()
    captures = profiling.counters()["graph_captures"]
    drv.run_pass({}, {})
    path = keep or os.path.join(tempfile.gettempdir(),
                                "ellc_bench_spans.json")

    @contextlib.contextmanager
    def profiled():
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            with record_function(harness.TRACE_SPAN):
                yield
        prof.export_chrome_trace(path)

    drv.run_pass({}, {}, profiled)
    try:
        summary = trace.summarize(path, harness.TRACE_SPAN)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        if keep is None:
            os.remove(path)
    t0, t1 = window(events, harness.TRACE_SPAN)
    dev_s, host_s = span_times(events, t0, t1)
    counters = profiling.counters()
    live = harness.load_metric("k1_live_roofline_pct").live_iters(
        drv.cfg.num_levels)
    return dict(
        device=harness.power_limit(), window_s=summary.window_s,
        busy_s=summary.busy_s,
        dtod_s=sum(s for n, s in summary.device_s.items()
                   if n.startswith("Memcpy DtoD")),
        span_device_s=dev_s,
        span_host_ms={n: dict(count=len(v),
                              median=1e3 * statistics.median(v),
                              total=1e3 * sum(v))
                      for n, v in host_s.items()},
        graph_copy_pct=graph_copy_pct(dev_s, summary.busy_s),
        host_step_ms=host_step_ms(host_s), idle_gaps=summary.gaps,
        idle_gap_spans=gap_spans(events, t0, t1),
        captures_in_window=counters["graph_captures"] - captures,
        graph_replays=counters["graph_replays"],
        k1_live=counters["k1_live"], k1_live_iters_an_align=live,
        graphs=[dict(step=r["step"], lead=r["lead"],
                     copy_in_bytes=r["copy_in_bytes"],
                     clone_out_bytes=r["clone_out_bytes"],
                     nodes=r["nodes"]) for r in graphs.stats()])


def main(argv: Optional[List[str]] = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--keep", default=None,
                    help="write the Chrome trace here and keep it")
    args = ap.parse_args(argv)
    print(json.dumps(_traced_pass(args.workload, args.seed, args.keep)),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
