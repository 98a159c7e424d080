"""Reduction of a ``torch.profiler`` Chrome trace of one traced pass to what
the per-layer metrics read: the device's busy time over the traced span
(the union of every kernel, memcpy and memset interval), each kernel's
device time by name, and the idle gaps with what the host was doing.

The benchmark runs the profiler from its own code (``harness.py``) and
reads the trace back here, so no change to the program can change how it
is read.
"""

from __future__ import annotations

import bisect
import dataclasses
import json
import re
from typing import Dict, List, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver",
             "python_function")
GAPS_KEPT = 10


@dataclasses.dataclass
class TraceSummary:
    window_s: float                   # the traced span
    busy_s: float                     # union of the device intervals in it
    device_s: Dict[str, float]        # device seconds by operation name
    launches: Dict[str, int]          # device operations by name
    gaps: List[Tuple[str, float]]     # the longest idle gaps, longest first

    def kernel_s(self, pattern: str) -> float:
        """Device seconds of the operations whose name holds ``pattern``
        as a whole word (a regular expression)."""
        rx = re.compile(rf"\b(?:{pattern})\b")
        return sum(s for n, s in self.device_s.items() if rx.search(n))


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    merged: List[Tuple[float, float]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            if b > merged[-1][1]:
                merged[-1] = (merged[-1][0], b)
        else:
            merged.append((a, b))
    return merged


def _host_at(host: List[Tuple[float, float, str]], starts: List[float],
             t: float) -> str:
    """The innermost host event running at ``t`` (the latest to start of
    those that cover it), or "host idle"."""
    i = bisect.bisect_right(starts, t)
    for a, b, name in reversed(host[max(0, i - 5000):i]):
        if b >= t:
            return name
    return "host idle"


def summarize(path: str, span_name: str) -> TraceSummary:
    """The summary of the Chrome trace at ``path`` over the host range
    named ``span_name`` (the harness's ``record_function`` around the
    traced pass)."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    spans = [e for e in events if e.get("ph") == "X"
             and e.get("name") == span_name
             and e.get("cat") == "user_annotation"]
    if not spans:
        raise RuntimeError(f"no {span_name!r} range in the trace")
    t0 = float(spans[0]["ts"])
    t1 = t0 + float(spans[0]["dur"])
    dev: List[Tuple[float, float]] = []
    device_us: Dict[str, float] = {}
    launches: Dict[str, int] = {}
    host: List[Tuple[float, float, str]] = []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        a = float(e["ts"])
        b = a + float(e["dur"])
        cat = e.get("cat")
        if cat in DEVICE_CATS:
            a, b = max(a, t0), min(b, t1)
            if b <= a:
                continue
            dev.append((a, b))
            name = e.get("name", "?")
            device_us[name] = device_us.get(name, 0.0) + (b - a)
            launches[name] = launches.get(name, 0) + 1
        elif cat in HOST_CATS and e.get("name") != span_name \
                and b > t0 and a < t1:
            host.append((a, b, e.get("name", "?")))
    host.sort()
    merged = _union(dev)
    busy = sum(b - a for a, b in merged)
    edges = [t0] + [x for iv in merged for x in iv] + [t1]
    gaps = sorted(((b - a, a) for a, b in zip(edges[0::2], edges[1::2])
                   if b > a), reverse=True)[:GAPS_KEPT]
    starts = [h[0] for h in host]
    gaps = [(_host_at(host, starts, a), d * 1e-6) for d, a in gaps]
    return TraceSummary(window_s=(t1 - t0) * 1e-6, busy_s=busy * 1e-6,
                        device_s={k: v * 1e-6 for k, v in device_us.items()},
                        launches=launches, gaps=gaps)


def breakdown(summary: TraceSummary, top: int = 10) -> dict:
    """The result line's ``breakdown``: the device operations that took
    most time and the longest idle gaps, ``top`` of each."""
    ops = sorted(summary.device_s.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[n, s] for n, s in ops],
            "idle_gaps": [[n, s] for n, s in summary.gaps[:top]]}
