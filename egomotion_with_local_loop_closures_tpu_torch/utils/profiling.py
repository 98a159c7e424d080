"""Timing, tracing and the program's own spans and counters.

Port of ``egomotion_with_local_loop_closures_tpu/utils/profiling.py``.
PyTorch queues work on a CUDA card and returns at once, so a clock around
a call measures its dispatch; ``StageTimer`` synchronizes the device of
each tensor a stage registers before it stops the clock.  ``trace`` wraps
``torch.profiler`` and writes a Chrome trace, and ``trace_device_time``
reads the device's busy time back from that file.

Inside the program, :func:`span` names a range on the profiler's clock
(``ellc.init``, ``ellc.interval``, ``ellc.step.*``, ``ellc.graph.*``), so
that a trace attributes host time and the device operations launched in
it to the program's phases; with no profiler recording it costs one
check.  :func:`counters` reads the counts kept at the same boundaries:
``runtime/graphs.py``'s replays (of interval graphs and of step graphs
apart) and captures, and K1's live GN iterations
(:func:`k1_live`), counted on the device by the kernels and on the CPU by
the plain twin.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from dataclasses import dataclass, field
from typing import Any, Dict, Iterator, List, Optional

import torch


@dataclass
class StageStats:
    count: int = 0
    total_s: float = 0.0
    min_s: float = float("inf")
    max_s: float = 0.0

    def add(self, dt: float) -> None:
        self.count += 1
        self.total_s += dt
        self.min_s = min(self.min_s, dt)
        self.max_s = max(self.max_s, dt)

    @property
    def mean_s(self) -> float:
        return self.total_s / max(self.count, 1)


def _sync(value: Any) -> None:
    """Wait for the CUDA device of ``value`` (a tensor, or a tuple, list
    or dict of them) to finish its queued work; anything that is not a
    tensor needs no wait."""
    if isinstance(value, torch.Tensor):
        if value.is_cuda:
            torch.cuda.synchronize(value.device)
    elif isinstance(value, (list, tuple)):
        for v in value:
            _sync(v)
    elif isinstance(value, dict):
        for v in value.values():
            _sync(v)


@dataclass
class StageTimer:
    """Per-stage wall-clock aggregation that covers the device's work:
    ``stage(name)`` is a context manager yielding a list; append the
    stage's output tensors to it (or pass one as ``sync``) and their
    devices are synchronized before the clock stops."""

    stats: Dict[str, StageStats] = field(default_factory=dict)

    @contextlib.contextmanager
    def stage(self, name: str, sync: Any = None) -> Iterator[List[Any]]:
        out: List[Any] = []
        t0 = time.perf_counter()
        try:
            yield out
        finally:
            _sync(out)
            _sync(sync)
            self.stats.setdefault(name, StageStats()).add(
                time.perf_counter() - t0)

    def report(self) -> str:
        lines = []
        for name, s in sorted(self.stats.items(),
                              key=lambda kv: -kv[1].total_s):
            lines.append(f"{name:<28s} n={s.count:5d}  "
                         f"mean={s.mean_s * 1e3:8.2f}ms  "
                         f"total={s.total_s:7.2f}s")
        return "\n".join(lines)


@contextlib.contextmanager
def trace(log_dir: Optional[str]) -> Iterator[Optional[torch.profiler.profile]]:
    """``torch.profiler`` over the block, CPU and (where there is a card)
    CUDA activities, written as a Chrome trace ``trace.json`` into
    ``log_dir`` (view it in Perfetto or chrome://tracing); yields the
    profiler, whose ``key_averages()`` and ``events()`` stay readable
    after the block.  With no ``log_dir`` it does nothing and yields
    None."""
    if not log_dir:
        yield None
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


# Chrome-trace categories of the work a CUDA device does
_DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


def trace_device_time(path: str):
    """(busy ms, operations) of the device work in a Chrome trace written
    by ``trace``: the summed durations and the count of its kernels,
    copies and sets.  Reading the file back is far cheaper than the
    profiler's ``key_averages()`` over a window of ~10^5 launches."""
    with open(path) as f:
        events = json.load(f).get("traceEvents", [])
    dev = [e for e in events if e.get("cat") in _DEVICE_CATEGORIES
           and e.get("ph") == "X"]
    return sum(float(e.get("dur", 0.0)) for e in dev) / 1e3, len(dev)


# --- the program's spans and counters ---

_NULL = contextlib.nullcontext()


def span(name: str):
    """A range named ``name`` (``ellc.``...) around a block of the
    program: ``torch.profiler.record_function(name)`` while a profiler
    records, so that it lands in the trace beside the device's kernels and
    copies; otherwise one shared null context, which costs the check
    alone."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _NULL


# runtime/graphs.py: replays of a whole interval's graph, replays of a
# frame step's graph, and captures of either (a capture after set-up is a
# graph built again inside the timed window)
_host_counts: Dict[str, int] = {"interval_replays": 0, "graph_replays": 0,
                                "graph_captures": 0}
# K1's live-iteration tables by device, the newest last: a table that had
# to grow stays, since graphs captured before write into it
_k1_live: Dict[torch.device, List[torch.Tensor]] = {}


def count(name: str, n: int = 1) -> None:
    """Adds ``n`` to the host counter ``name``."""
    _host_counts[name] += n


def k1_live(device: torch.device, levels: int, iters: int) -> torch.Tensor:
    """K1's live-iteration table on ``device``, int64, at least
    (levels, iters): entry [l][i] counts the videos not frozen at the
    start of iteration i of level l, the iterations whose linearization
    read the level's planes.  Made, or made larger, on a call outside any
    CUDA graph capture (the graphs' eager warm-up), as K1's
    workspace is."""
    tables = _k1_live.setdefault(device, [])
    if tables and tables[-1].shape[0] >= levels \
            and tables[-1].shape[1] >= iters:
        return tables[-1]
    if device.type == "cuda" and torch.cuda.is_current_stream_capturing():
        raise RuntimeError(
            f"K1's live-iteration table of {levels} levels and {iters} "
            f"iterations on {device} is made outside a CUDA graph capture: "
            f"run the call once eagerly first")
    if tables:
        levels = max(levels, tables[-1].shape[0])
        iters = max(iters, tables[-1].shape[1])
    tables.append(torch.zeros((levels, iters), dtype=torch.int64,
                              device=device))
    return tables[-1]


def counters() -> Dict[str, Any]:
    """The program's counters: ``interval_replays`` (a whole interval's
    graph), ``graph_replays`` (a frame step's graph alone) and
    ``graph_captures``, and ``k1_live``, each device's table (the sum of
    its tables) as lists of ints by the device's name.  Reads the tables
    back from their devices, so it waits for them: a reader's call, not
    the hot path's."""
    live = {}
    for device, tables in _k1_live.items():
        total = torch.zeros((max(t.shape[0] for t in tables),
                             max(t.shape[1] for t in tables)),
                            dtype=torch.int64)
        for t in tables:
            total[:t.shape[0], :t.shape[1]] += t.cpu()
        live[str(device)] = total.tolist()
    return {**_host_counts, "k1_live": live}


def reset_counters() -> None:
    """Zeroes every counter (the tables in place, where graphs write)."""
    for name in _host_counts:
        _host_counts[name] = 0
    for tables in _k1_live.values():
        for t in tables:
            t.zero_()
