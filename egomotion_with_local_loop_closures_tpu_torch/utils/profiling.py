"""Timing, tracing and throughput counters.

Port of ``egomotion_with_local_loop_closures_tpu/utils/profiling.py``.
The reference times pose estimation and loop-closure matching with
``util::measureTime``, a gettimeofday stopwatch
(``src/ExternVariable.h:238-266``); ``Stopwatch`` is that stopwatch.
PyTorch queues work on a CUDA card and returns at once, so a clock around
a call measures its dispatch; ``StageTimer`` synchronizes the device of
each tensor a stage registers before it stops the clock.  ``trace`` wraps
``torch.profiler`` and writes a Chrome trace, ``trace_device_time``
reads the device's busy time back from that file, and ``Meters`` counts
the frames/s (per device) that the end-to-end metrics ask for.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from dataclasses import dataclass, field
from typing import Any, Dict, Iterator, List, Optional

import torch


class Stopwatch:
    """util::measureTime (ExternVariable.h:238-266): start/stop in ms."""

    def __init__(self):
        self._t0 = 0.0

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop_ms(self) -> float:
        return (time.perf_counter() - self._t0) * 1e3


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


def _device_count(device) -> int:
    """CUDA devices on this host when ``device`` is a CUDA device, else 1."""
    return torch.cuda.device_count() if torch.device(device).type == "cuda" \
        else 1


@dataclass
class Meters:
    """Throughput counters (frames/s, and per device of the type of
    ``device``: the visible CUDA cards, or 1 on the CPU)."""
    device: Any = "cpu"
    frames: int = 0
    keyframes: int = 0
    loop_edges: int = 0
    _t0: float = field(default_factory=time.perf_counter)

    def frames_per_second(self) -> float:
        return self.frames / max(time.perf_counter() - self._t0, 1e-9)

    def frames_per_second_per_chip(self) -> float:
        return self.frames_per_second() / max(_device_count(self.device), 1)

    def as_dict(self) -> Dict[str, float]:
        return {"frames": self.frames, "keyframes": self.keyframes,
                "loop_edges": self.loop_edges,
                "fps": self.frames_per_second(),
                "fps_per_chip": self.frames_per_second_per_chip()}


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
