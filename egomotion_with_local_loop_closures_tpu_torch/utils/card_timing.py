"""The card's time for a call, and the least time its work could take.

:func:`device_ms` times a function's device work from CUDA-graph replays;
:func:`bound_ms` is the larger of the bytes it must move over the card's
memory rate and its float32 operations over the card's peak rate.  The
peaks are the NVIDIA H100 SXM data sheet's.  ``chip_smoke.py`` and the
timing tools (``tools/time_k1_levels.py``, ``tools/tune_gn_kernel.py``)
report their kernel times with these.
"""

from __future__ import annotations

import time
from typing import Callable, Tuple

import torch

# H100 SXM published peaks: HBM3 bytes/s, float32 FLOP/s outside the
# tensor cores
PEAK_BYTES_S, PEAK_F32_S = 3.35e12, 67e12


def device_ms(fn: Callable[[], object], reps: int) -> Tuple[float, bool]:
    """The card's time per call: ``fn`` is captured once in a CUDA graph (a
    thousand launches of the plain version would fill the launch queue),
    a spin kernel holds the stream while the host queues ``reps`` replays,
    and CUDA events time the replays.  Returns (ms per call, whether the
    host's queueing stayed ahead of the card)."""
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    graph.replay()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    torch.cuda.synchronize()
    ev[0].record()
    torch.cuda._sleep(200_000_000)            # ~0.1 s at H100 clocks
    ev[1].record()
    t0 = time.perf_counter()
    for _ in range(reps):
        graph.replay()
    ev[2].record()
    host_ms = 1e3 * (time.perf_counter() - t0)
    ev[2].synchronize()
    return ev[1].elapsed_time(ev[2]) / reps, host_ms < ev[0].elapsed_time(
        ev[1])


def bound_ms(nbytes: float, ops: float) -> Tuple[float, str]:
    """(the least ms for ``nbytes`` moved and ``ops`` float32 operations,
    "bytes" or "operations": which of the two sets it)."""
    t_bytes, t_ops = nbytes / PEAK_BYTES_S, ops / PEAK_F32_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")
