"""The port's timing and tracing utilities (utils/profiling.py), modelled
on the JAX package's tests/test_profiling.py: the stage timer behaves as
the JAX package's does, the stage report is the same text for the same
statistics, and the trace writes a Chrome trace.

The program's own spans and counters: ``span`` is one shared null
context with no profiler recording; under a CPU ``torch.profiler`` a
``process_interval`` of two videos (from ``sharded.batched_init``)
writes ``ellc.init``, ``ellc.interval`` and one ``ellc.step.*`` range a
step inside its interval, and the plain path counts every video-align
at iteration 0 of every level of ``k1_live``; the table grows without
losing what a smaller one counted, and ``reset_counters`` zeroes it.
"""

import contextlib
import json

import numpy as np
import pytest
import torch

from egomotion_with_local_loop_closures_tpu.utils import profiling as jprof

from egomotion_with_local_loop_closures_tpu_torch.config import TEST_CONFIG
from egomotion_with_local_loop_closures_tpu_torch.parallel import sharded
from egomotion_with_local_loop_closures_tpu_torch.runtime import pipeline
from egomotion_with_local_loop_closures_tpu_torch.utils import (
    profiling, synthetic)

torch.set_num_threads(1)


def test_stage_timer_aggregates_syncs_and_skips_non_tensors():
    t = profiling.StageTimer()
    for _ in range(3):
        with t.stage("mul", sync=(torch.ones(2), "not a tensor")) as out:
            out.append(torch.ones((64, 64)) * 2.0)
            out.append({"count": 3, "x": torch.zeros(1)})
            out.append(None)
    s = t.stats["mul"]
    assert s.count == 3 and s.total_s > 0
    assert s.min_s <= s.mean_s <= s.max_s
    assert "mul" in t.report()


def test_stage_report_equals_the_jax_package():
    port, ref = profiling.StageTimer(), jprof.StageTimer()
    for name, dts in (("align", (0.25, 0.3)), ("stereo", (0.01,)),
                      ("propagate", (0.002, 0.003, 0.001))):
        for dt in dts:
            port.stats.setdefault(name, profiling.StageStats()).add(dt)
            ref.stats.setdefault(name, jprof.StageStats()).add(dt)
    assert port.report() == ref.report()
    for name in ref.stats:
        a, b = port.stats[name], ref.stats[name]
        assert (a.count, a.total_s, a.min_s, a.max_s, a.mean_s) == (
            b.count, b.total_s, b.min_s, b.max_s, b.mean_s)


def test_trace_noop():
    with profiling.trace(None) as prof:
        assert prof is None


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path)) as prof:
        x = torch.ones(256, 256)
        (x @ x).sum()
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)
    assert any("mm" in e.key for e in prof.key_averages())
    # no device on the CPU: no device time in the trace
    assert profiling.trace_device_time(str(tmp_path / "trace.json")) == (
        0.0, 0)


def test_trace_device_time_sums_kernels_copies_and_sets(tmp_path):
    events = [{"ph": "X", "cat": "kernel", "name": "k", "dur": 1500.0},
              {"ph": "X", "cat": "gpu_memcpy", "name": "c", "dur": 250.0},
              {"ph": "X", "cat": "gpu_memset", "name": "s", "dur": 250.0},
              {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "dur": 9e6},
              {"ph": "X", "cat": "cuda_runtime", "name": "launch",
               "dur": 9e6}]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events}))
    assert profiling.trace_device_time(str(path)) == (2.0, 3)


def test_span_is_one_null_context_without_a_profiler():
    a, b = profiling.span("ellc.a"), profiling.span("ellc.b")
    assert a is b and isinstance(a, contextlib.nullcontext)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        assert isinstance(profiling.span("ellc.a"),
                          torch.profiler.record_function)


# two videos of TEST_CONFIG's room at half size, three frames each
CFG = TEST_CONFIG.replace(rows=48, cols=64, fx=TEST_CONFIG.fx / 2,
                          fy=TEST_CONFIG.fy / 2, cx=TEST_CONFIG.cx / 2,
                          cy=TEST_CONFIG.cy / 2)


@pytest.fixture(scope="module")
def traced_interval(tmp_path_factory):
    """The Chrome trace's ranges (name, start, end) and the counters of a
    ``batched_init`` and a ``process_interval`` of two videos (a
    track_refine step and a keyframe step) under a CPU profiler."""
    scene = synthetic.make_room_scene(seed=0)
    steps = torch.as_tensor(np.asarray(
        [0.0, 0.002, -0.001, 0.004, 0.002, 0.006], np.float32))
    poses = torch.stack([steps * (f + v) for v in range(2)
                         for f in range(3)]).reshape(2, 3, 6)
    frames, _ = synthetic.render(scene, poses, CFG.rows, CFG.cols,
                                 *CFG.level_intrinsics(0))
    frames = torch.round(frames)
    path = tmp_path_factory.mktemp("trace") / "trace.json"
    profiling.reset_counters()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        state = sharded.batched_init(frames[:, 0], CFG, "cpu")
        pipeline.process_interval(state, frames[:, 1:].transpose(0, 1), CFG)
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    ranges = [(e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"]))
              for e in events if e.get("ph") == "X"
              and e.get("cat") == "user_annotation"
              and e["name"].startswith("ellc.")]
    return ranges, profiling.counters()


def test_process_interval_writes_nested_ranges(traced_interval):
    ranges, _ = traced_interval
    names = sorted(n for n, _, _ in ranges)
    assert names == ["ellc.init", "ellc.interval", "ellc.step.keyframe",
                     "ellc.step.track_refine"]
    at = {n: (a, b) for n, a, b in ranges}
    ia, ib = at["ellc.interval"]
    ta, tb = at["ellc.step.track_refine"]
    ka, kb = at["ellc.step.keyframe"]
    assert ia <= ta < tb <= ka < kb <= ib
    assert at["ellc.init"][1] <= ia


def test_plain_path_counts_every_video_align(traced_interval):
    """Two videos, two steps: four aligns, each live at every level's
    first iteration; no graph ran on the CPU."""
    _, counters = traced_interval
    table = counters["k1_live"]["cpu"]
    assert len(table) == CFG.num_levels
    assert len(table[0]) == max(CFG.max_iters)
    assert [row[0] for row in table] == [4] * CFG.num_levels
    for row, n in zip(table, CFG.max_iters):
        assert all(a >= b for a, b in zip(row, row[1:]))
        assert not any(row[n:])
    assert counters["interval_replays"] == counters["graph_replays"] \
        == counters["graph_captures"] == 0


def test_k1_live_grows_keeps_its_counts_and_resets(monkeypatch):
    monkeypatch.setattr(profiling, "_k1_live", {})
    monkeypatch.setattr(profiling, "_host_counts",
                        {"graph_replays": 0, "graph_captures": 0})
    cpu = torch.device("cpu")
    small = profiling.k1_live(cpu, 2, 3)
    assert small.shape == (2, 3) and small.dtype == torch.int64
    small[1, 2] += 5
    big = profiling.k1_live(cpu, 4, 2)
    assert big.shape == (4, 3) and profiling.k1_live(cpu, 1, 1) is big
    big[1, 2] += 1
    big[3, 0] += 2
    profiling.count("graph_replays", 3)
    got = profiling.counters()
    assert got["k1_live"] == {"cpu": [[0, 0, 0], [0, 0, 6], [0, 0, 0],
                                      [2, 0, 0]]}
    assert got["graph_replays"] == 3 and got["graph_captures"] == 0
    profiling.reset_counters()
    got = profiling.counters()
    assert got["k1_live"]["cpu"] == [[0] * 3] * 4
    assert got["graph_replays"] == 0
