"""The port's timing and tracing utilities (utils/profiling.py), modelled
on the JAX package's tests/test_profiling.py: the stopwatch, stage timer
and meters behave as the JAX package's do, the stage report is the same
text for the same statistics, and the trace writes a Chrome trace.
Times are host wall-clock and compared only by their floor (the 10 ms
sleep)."""

import json
import time

import numpy as np
import torch

from egomotion_with_local_loop_closures_tpu.utils import profiling as jprof

from egomotion_with_local_loop_closures_tpu_torch.utils import profiling

torch.set_num_threads(1)


def test_stopwatch():
    sw = profiling.Stopwatch()
    sw.start()
    time.sleep(0.01)
    assert sw.stop_ms() >= 9.0


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


def test_meters():
    m = profiling.Meters("cpu")
    m._t0 -= 100.0          # 100 s ago: two reads of the rate agree
    m.frames += 16
    m.keyframes += 2
    d = m.as_dict()
    ref = jprof.Meters()
    assert set(d) == set(ref.as_dict())
    assert d["frames"] == 16 and d["keyframes"] == 2 and d["fps"] > 0
    # one device on the CPU: per chip is the whole rate
    assert np.isclose(d["fps_per_chip"], d["fps"], rtol=1e-4)


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
