"""The program's ``ellc.*`` ranges in a Chrome trace (``spans.py``) and the
reader of ``k1_live_roofline_pct``.

A hand-written trace of one interval: a graphed track_refine step (copy
in, replay, clone out), a keyframe step that launches outside any graph
range, a step on a second thread, and a read-back outside every range.
Its device operations carry correlation ids: a graph's two nodes share
their ``cudaGraphLaunch``'s.  The device seconds by range, the host
seconds of each range outside runtime and driver calls, and both
readings are given by hand; the trace's summary (``trace.summarize``)
reads the same with and without the ranges, but the names of its gaps."""

import json

import pytest

from ellc_bench import harness, spans, trace
from ellc_bench.roofline import peaks, work

SPAN = harness.TRACE_SPAN
HOST, OTHER, STREAM = (1, 1), (1, 2), (0, 7)


def _x(name, cat, a, b, where, corr=None):
    e = {"ph": "X", "name": name, "cat": cat, "ts": a, "dur": b - a,
         "pid": where[0], "tid": where[1]}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


RANGES = [
    ("ellc.interval", 100, 900, HOST),
    ("ellc.step.track_refine", 110, 400, HOST),
    ("ellc.graph.copy_in", 120, 200, HOST),
    ("ellc.graph.replay", 200, 300, HOST),
    ("ellc.graph.clone_out", 300, 390, HOST),
    ("ellc.step.keyframe", 450, 850, HOST),
    ("ellc.step.track_refine", 100, 200, OTHER),
]
CALLS = [  # (name, category, start, end, correlation)
    ("cudaMemcpyAsync", "cuda_runtime", 130, 140, 1),
    ("cudaMemcpyAsync", "cuda_runtime", 150, 170, 2),
    ("cudaGraphLaunch", "cuda_runtime", 210, 260, 3),
    ("cudaMemcpyAsync", "cuda_runtime", 310, 320, 4),
    ("cudaLaunchKernel", "cuda_runtime", 460, 470, 5),
    ("cuLaunchKernel", "cuda_driver", 462, 468, None),
    ("cudaMemcpyAsync", "cuda_runtime", 950, 960, 6),
]
DEVICE = [
    ("Memcpy DtoD (Device -> Device)", "gpu_memcpy", 500, 520, 1),
    ("Memcpy DtoD (Device -> Device)", "gpu_memcpy", 520, 530, 2),
    ("gn_step", "kernel", 530, 600, 3),
    ("stereo_observe", "kernel", 600, 640, 3),
    ("Memcpy DtoD (Device -> Device)", "gpu_memcpy", 640, 650, 4),
    ("reg_kernel", "kernel", 700, 750, 5),
    ("unlaunched", "kernel", 760, 770, 99),
    ("Memcpy DtoH (Device -> Pageable)", "gpu_memcpy", 970, 1100, 6),
]


def _events(with_ranges=True):
    ev = [_x(SPAN, "user_annotation", 0, 1000, HOST)]
    if with_ranges:
        ev += [_x(n, "user_annotation", a, b, w) for n, a, b, w in RANGES]
    ev += [_x(n, c, a, b, HOST, k) for n, c, a, b, k in CALLS]
    ev += [_x(n, c, a, b, STREAM, k) for n, c, a, b, k in DEVICE]
    ev.append(_x("aten::copy_", "cpu_op", 125, 175, HOST))
    return ev


def _write(tmp_path, events, name="t.json"):
    path = tmp_path / name
    path.write_text(json.dumps({"traceEvents": events}))
    return str(path)


def test_bench_span_times_by_hand(tmp_path):
    dev, host = spans.span_times(_events(), 0.0, 1000.0)
    assert dev == pytest.approx({
        "ellc.graph.copy_in": 30e-6, "ellc.graph.replay": 110e-6,
        "ellc.graph.clone_out": 10e-6, "ellc.step.keyframe": 50e-6})
    want = {"ellc.interval": [700e-6],
            "ellc.step.track_refine": [200e-6, 100e-6],
            "ellc.graph.copy_in": [50e-6], "ellc.graph.replay": [50e-6],
            "ellc.graph.clone_out": [80e-6], "ellc.step.keyframe": [390e-6]}
    assert set(host) == set(want)
    for name, values in want.items():
        assert host[name] == pytest.approx(values), name
    assert spans.host_step_ms(host) == pytest.approx(0.2)
    busy = trace.summarize(_write(tmp_path, _events()), SPAN).busy_s
    assert busy == pytest.approx(240e-6)
    assert spans.graph_copy_pct(dev, busy) == pytest.approx(100 * 40 / 240)


def test_bench_span_times_clip_to_the_window():
    """A window that ends inside the keyframe step: its kernel and half
    of the step count, the read-back does not."""
    dev, host = spans.span_times(_events(), 0.0, 740.0)
    assert dev["ellc.step.keyframe"] == pytest.approx(40e-6)
    assert host["ellc.step.keyframe"] == pytest.approx([280e-6])


def test_bench_old_fields_equal_with_and_without_ranges(tmp_path):
    a = trace.summarize(_write(tmp_path, _events(True), "a.json"), SPAN)
    b = trace.summarize(_write(tmp_path, _events(False), "b.json"), SPAN)
    assert (a.window_s, a.busy_s, a.device_s, a.launches) == (
        b.window_s, b.busy_s, b.device_s, b.launches)
    assert [d for _, d in a.gaps] == [d for _, d in b.gaps]
    assert trace.breakdown(a)["device_ops"] == trace.breakdown(b)[
        "device_ops"]
    # the gap while the host runs the keyframe step's Python is named by
    # its range, where there was no host event before
    assert ("ellc.step.keyframe", pytest.approx(10e-6)) in a.gaps
    assert ("host idle", pytest.approx(10e-6)) in b.gaps


def test_bench_readings_none_without_ranges():
    dev, host = spans.span_times(_events(False), 0.0, 1000.0)
    assert dev == {} and host == {}
    assert spans.graph_copy_pct(dev, 240e-6) is None
    assert spans.host_step_ms(host) is None


def _ctx(k1_s=1e-3):
    tr = trace.TraceSummary(window_s=1.0, busy_s=0.9,
                            device_s={"gn_step": 0.75 * k1_s,
                                      "gn_level_cluster": 0.25 * k1_s,
                                      "stereo_observe": 0.5},
                            launches={}, gaps=[])
    return dict(trace=tr, spans={}, counters={}, config=None,
                work=dict(rows=270, cols=480, levels=4, aligns=64))


def test_bench_k1_live_roofline_by_hand(monkeypatch):
    """Two devices' tables (a CPU one left out): level 0 ran 3 live
    iterations an align, level 1 2.5, level 2 1, level 3 4."""
    from egomotion_with_local_loop_closures_tpu_torch.utils import profiling
    table = [[8, 8, 8, 0], [8, 8, 4, 0], [8, 0, 0, 0], [8, 8, 8, 8]]
    monkeypatch.setattr(profiling, "counters", lambda: {
        "graph_replays": 0, "graph_captures": 0,
        "k1_live": {"cuda:0": table, "cuda:1": table,
                    "cpu": [[1, 1, 1, 1]] * 4}})
    reader = harness.load_metric("k1_live_roofline_pct")
    assert reader.live_iters(4) == [3.0, 2.5, 1.0, 4.0]
    nbytes, ops = work.align_work(270, 480, 4, 64, [3.0, 2.5, 1.0, 4.0])
    assert reader.read(_ctx()) == pytest.approx(
        100 * peaks.bound_s(nbytes, ops) / 1e-3)
    # more work than k1_roofline_pct's one iteration a level
    once = harness.load_metric("k1_roofline_pct").read(_ctx())
    assert reader.read(_ctx()) > once


def test_bench_k1_live_roofline_none_without_counts(monkeypatch):
    from egomotion_with_local_loop_closures_tpu_torch.utils import profiling
    reader = harness.load_metric("k1_live_roofline_pct")
    monkeypatch.setattr(profiling, "counters", lambda: {"k1_live": {}})
    assert reader.read(_ctx()) is None
    monkeypatch.setattr(profiling, "counters", lambda: {"k1_live": {
        "cpu": [[4, 4]] * 4}})
    assert reader.read(_ctx()) is None
    assert reader.read(_ctx(k1_s=0.0)) is None
    monkeypatch.delattr(profiling, "counters")
    assert reader.read(_ctx()) is None


def test_bench_gap_spans_by_hand(tmp_path):
    """The device's idle gaps, as ``trace.summarize`` finds them, each
    with the innermost range at its start: none before the interval, the
    keyframe step's for the three inside it."""
    got = spans.gap_spans(_events(), 0.0, 1000.0)
    want = [(None, 500e-6, 0.0), ("ellc.step.keyframe", 200e-6, 770e-6),
            ("ellc.step.keyframe", 50e-6, 650e-6),
            ("ellc.step.keyframe", 10e-6, 750e-6)]
    assert [n for n, _, _ in got] == [n for n, _, _ in want]
    assert [g[1:] for g in got] == [pytest.approx(g[1:]) for g in want]
    summary = trace.summarize(_write(tmp_path, _events()), SPAN)
    assert [d for _, d in summary.gaps] == pytest.approx(
        [d for _, d, _ in got])
