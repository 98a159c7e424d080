"""Configurations, traffic mixes, drivers and per-layer metrics load by
their names in ``BENCHMARK.json`` from files of their own, and a new file
is picked up with no edit to a file that is there."""

import hashlib
import json
import os
import shutil

import pytest

from ellc_bench import harness

ROOT = harness.ROOT


def _bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("cell", [w["name"] for w in _bench()["workloads"]])
def test_bench_cell_loads(cell):
    spec = harness.cell_spec(cell)
    assert spec["config"]["name"] == spec["cell"]["config"]
    assert spec["traffic"]["name"] == spec["cell"]["traffic"]
    mod = harness.load_driver(spec["config"]["entry"])
    assert any(m["name"] == mod.Driver.RATE_METRIC
               for m in spec["end_to_end"])
    assert {m["name"] for m in spec["end_to_end"]} == {
        "setup_s", mod.Driver.RATE_METRIC}
    for m in spec["per_layer"]:
        assert callable(harness.load_metric(m["name"]).read)


def test_bench_metrics_read_nothing_from_nothing():
    """A reader that finds nothing to read returns None, never 0."""
    ctx = dict(trace=None, spans={}, counters={}, work={}, config=None)
    for m in _bench()["per_layer"]:
        assert harness.load_metric(m["name"]).read(ctx) is None, m["name"]


def _digest(root):
    out = {}
    for dirpath, _, files in os.walk(os.path.join(root, "ellc_bench")):
        for f in files:
            p = os.path.join(dirpath, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = hashlib.sha256(
                    fh.read()).hexdigest()
    return out


def test_bench_new_files_are_found(tmp_path):
    root = str(tmp_path)
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root)
    shutil.copytree(os.path.join(ROOT, "ellc_bench"),
                    os.path.join(root, "ellc_bench"),
                    ignore=shutil.ignore_patterns("__pycache__", ".*"))
    before = _digest(root)
    bench = _bench()
    cell = bench["workloads"][0]
    # a new traffic mix, a new cell and a new per-layer metric, as files
    with open(os.path.join(root, "ellc_bench", "traffic",
                           cell["traffic"] + ".json")) as f:
        mix = json.load(f)
    mix.update(name="new_mix", videos=2)
    with open(os.path.join(root, "ellc_bench", "traffic", "new_mix.json"),
              "w") as f:
        json.dump(mix, f)
    with open(os.path.join(root, "ellc_bench", "metrics",
                           "passes_seen.new.py"), "w") as f:
        f.write("def read(ctx):\n    return ctx['counters'].get('passes')\n")
    bench["workloads"].append(dict(cell, name="new_cell", traffic="new_mix"))
    bench["per_layer"].append({
        "name": "passes_seen.new", "unit": "passes", "better": "higher",
        "source": "program_counter", "layer": "harness",
        "moves": bench["end_to_end"][0]["name"], "workloads": ["new_cell"]})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    spec = harness.cell_spec("new_cell", root)
    assert spec["traffic"]["videos"] == 2
    assert [m["name"] for m in spec["per_layer"]] == ["passes_seen.new"]
    reader = harness.load_metric("passes_seen.new", root)
    assert reader.read(dict(counters={"passes": 3})) == 3
    after = _digest(root)
    assert {k: v for k, v in after.items() if k in before} == before
