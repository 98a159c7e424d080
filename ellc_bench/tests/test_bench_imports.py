"""No module of the benchmark imports JAX or the JAX package, and the
plain reference, the renderer and the yardstick import nothing of the
port.  Top-level module names are compared whole: the port's name begins
with the JAX package's."""

import ast
import os
import subprocess
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
JAX = {"jax", "jaxlib", "flax", "egomotion_with_local_loop_closures_tpu"}
PORT = "egomotion_with_local_loop_closures_tpu_torch"
# folders and modules that take nothing from the program
INDEPENDENT = ("reference", "frames", "roofline", "compare.py",
               "accuracy.py", "trace.py")


def _modules():
    for dirpath, _, files in os.walk(BENCH):
        if "/." in dirpath:
            continue
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def _imports(path):
    """The top-level names that the module at ``path`` imports, anywhere
    in it (functions included)."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", sorted(_modules()),
                         ids=lambda p: os.path.relpath(p, BENCH))
def test_bench_no_jax_import(path):
    assert not _imports(path) & JAX


@pytest.mark.parametrize("path", sorted(
    p for p in _modules()
    if os.path.relpath(p, BENCH).startswith(INDEPENDENT)),
    ids=lambda p: os.path.relpath(p, BENCH))
def test_bench_reference_imports_no_port(path):
    assert PORT not in _imports(path)


def test_bench_reference_loads_alone():
    """Importing the whole reference, renderer and yardstick loads neither
    the port nor JAX."""
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "import ellc_bench.reference.pipeline, ellc_bench.reference.control\n"
        "import ellc_bench.frames.render, ellc_bench.roofline.work\n"
        "import ellc_bench.compare, ellc_bench.accuracy, ellc_bench.trace\n"
        "bad = sorted({m.split('.')[0] for m in sys.modules} & %r)\n"
        "port = [m for m in sys.modules if m.split('.')[0] == %r]\n"
        "print(bad, port)\n"
        "assert not bad and not port\n" % (ROOT, JAX, PORT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
