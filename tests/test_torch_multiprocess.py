"""The port's multi-process paths on the CPU: two processes joined by
``parallel.mesh.initialize_multihost`` over gloo run the pixel-sharded GN
linearization and step (``parallel/sharded.py``) and the edge-sharded
Sim(3) refinement (``graph/ba.py::refine_sharded``), held against the JAX
package's single-device ``_gn_quantities`` and ``ba.refine`` on the same
numpy inputs.  The JAX package's own test of its sharded paths is
``tests/test_multihost.py``.

The children import only torch and the port; this process computes the
JAX references.  Tolerances: H and g within 1e-4 relative to their
largest entry (float32 sums of ~3,000 pixel terms, split at another row
and summed in another order; the JAX package holds its sharded H at
2e-4); the GN step within 1e-5 per component; the refined nodes within
1e-4 of the port's unsharded ``refine`` and of the JAX package's
``refine`` (BA_TOL below); run in float64, the sharded and unsharded
refinements agree within 1e-10.  The template has 47 rows, so two ranks pad one
row, and the graph 19 edges, so ``refine_sharded`` pads one edge.
"""

import os
import socket
import subprocess
import sys
import textwrap

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from egomotion_with_local_loop_closures_tpu.config import (
    ELLCConfig as JaxConfig)
from egomotion_with_local_loop_closures_tpu.geom import lie as jlie
from egomotion_with_local_loop_closures_tpu.geom import linear as jlinear
from egomotion_with_local_loop_closures_tpu.graph import ba as jba
from egomotion_with_local_loop_closures_tpu.graph import sim3 as jsim3
from egomotion_with_local_loop_closures_tpu.track import alignment as jal

from egomotion_with_local_loop_closures_tpu_torch.graph import ba, sim3

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CAMERA = dict(rows=47, cols=64, fx=55.0, fy=55.0, cx=32.0, cy=23.5)
GN_TOL, STEP_TOL = 1e-4, 1e-5
# The sharded and unsharded refinements are one computation with the float
# sums in another order: in float64 they agree within 6.4e-14 (BA_F64_TOL
# holds them to 1e-10), in float32 they part by 3.3e-5 on some CPUs.  The
# float32 spread of the unsharded refine over the order of its 19 edges
# (the reversed list and 19 seeded permutations, one thread) reached
# 7.8e-5, median 2.8e-5, so the float32 nodes are held within 1e-4, of
# the port's refine and of the JAX package's alike (the same float32
# computation in a third order: 6.0e-5 from the sharded nodes on that CPU).
BA_TOL, BA_JAX_TOL, BA_F64_TOL = 1e-4, 1e-4, 1e-10

_CHILD = textwrap.dedent("""
    import sys
    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import distribute_tensor

    torch.set_num_threads(1)
    from egomotion_with_local_loop_closures_tpu_torch.config import ELLCConfig
    from egomotion_with_local_loop_closures_tpu_torch.graph import ba, sim3
    from egomotion_with_local_loop_closures_tpu_torch.parallel import (
        mesh as mesh_mod, sharded)
    from egomotion_with_local_loop_closures_tpu_torch.track import alignment

    rank, port, data, out = sys.argv[1], sys.argv[2], sys.argv[3], sys.argv[4]
    mesh_mod.initialize_multihost(f"127.0.0.1:{port}", 2, int(rank),
                                  backend="gloo")
    assert dist.get_world_size() == 2
    d = dict(np.load(data))
    t = {k: torch.as_tensor(v) for k, v in d.items()}
    cfg = ELLCConfig(**{k: d["camera_" + k].item() for k in
                        ("rows", "cols", "fx", "fy", "cx", "cy")})
    kf = alignment.KeyframeLevel(t["img0"], t["depth"], t["var"])
    cur = alignment.CurrentLevel(t["img1"], t["gx"], t["gy"])

    # the pixel axis of a (1, 2) mesh, then the default group
    m = mesh_mod.make_mesh(video=1, pixel=2, device_type="cpu")
    H, g = sharded.sharded_gn_quantities(kf, cur, t["pose"], 0, cfg, m)
    H2, g2 = sharded.sharded_gn_quantities(kf, cur, t["pose"], 0, cfg)
    assert torch.equal(H, H2) and torch.equal(g, g2)
    step = sharded.sharded_gn_step(kf, cur, t["pose"], 0, cfg, m)

    # a (2, 1) mesh: each rank holds its video's row of a sharded tensor
    vm = mesh_mod.make_mesh(video=2, pixel=1, device_type="cpu")
    x = torch.arange(10, dtype=torch.float32).reshape(2, 5)
    local = distribute_tensor(x, vm, mesh_mod.video_sharding(vm)).to_local()
    assert torch.equal(local, x[int(rank):int(rank) + 1]), local
    rep = distribute_tensor(x, vm, mesh_mod.replicated(vm)).to_local()
    assert torch.equal(rep, x)

    graph = sim3.Sim3Graph(t["nodes"], t["edges"], t["meas"], t["weights"])
    res = ba.refine_sharded(graph, num_iters=6, cg_iters=20)
    graph64 = sim3.Sim3Graph(t["nodes"].double(), t["edges"],
                             t["meas"].double(), t["weights"].double())
    res64 = ba.refine_sharded(graph64, num_iters=6, cg_iters=20)
    np.savez(out, H=H.numpy(), g=g.numpy(), step=step.numpy(),
             nodes=res.nodes.numpy(), rms=res.rms_history.numpy(),
             nodes64=res64.nodes.numpy())
    dist.destroy_process_group()
    print(f"child {rank} OK", flush=True)
""")


def _gn_inputs():
    rng = np.random.default_rng(1)
    H, W = CAMERA["rows"], CAMERA["cols"]
    img0 = rng.uniform(0, 255, (H, W)).astype(np.float32)
    img1 = (np.roll(img0, 1, axis=1) * 0.98).astype(np.float32)
    depth = (1.0 + 0.2 * rng.uniform(size=(H, W))).astype(np.float32)
    depth[rng.uniform(size=(H, W)) < 0.3] = 0.0
    return dict(img0=img0, img1=img1, depth=depth,
                var=np.full((H, W), 1e-3, np.float32),
                gx=np.gradient(img1, axis=1).astype(np.float32),
                gy=np.gradient(img1, axis=0).astype(np.float32),
                pose=np.asarray([0.002, -0.001, 0.001, 0.01, 0.004, -0.003],
                                np.float32))


def _graph_inputs():
    """A seeded 12-node Sim(3) graph: the chain and eight two-hop edges,
    19 in all, measured with noise, nodes started off the truth."""
    rng = np.random.default_rng(0)
    n = 12
    gt = np.cumsum(rng.normal(size=(n, 7)) * 0.05, axis=0).astype(np.float32)
    gt[:, 6] *= 0.2                                        # log-scale
    gt[0] = 0.0
    edges = np.asarray([(k, k + 1) for k in range(n - 1)]
                       + [(k, k + 2) for k in range(8)], np.int64)
    X = sim3.exp_sim3(torch.as_tensor(gt))
    meas = sim3.log_sim3(X[edges[:, 1]] @ sim3.inv_sim3(X[edges[:, 0]])
                         ).numpy()
    meas = (meas + rng.normal(size=meas.shape) * 0.005).astype(np.float32)
    nodes = (gt + rng.normal(size=gt.shape) * 0.03).astype(np.float32)
    nodes[0] = 0.0
    return dict(nodes=nodes, edges=edges, meas=meas,
                weights=np.ones(len(edges), np.float32))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Both children's results and the inputs they were given."""
    tmp = tmp_path_factory.mktemp("multiprocess")
    inputs = {**_gn_inputs(), **_graph_inputs(),
              **{"camera_" + k: np.asarray(v) for k, v in CAMERA.items()}}
    data = tmp / "inputs.npz"
    np.savez(data, **inputs)
    script = tmp / "child.py"
    script.write_text(_CHILD)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(r), str(port), str(data),
         str(tmp / f"rank{r}.npz")], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, env=env, text=True) for r in range(2)]
    outs = []
    for p in procs:
        try:
            outs.append(p.communicate(timeout=180)[0])
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0 and f"child {r} OK" in out, out[-4000:]
    return inputs, [dict(np.load(tmp / f"rank{r}.npz")) for r in range(2)]


def _jax_gn(inputs):
    cfg = JaxConfig(**CAMERA)
    kf = jal.KeyframeLevel(*(jnp.asarray(inputs[k])
                             for k in ("img0", "depth", "var")))
    cur = jal.CurrentLevel(*(jnp.asarray(inputs[k])
                             for k in ("img1", "gx", "gy")))
    H, g, _, _, _ = jal._gn_quantities(kf, cur, jnp.asarray(inputs["pose"]),
                                       cfg.level_intrinsics(0), cfg)
    return np.asarray(H), np.asarray(g)


def test_sharded_gn_quantities_match_jax_single_device(ranks):
    inputs, results = ranks
    H, g = _jax_gn(inputs)
    for res in results:
        np.testing.assert_allclose(res["H"], H, rtol=0,
                                   atol=GN_TOL * np.abs(H).max())
        np.testing.assert_allclose(res["g"], g, rtol=0,
                                   atol=GN_TOL * np.abs(g).max())
    np.testing.assert_array_equal(results[0]["H"], results[1]["H"])


def test_sharded_gn_step_matches_jax_single_device(ranks):
    inputs, results = ranks
    H, g = _jax_gn(inputs)
    delta = -jlinear.solve_spd(jnp.asarray(H) + 1e-12 * jnp.eye(6),
                               jnp.asarray(g))
    assert bool(jnp.all(jnp.isfinite(delta)))
    want = np.asarray(jlie.compose(delta, jnp.asarray(inputs["pose"])))
    for res in results:
        np.testing.assert_allclose(res["step"], want, rtol=0, atol=STEP_TOL)


def test_refine_sharded_matches_jax_refine(ranks):
    inputs, results = ranks
    graph = jsim3.Sim3Graph(jnp.asarray(inputs["nodes"]),
                            jnp.asarray(inputs["edges"], jnp.int32),
                            jnp.asarray(inputs["meas"]),
                            jnp.asarray(inputs["weights"]))
    want = jba.refine(graph, num_iters=6, cg_iters=20)
    own = ba.refine(sim3.Sim3Graph(*(torch.as_tensor(inputs[k]) for k in (
        "nodes", "edges", "meas", "weights"))), num_iters=6, cg_iters=20)
    own64 = ba.refine(sim3.Sim3Graph(*(
        torch.as_tensor(inputs[k]).double() if k != "edges"
        else torch.as_tensor(inputs[k])
        for k in ("nodes", "edges", "meas", "weights"))),
        num_iters=6, cg_iters=20)
    for res in results:
        np.testing.assert_allclose(res["nodes64"], own64.nodes.numpy(),
                                   rtol=0, atol=BA_F64_TOL)
        np.testing.assert_allclose(res["nodes"], own.nodes.numpy(), rtol=0,
                                   atol=BA_TOL)
        np.testing.assert_allclose(res["nodes"], np.asarray(want.nodes),
                                   rtol=0, atol=BA_JAX_TOL)
    np.testing.assert_array_equal(results[0]["nodes"], results[1]["nodes"])
    # the RMS counts the padding edge's zero residual, 19/20 of refine's
    # mean square (within 1e-3: past the first iteration the mean square
    # is ~1e-5, where the nodes' 1e-5 differences move its fourth digit)
    np.testing.assert_allclose(results[0]["rms"] ** 2 * 20 / 19,
                               np.asarray(want.rms_history) ** 2, rtol=1e-3)


@pytest.mark.parametrize("start,stop", [(0, 47), (0, 24), (24, 47)])
def test_gn_quantities_of_a_row_block_match_jax(start, stop):
    """``y_offset``: rows start..stop of the template, linearized as
    those rows of the whole template, in this process."""
    from egomotion_with_local_loop_closures_tpu_torch.config import (
        ELLCConfig)
    from egomotion_with_local_loop_closures_tpu_torch.track import alignment
    inputs = _gn_inputs()
    cfg, jcfg = ELLCConfig(**CAMERA), JaxConfig(**CAMERA)
    rows = slice(start, stop)
    kf = [inputs[k][rows] for k in ("img0", "depth", "var")]
    cur = [inputs[k] for k in ("img1", "gx", "gy")]
    H, g, _, _ = alignment._gn_quantities(
        alignment.KeyframeLevel(*map(torch.as_tensor, kf)),
        alignment.CurrentLevel(*map(torch.as_tensor, cur)),
        torch.as_tensor(inputs["pose"]), cfg.level_intrinsics(0), cfg,
        y_offset=start)
    Hj, gj, _, _, _ = jal._gn_quantities(
        jal.KeyframeLevel(*map(jnp.asarray, kf)),
        jal.CurrentLevel(*map(jnp.asarray, cur)),
        jnp.asarray(inputs["pose"]), jcfg.level_intrinsics(0), jcfg,
        y_offset=start)
    np.testing.assert_allclose(H.numpy(), np.asarray(Hj), rtol=0,
                               atol=GN_TOL * np.abs(np.asarray(Hj)).max())
    np.testing.assert_allclose(g.numpy(), np.asarray(gj), rtol=0,
                               atol=GN_TOL * np.abs(np.asarray(gj)).max())


def test_pad_edges_adds_zero_contributions():
    g = _graph_inputs()
    tg = sim3.Sim3Graph(*(torch.as_tensor(g[k]) for k in
                          ("nodes", "edges", "meas", "weights")))
    padded = ba.pad_edges(tg, 4)
    jg = jba.pad_edges(jsim3.Sim3Graph(
        jnp.asarray(g["nodes"]), jnp.asarray(g["edges"], jnp.int32),
        jnp.asarray(g["meas"]), jnp.asarray(g["weights"])), 4)
    assert padded.edges.shape == (20, 2) and ba.pad_edges(padded, 4) is padded
    for name in ("edges", "meas", "weights"):
        np.testing.assert_array_equal(getattr(padded, name).numpy(),
                                      np.asarray(getattr(jg, name)))
    r, _, _, w = ba._linearize(padded.nodes, padded.edges[19:],
                               padded.meas[19:], padded.weights[19:], 0.05)
    assert float(torch.abs(r).max()) == 0.0 and float(w.abs().max()) == 0.0
    # the zero-weight edges add nothing to the gradient, the blocks or the
    # solve: refine on the padded graph gives the same nodes
    torch.testing.assert_close(ba.refine(padded, num_iters=4).nodes,
                               ba.refine(tg, num_iters=4).nodes,
                               rtol=0, atol=1e-6)
