"""The port's graphed intervals and frame steps (runtime/graphs.py),
process_intervals and run_sequence(intervals_per_dispatch=...), at
TEST_CONFIG size.

On the CPU (one torch thread):

- the step bodies and the interval body that the CUDA graphs capture
  never wait for the host and copy no host data to the device, on four
  paths (plain GN, the loop window, a replay with an initial rotation,
  two batched videos): after one warm-up call, as a capture follows one,
  a ``TorchDispatchMode`` finds no ``_local_scalar_dense`` (``.item()``,
  ``float(t)``, ``bool(t)``), ``nonzero``, ``masked_select`` or
  ``unique`` and no ``lift_fresh``, a tensor built from host data: the
  card refuses the copy of one during a capture, even of a single
  element (a scalar written into a slice: those are ``fill_`` calls
  now);
- ``geom.linear.solve_spd`` (one Cholesky factorization and two
  triangular solves, for one system or a batch, the route a CUDA graph
  captures) against the JAX package's unrolled ``solve_spd``, within a
  few float32 units in the last place of the solution (atol 2e-6, rtol
  1e-5), and NaN where A is not positive definite;
- ``process_interval`` on a CPU state equals its step bodies called one
  by one and their outputs stacked, bit for bit, on the four paths, for
  K-1 and K frames;
- ``process_intervals`` over two intervals equals two ``process_interval``
  calls bit for bit (window off and on, with rotations, two videos), and
  matches the JAX package's ``process_intervals`` within
  tests/test_torch_pipeline.py's tolerances (poses 1e-3 a component,
  seeds% 1 point, rescale 1e-3 relative), read from
  ``tests/data/port_golden_intervals_test.json``
  (``tools/make_port_golden.py --intervals``: three JAX compiles, about 3
  minutes);
- ``run_sequence`` writes the same pose files with intervals_per_dispatch
  4 as with 1, as the JAX package's tests/test_pipeline.py holds for the
  JAX runner, reading its outputs back every four intervals instead of
  every interval.

On the card (``@pytest.mark.cuda``, skipped here; run there with
``python -m pytest tests/test_torch_graphs.py -m cuda --noconftest``):
every replayed track_refine step equals its eager body bit for bit (NaN
equal to NaN), the keyframe step too (``propagate`` merges in a fixed
order, one launch of each merge kernel), and K3's and K1's launch counts
of a replay equal
the eager step's (K1: one launch of each of its kernels per GN iteration,
the sum of the level iteration counts).  An interval's graph equals its
steps' graphs replayed one by one, bit for bit, in every state field, the
outputs and the snapshot, with the same launches, on the four paths and
for K-1 and K frames.  Two passes of one interval:
``interval_replays`` counts every ``process_interval`` call and
``graph_replays`` none, the second pass captures nothing, the graph's
bytes copied in are the state's and the K frames', and ``k1_live``
counts every align at each level's first iteration: the replays' and the
capture's eager warm-up's; a K-1 interval captures a graph of its own,
and a step called alone replays its step's graph.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from egomotion_with_local_loop_closures_tpu_torch.config import (
    PARITY_OVERRIDES, TEST_CONFIG)
from egomotion_with_local_loop_closures_tpu_torch.geom import linear
from egomotion_with_local_loop_closures_tpu_torch.ops import (
    gn_kernel, propagate_kernel, reg_kernel, stereo_kernel)
from egomotion_with_local_loop_closures_tpu_torch.parallel import sharded
from egomotion_with_local_loop_closures_tpu_torch.runtime import (
    graphs, io as ellc_io, pipeline, runner)
from egomotion_with_local_loop_closures_tpu_torch.utils import profiling

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "tests", "data",
                      "port_golden_intervals_test.json")
CFG = TEST_CONFIG.replace(**PARITY_OVERRIDES)
POSE_TOL, SEEDS_TOL = 1e-3, 1.0
# ops that wait for the host, or whose output shape depends on the data
HOST_OPS = ("_local_scalar_dense", "nonzero", "masked_select", "unique")


@pytest.fixture(scope="module")
def golden():
    with open(GOLDEN) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def frames(golden):
    return np.load(os.path.join(ROOT, golden["frames_file"]))[
        "frames"].astype(np.float32)


@pytest.fixture(scope="module")
def icfg(golden):
    """TEST_CONFIG with the golden file's keyframe interval."""
    return CFG.replace(**golden["config_overrides"])


@pytest.fixture(scope="module")
def half(frames, icfg):
    """The frames at half size (2x2 means) and their config, for the
    checks of the port against itself."""
    H, W = icfg.shape
    small = frames.reshape(-1, H // 2, 2, W // 2, 2).mean(axis=(2, 4))
    return small.astype(np.float32), icfg.replace(
        rows=H // 2, cols=W // 2, fx=icfg.fx / 2, fy=icfg.fy / 2,
        cx=icfg.cx / 2, cy=icfg.cy / 2)


class _Recorder(TorchDispatchMode):
    """Counts every aten op, and keeps the sizes of the tensors lifted
    from host data."""

    def __init__(self):
        super().__init__()
        self.ops = {}
        self.lifted = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = str(func)
        self.ops[name] = self.ops.get(name, 0) + 1
        if "lift_fresh" in name:
            self.lifted.append(args[0].numel())
        return func(*args, **(kwargs or {}))


def _start(path, frames, cfg=CFG, n=0):
    """(cfg, state, frame, rotation) of one of the four capture paths;
    with ``n``, the ``n`` frames after the init, (n, ...), and their
    rotations, (n, 6)."""
    cfg = cfg.replace(do_loop_closure=True) if path == "window" else cfg
    ids = list(range(1, 1 + max(n, 1)))
    if path == "videos":
        state = sharded.batched_init(frames[[0, 14]], cfg, "cpu")
        images = torch.stack([torch.as_tensor(frames[[k, 14 + k]])
                              for k in ids])
    else:
        state = pipeline.init_pipeline(frames[0], cfg, "cpu")
        images = torch.as_tensor(frames[ids])
    rots = torch.full((len(ids), 6), 0.01) if path == "replay" else None
    if n:
        return cfg, state, images, rots
    return cfg, state, images[0], None if rots is None else rots[0]


@pytest.mark.parametrize("step", ["_track_refine_step", "_keyframe_step",
                                  "_interval"])
@pytest.mark.parametrize("path", ["gn", "window", "replay", "videos"])
def test_step_bodies_are_capture_safe(frames, path, step):
    # the interval body over two frames: a track_refine step, a keyframe
    cfg, state, image, rot = _start(path, frames,
                                    n=2 if step == "_interval" else 0)
    fn = getattr(pipeline, step)
    replay = path == "replay"
    fn(state, image, cfg, replay, rot)         # the warm-up of a capture
    with _Recorder() as rec:
        fn(state, image, cfg, replay, rot)
    waits = {k: n for k, n in rec.ops.items()
             if any(h in k for h in HOST_OPS)}
    assert waits == {}, f"{step} on {path} waits for the host: {waits}"
    assert rec.lifted == [], (
        f"{step} on {path} copies host data to the device: tensors of "
        f"{rec.lifted} elements")
    assert sum(rec.ops.values()) > 10000        # the step did run


@pytest.mark.parametrize("batch", [(), (3,), (2, 4)])
def test_solve_spd_matches_jax(batch):
    import jax
    jax.config.update("jax_platforms", "cpu")
    from egomotion_with_local_loop_closures_tpu.geom import linear as jlinear
    rng = np.random.default_rng(len(batch))
    M = rng.normal(size=batch + (6, 6)).astype(np.float32)
    A = (M @ np.swapaxes(M, -1, -2) + 0.5 * np.eye(6)).astype(np.float32)
    b = rng.normal(size=batch + (6,)).astype(np.float32)
    ref = np.asarray(jlinear.solve_spd(A, b))
    got = linear.solve_spd(torch.as_tensor(A), torch.as_tensor(b))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=2e-6)
    # not positive definite: NaN, so callers zero the update
    bad = torch.as_tensor(A).clone()
    bad[..., 2, 2] = -1.0
    assert torch.isnan(linear.solve_spd(bad, torch.as_tensor(b))).all()


def _rotations(golden, name):
    rots = golden[name].get("init_rotations")
    return None if rots is None else torch.tensor(rots)


def _variant(name, icfg):
    return icfg.replace(do_loop_closure=True) if name == "window" else icfg


@pytest.fixture(scope="module")
def port_intervals(golden, frames, icfg):
    """The port's process_intervals over the golden file's two intervals,
    each variant from its own init on frame 0."""
    K, N = icfg.keyframe_interval, golden["intervals"]
    images = torch.as_tensor(frames[1:1 + N * K]).reshape(N, K, *icfg.shape)
    runs = {}
    for name in ("gn", "window", "replay"):
        cfg = _variant(name, icfg)
        state = pipeline.init_pipeline(frames[0], cfg, "cpu")
        runs[name] = (state, images, pipeline.process_intervals(
            state, images, cfg, replay=name == "replay",
            init_rotations=_rotations(golden, name)))
    return runs


def _leaves(tree):
    return graphs.tree_flatten(tree)[0]


def _assert_bits(got, ref):
    a, b = _leaves(got), _leaves(ref)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        torch.testing.assert_close(x, y, rtol=0, atol=0, equal_nan=True)


@pytest.mark.parametrize("name", ["gn", "window", "replay"])
def test_process_intervals_equals_process_interval_calls(
        name, golden, icfg, port_intervals):
    state, images, got = port_intervals[name]
    cfg = _variant(name, icfg)
    rots = _rotations(golden, name)
    outs, snaps = [], []
    for n in range(images.shape[0]):
        state, o, s = pipeline.process_interval(
            state, images[n], cfg, name == "replay",
            None if rots is None else rots[n])
        outs.append(o)
        snaps.append(s)
    assert got[1].seeds.shape == (images.shape[0], images.shape[1])
    _assert_bits(got[0], state)
    _assert_bits(got[1], pipeline.stack_trees(outs, 0))
    if name == "window":
        assert got[2].world_pose.shape == (images.shape[0], 6)
        _assert_bits(got[2], pipeline.stack_trees(snaps, 0))
    else:
        assert got[2] is None and snaps == [None] * len(snaps)


def _steps(fn_track, fn_keyframe, state, images, cfg, replay, rots):
    """An interval as its steps, ``fn_track`` over every frame but the
    last and ``fn_keyframe`` on the last, the outputs stacked."""
    rots = [None] * len(images) if rots is None else rots
    outs = []
    for k in range(len(images) - 1):
        state, o = fn_track(state, images[k], cfg, replay, rots[k])
        outs.append(o)
    state, o, snap = fn_keyframe(state, images[-1], cfg, replay, rots[-1])
    outs.append(o)
    return state, pipeline.stack_outputs(outs), snap


@pytest.mark.parametrize("frames_of", ["K-1", "K"])
@pytest.mark.parametrize("path", ["gn", "window", "replay", "videos"])
def test_process_interval_equals_its_step_bodies(half, path, frames_of):
    frames, icfg = half
    n = icfg.keyframe_interval - (frames_of == "K-1")
    cfg, state, images, rots = _start(path, frames, icfg, n)
    replay = path == "replay"
    got = pipeline.process_interval(state, images, cfg, replay, rots)
    assert got[1].seeds.shape == state.global_scale.shape + (n,)
    assert (got[2] is None) == (path != "window")
    _assert_bits(got, _steps(pipeline._track_refine_step,
                             pipeline._keyframe_step, state, images, cfg,
                             replay, rots))


def test_process_intervals_of_two_videos_equals_process_interval_calls(
        half):
    frames, icfg = half
    K = icfg.keyframe_interval
    videos = np.stack([frames[0:1 + 2 * K], frames[14:15 + 2 * K]])
    state = sharded.batched_init(videos[:, 0], icfg, "cpu")
    images = torch.as_tensor(videos[:, 1:]).reshape(
        2, 2, K, *icfg.shape).permute(1, 2, 0, 3, 4)     # (N, K, V, H, W)
    got = pipeline.process_intervals(state, images, icfg)
    assert got[1].seeds.shape == (2, 2, K)          # (V, N, K)
    outs = []
    for n in range(2):
        state, o = sharded.batched_process_interval(
            state, videos[:, 1 + n * K:1 + (n + 1) * K], icfg)
        outs.append(o)
    _assert_bits(got[0], state)
    _assert_bits(got[1], pipeline.stack_trees(outs, 1))


@pytest.mark.parametrize("name", ["gn", "window", "replay"])
def test_process_intervals_matches_jax(name, golden, port_intervals):
    ref = golden[name]
    outs = port_intervals[name][2][1]
    np.testing.assert_allclose(outs.pose_wrt_world.numpy(),
                               np.asarray(ref["pose_wrt_world"]),
                               atol=POSE_TOL, rtol=0)
    np.testing.assert_allclose(outs.seeds.numpy(), np.asarray(ref["seeds"]),
                               atol=SEEDS_TOL, rtol=0)
    np.testing.assert_allclose(outs.rescale.numpy(),
                               np.asarray(ref["rescale"]), rtol=1e-3)
    if name == "window":
        snaps = port_intervals[name][2][2]
        want = ref["snapshots"]
        np.testing.assert_allclose(snaps.world_pose.numpy(),
                                   np.asarray(want["world_pose"]),
                                   atol=POSE_TOL, rtol=0)
        np.testing.assert_allclose(snaps.seeds.numpy(),
                                   np.asarray(want["seeds"]),
                                   atol=SEEDS_TOL, rtol=0)


def test_intervals_per_dispatch_writes_the_same_poses(half, tmp_path):
    """11 frames, keyframes every 2: the first interval (frame 2), four
    intervals read at once (3..10) and a one-frame tail."""
    frames, icfg = half
    icfg = icfg.replace(keyframe_interval=2)
    runs = {}
    for ipd in (1, 4):
        out = tmp_path / str(ipd)
        out.mkdir()
        runs[ipd] = runner.run_sequence(iter(frames[:11]), icfg, "cpu",
                                        out_dir=str(out),
                                        intervals_per_dispatch=ipd)
    for name in ("poses_orig.txt", "matchframes.txt"):
        assert (tmp_path / "1" / name).read_bytes() == (
            tmp_path / "4" / name).read_bytes()
    r1, r4 = runs[1], runs[4]
    assert r4.frame_ids.tolist() == list(range(2, 12))
    assert r4.kf_ids.tolist() == [1, 2, 2, 4, 4, 6, 6, 8, 8, 10]
    assert len(ellc_io.read_pose_file(
        str(tmp_path / "4" / "matchframes.txt"))) == 5
    # reads: per interval plus the tail, or the first interval, four
    # intervals at once and the tail
    assert len(r1.extra["block_times"]) == 6
    assert len(r4.extra["block_times"]) == 3
    for f in dataclasses.fields(runner.RunResult):
        if f.name != "extra":
            np.testing.assert_array_equal(getattr(r1, f.name),
                                          getattr(r4, f.name))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _card(tree, device):
    return graphs.tree_unflatten(graphs.tree_flatten(tree)[1],
                             [t.to(device) for t in _leaves(tree)])


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["gn", "window", "replay", "videos"])
def test_graphed_steps_equal_eager_on_the_card(cuda_device, frames, path):
    cfg, state, image, rot = _start(path, frames)
    state, image = _card(state, cuda_device), image.to(cuda_device)
    rot = None if rot is None else rot.to(cuda_device)
    replay = path == "replay"
    eager, graphed = state, state
    k1 = gn_kernel.align_launches(
        cfg, cfg.max_iters_replay if replay else cfg.max_iters)
    for _ in range(3):
        reg_kernel.reset_launches()
        gn_kernel.reset_launches()
        stereo_kernel.reset_launches()
        eager, out_e = pipeline._track_refine_step(eager, image, cfg,
                                                   replay, rot)
        counts = (dict(reg_kernel.launches), dict(gn_kernel.launches),
                  dict(stereo_kernel.launches))
        assert counts[1] == k1
        assert counts[2] == {"stereo_observe": 1}
        reg_kernel.reset_launches()
        gn_kernel.reset_launches()
        stereo_kernel.reset_launches()
        graphed, out_g = pipeline.track_refine_step(graphed, image, cfg,
                                                    replay, rot)
        assert (reg_kernel.launches, gn_kernel.launches,
                stereo_kernel.launches) == counts
        _assert_bits((graphed, out_g), (eager, out_e))
    one_each = dict.fromkeys(propagate_kernel.KERNELS, 1)
    propagate_kernel.reset_launches()
    kf_e = pipeline._keyframe_step(eager, image, cfg, replay, rot)
    assert propagate_kernel.launches == one_each
    propagate_kernel.reset_launches()
    kf_g = pipeline.keyframe_step(graphed, image, cfg, replay, rot)
    assert propagate_kernel.launches == one_each
    _assert_bits(kf_g, kf_e)
    graphs.release()


@pytest.mark.cuda
@pytest.mark.parametrize("frames_of", ["K-1", "K"])
@pytest.mark.parametrize("path", ["gn", "window", "replay", "videos"])
def test_interval_graph_equals_step_graphs_on_the_card(cuda_device, frames,
                                                       path, frames_of):
    n = CFG.keyframe_interval - (frames_of == "K-1")
    cfg, state, images, rots = _start(path, frames, CFG, n)
    state, images = _card(state, cuda_device), images.to(cuda_device)
    rots = None if rots is None else rots.to(cuda_device)
    replay = path == "replay"
    mods = (reg_kernel, gn_kernel, stereo_kernel, propagate_kernel)
    graphs.release()
    profiling.reset_counters()
    for m in mods:
        m.reset_launches()
    got = pipeline.process_interval(state, images, cfg, replay, rots)
    launches = [dict(m.launches) for m in mods]
    counts = profiling.counters()
    assert (counts["interval_replays"], counts["graph_replays"]) == (1, 0)
    for m in mods:
        m.reset_launches()
    want = _steps(pipeline.track_refine_step, pipeline.keyframe_step,
                  state, images, cfg, replay, rots)
    assert [dict(m.launches) for m in mods] == launches
    counts = profiling.counters()
    assert (counts["interval_replays"], counts["graph_replays"]) == (1, n)
    _assert_bits(got, want)
    graphs.release()


@pytest.mark.cuda
def test_graph_counters_on_the_card(cuda_device, frames, monkeypatch):
    monkeypatch.setattr(profiling, "_k1_live", {})
    graphs.release()
    profiling.reset_counters()
    state = _card(pipeline.init_pipeline(frames[0], CFG, "cpu"),
                  cuda_device)
    images = torch.as_tensor(frames[1:1 + CFG.keyframe_interval],
                             device=cuda_device)
    K = len(images)
    pipeline.process_interval(state, images, CFG)
    first = profiling.counters()
    assert first["interval_replays"] == 1 and first["graph_replays"] == 0
    assert first["graph_captures"] == 1
    pipeline.process_interval(state, images, CFG)
    second = profiling.counters()
    assert second["interval_replays"] == 2 and second["graph_replays"] == 0
    assert second["graph_captures"] == 1
    rows = graphs.stats()
    assert [(r["step"], r["frames"]) for r in rows] == [("interval", K)]
    # the state and the K frames
    inputs = sum(t.numel() * t.element_size()
                 for t in _leaves((state, images)))
    assert rows[0]["copy_in_bytes"] == inputs
    assert rows[0]["clone_out_bytes"] > 0
    # every replay's aligns and the capture's eager warm-up's K
    table = second["k1_live"][str(images.device)]
    assert [row[0] for row in table] == [3 * K] * CFG.num_levels
    # a K-1 interval: a graph of its own; a step alone: its step's graph
    pipeline.process_interval(state, images[1:], CFG)
    pipeline.track_refine_step(state, images[0], CFG)
    third = profiling.counters()
    assert third["interval_replays"] == 3 and third["graph_replays"] == 1
    assert third["graph_captures"] == 3
    assert sorted((r["step"], r["frames"]) for r in graphs.stats()) == [
        ("interval", K - 1), ("interval", K), ("track_refine_step", 1)]
    graphs.release()
