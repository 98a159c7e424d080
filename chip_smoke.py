#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one CUDA card.

Run from the root of a checkout:  python3 chip_smoke.py

Phases, each announced on its own line:

1. toolchain: torch, CUDA, nvcc, triton, and the card's name and power
   limit from nvidia-smi;
2. build: compiles the K3 kernel (csrc/reg_kernel.cu) from this checkout
   and prints each instantiation's registers, stack and shared memory and
   its static SASS instruction count (cuobjdump);
3. K3 against its plain PyTorch version on the card, bit for bit (NaN
   equal to NaN), on a numpy-seeded state with holes and on a real state
   from the pipeline at 480x270, and on states whose border pixels are
   valid at 480x270 and at the ragged shapes 37x53 and 21x100, for both
   remove_occlusions and both hole-fill modes; then the time of each on
   the card at 480x270 (CUDA events; the JSON line reports the card's
   time per call from CUDA-graph replays, in turns with the plain
   version, the printed line also one eager call's latency, host
   dispatch included);
4. main path: runner.run_sequence over the first 129 frames of
   reference_build/run_gn at 480x270 under the parity config; K3's launch
   counts must equal what the frame schedule implies, every pose must be
   finite and seeds% positive; prints tracked frames/s after the first
   interval;
5. golden: the first 17 frames against the JAX package's output
   (tests/data/port_golden_run_gn.json, written by
   tools/make_port_golden.py): max |pose component difference| <= 1e-3
   over the first interval, seeds% within 2 points on every frame;
6. LC bootstrap: ellc_lc.run_ellc_lc over the first 80 frames of
   reference_build/run_lc with max_frames=80 (the reference binary's
   ``1 10 1`` run: 79 tracked frames, one rotation averaging, no replay)
   against the JAX package's output (tests/data/port_golden_run_lc.json,
   tools/make_port_golden.py --lc): the same loop-edge pairs, KL within
   1e-4, edge rotation components within 4.4e-3 rad (0.25 degrees),
   corrected poses within 1e-2 per component; K3's launch counts equal
   the LC schedule; prints the edge pairs in common with the binary's
   matchframes_globalopt.txt;
7. LC mode: run_ellc_lc over exactly 144 frames of run_lc, no
   max_frames: the bootstrap batch and two batches of 32 frames, each
   rotation-averaged and replayed, the stream ending on a batch boundary;
   every pose finite, frame ids 2..144 once each, three batches, at least
   one loop edge, K3's launch counts equal to the schedule with replays;
   prints LC frames/s and the time of each phase (track, window, ra,
   replay).

Each driven path (phases 4, 6 and 7) sets K3's launch counts to 0 just
before it and reads them just after.  The last lines are one JSON object
describing each kernel (``launches`` from phase 4, and every path's count
under ``launches_by_path``; its bound is
the larger of its compulsory bytes over 3.35 TB/s and its float32
operations on this run's data over 67 TFLOP/s, the H100 SXM's published
peaks), the nvidia-smi line, and ``{"ok": true, "device": {...}}``.
Any failed phase raises and the script exits non-zero; without a CUDA
card, or outside a checkout, it exits non-zero before printing any
result.  It never imports jax or the JAX package.
"""

from __future__ import annotations

import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
PKG = "egomotion_with_local_loop_closures_tpu_torch"
FRAMES = os.path.join(ROOT, "reference_build", "run_gn", "frames_480x270.npz")
GOLDEN = os.path.join(ROOT, "tests", "data", "port_golden_run_gn.json")
LC_GOLDEN = os.path.join(ROOT, "tests", "data", "port_golden_run_lc.json")
LC_EDGES = os.path.join(ROOT, "reference_build", "run_lc", "outputs",
                        "matchframes_globalopt.txt")
MAIN_FRAMES = 129
LC_BOOTSTRAP_FRAMES, LC_FRAMES = 80, 144
# K3 launches of the two LC runs, counted by hand from the frame schedule
# (K = 8; the init launches one regularize, a track_refine step one
# do_regularization, a keyframe step two and one regularize).  Phase 6,
# 80 frames with max_frames=80: one batch of frames 2..80, keyframes 8,
# 16, ..., 80, so 69 track_refine steps and 10 keyframe steps, no replay:
# 69 + 2 x 10 = 89 and 1 + 10 = 11.  Phase 7, 144 frames: that batch and
# its replay (89 and 10 each), then frames 81..112 and 113..144, each 28
# track_refine and 4 keyframe steps, each replayed (36 and 4, four times):
# 89 + 89 + 4 x 36 = 322 and 1 + 10 + 10 + 4 x 4 = 37.
LC_BOOTSTRAP_LAUNCHES = {"do_regularization": 89, "regularize": 11}
LC_MODE_LAUNCHES = {"do_regularization": 322, "regularize": 37}
# H100 SXM published peaks (NVIDIA data sheet): HBM3 bytes/s, float32
# FLOP/s outside the tensor cores
PEAK_BYTES_S, PEAK_F32_S = 3.35e12, 67e12
# seeds% within 2 points, not 1: frame 17 is the first stereo pass against
# keyframe 16 with a one-frame baseline, where the epipolar gates hang on
# the last bits of the pose (measured 1.05 points on a one-thread CPU run,
# 0.58 on the H100)
POSE_TOL, SEEDS_TOL = 1e-3, 2.0


def phase(name: str) -> None:
    print(f"== {name}", flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def run(cmd) -> str:
    return subprocess.run(cmd, capture_output=True, text=True,
                          check=True).stdout.strip()


def schedule(n_frames: int, K: int):
    """(track_refine steps, keyframe steps) that run_sequence runs on
    n_frames frames: frame 1 initializes, frames 2..K form the first
    interval, then K frames per interval, then a per-frame tail."""
    tracked = n_frames - 1
    if tracked < K - 1:
        return tracked, 0
    n_kf = 1 + (tracked - (K - 1)) // K
    return tracked - n_kf, n_kf


def random_planes(seed, shape):
    """A numpy-seeded hypothesis state with holes, outliers and varied
    validity: the same arrays as random_planes in
    tests/test_torch_reg_kernel.py, and the two must stay identical."""
    import numpy as np
    rng = np.random.default_rng(seed)
    H, W = shape
    f32 = np.float32
    mg = (12.0 * rng.uniform(size=shape)).astype(f32)
    interior = np.zeros(shape, bool)
    interior[1:H - 1, 1:W - 1] = True
    valid = interior & (mg > 1.0) & (rng.uniform(size=shape) > 0.3)
    idepth = (0.5 + rng.uniform(size=shape)).astype(f32)
    idepth = np.where(rng.uniform(size=shape) < 0.1, 3.0 * idepth,
                      idepth).astype(f32)
    var = (0.002 + 0.05 * rng.uniform(size=shape)).astype(f32)
    planes = dict(
        idepth=np.where(valid, idepth, 0.0).astype(f32),
        var=np.where(valid, var, 0.0).astype(f32),
        idepth_smoothed=np.where(valid, idepth, -1.0).astype(f32),
        var_smoothed=np.where(valid, var, -1.0).astype(f32),
        validity=np.where(valid, rng.uniform(0.0, 60.0, size=shape),
                          0.0).astype(f32),
        blacklisted=rng.integers(-3, 2, size=shape).astype(np.int32),
        valid=valid)
    return planes, mg


def border_planes(seed, shape):
    """As random_planes, with every border row and column valid and
    carrying varied var and validity: the same arrays as border_planes in
    tests/test_torch_reg_kernel.py, and the two must stay identical."""
    import numpy as np
    planes, mg = random_planes(seed, shape)
    rng = np.random.default_rng(seed + 1000)
    H, W = shape
    border = np.ones(shape, bool)
    border[2:H - 2, 2:W - 2] = False
    valid = planes["valid"] | border
    f32 = np.float32
    idepth = (0.5 + rng.uniform(size=shape)).astype(f32)
    var = (0.002 + 0.05 * rng.uniform(size=shape)).astype(f32)
    new = ~planes["valid"] & border
    for name, v in (("idepth", idepth), ("var", var),
                    ("idepth_smoothed", idepth), ("var_smoothed", var),
                    ("validity", rng.uniform(0.0, 60.0, size=shape))):
        planes[name] = np.where(new, v, planes[name]).astype(f32)
    planes["valid"] = valid
    return planes, mg


def compare(ref, got, fields):
    """Every plane equal bit for bit (NaN equal to NaN); returns the
    largest absolute float difference, 0 when it passes."""
    import torch
    worst = 0.0
    for name in fields:
        a, b = getattr(ref, name), getattr(got, name)
        if a.dtype == torch.float32:
            d = (a - b).abs().nan_to_num(0.0)
            worst = max(worst, float(d.max()) if d.numel() else 0.0)
        torch.testing.assert_close(b, a, rtol=0, atol=0, equal_nan=True,
                                   msg=lambda m: f"{name}: {m}")
    return worst


def kernel_label(mangled):
    """reg_kernel<kFill, kOccl> from a mangled kernel name."""
    m = re.search(r"reg_kernelILb(\d)ELb(\d)E", mangled)
    return (f"reg_kernel<fill={m.group(1)}, occl={m.group(2)}>" if m
            else mangled)


def tile_of(src):
    """(rows, columns) of the output tile a block of csrc/reg_kernel.cu
    owns, one thread a pixel, from its kTileY and kTileX."""
    dims = dict(re.findall(r"constexpr int (kTile[XY]) = (\d+);", src))
    check(set(dims) == {"kTileX", "kTileY"}, "reg_kernel.cu declares its tile")
    return int(dims["kTileY"]), int(dims["kTileX"])


def kernel_resources(lib_path, cuobjdump):
    """{kernel: its registers, stack and shared memory} (cuobjdump
    -res-usage: the numbers ptxas -v prints)."""
    res, name = {}, None
    for line in run([cuobjdump, "-res-usage", str(lib_path)]).splitlines():
        m = re.search(r"Function (\S+):", line)
        if m:
            name = kernel_label(m.group(1))
        elif "REG:" in line and name:
            res[name] = " ".join(line.split()[:4])
    return res


def sass_counts(lib_path, cuobjdump):
    """Static SASS instructions of each kernel in the library, NOPs left
    out: {kernel: [count of each part between two barriers]}."""
    out = run([cuobjdump, "-sass", str(lib_path)])
    counts, name = {}, None
    for line in out.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = kernel_label(m.group(1))
            counts[name] = [0]
            continue
        m = re.search(r"/\*[0-9a-f]{4,}\*/\s+(.*?)\s*;", line)
        if name is None or not m or m.group(1).split()[0] == "NOP":
            continue
        counts[name][-1] += 1
        if "BAR.SYNC" in m.group(1):
            counts[name].append(0)
    return counts


def k3_work(state, maxg, cfg, occl, filled):
    """(compulsory bytes, float32 operations) of one K3 call on this data.
    Bytes: each input plane read once, each output plane written once.
    Operations, each add, sub, mul, div or compare one: with the fill,
    2 a valid pixel (1/var and its product with idepth) and 101 a hole
    that passes the region and gradient gates (75 tap sums, the validity
    score, the division); the smoothing, 12 a valid pixel after the fill
    (six reciprocals) and 25 taps of 9 (12 with remove_occlusions) plus 3
    a pixel it touches.  ``filled``: the state after the fill (``state``
    without it)."""
    from egomotion_with_local_loop_closures_tpu_torch.depth.state import (
        FIELDS)
    from egomotion_with_local_loop_closures_tpu_torch.ops import reg_kernel
    H, W = state.valid.shape
    planes = [getattr(state, n) for n in FIELDS]
    written = FIELDS if maxg is not None else reg_kernel._SMOOTHED
    nbytes = sum(t.numel() * t.element_size() for t in planes)
    nbytes += sum(getattr(state, n).numel() * getattr(state, n).element_size()
                  for n in written)
    ops = 0
    if maxg is not None:
        nbytes += maxg.numel() * maxg.element_size()
        holes = ~state.valid[3:H - 3, 3:W - 2] & (
            maxg[3:H - 3, 3:W - 2] >= cfg.min_abs_grad_decrease)
        ops += 2 * int(state.valid.sum()) + 101 * int(holes.sum())
    touched = int(filled.valid[3:H - 3, 2:W - 2].sum())
    ops += 12 * int(filled.valid.sum()) + (25 * (12 if occl else 9) + 3) \
        * touched
    return nbytes, ops


def call_ms(fn, reps=30):
    """Median time of one call between CUDA events on an idle card: the
    card's work plus the host's dispatch of it."""
    import torch
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(fn, reps):
    """The card's time per call: ``fn`` is captured once in a CUDA graph (a
    thousand launches of the plain version would fill the launch queue),
    a spin kernel holds the stream while the host queues ``reps`` replays,
    and CUDA events time the replays.  Returns (ms per call, whether the
    host's queueing stayed ahead of the card)."""
    import torch
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


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    for need in (os.path.join(ROOT, PKG, "__init__.py"), FRAMES, GOLDEN,
                 LC_GOLDEN, LC_EDGES):
        if not os.path.exists(need):
            print(f"chip_smoke: {need} is missing: run from a checkout of "
                  f"the repository", file=sys.stderr)
            return 2
    sys.path.insert(0, ROOT)
    import numpy as np

    import egomotion_with_local_loop_closures_tpu_torch as port
    from egomotion_with_local_loop_closures_tpu_torch.config import (
        ELLCConfig, PARITY_OVERRIDES)
    from egomotion_with_local_loop_closures_tpu_torch.depth import propagate
    from egomotion_with_local_loop_closures_tpu_torch.depth.state import (
        FIELDS, DepthMapState)
    from egomotion_with_local_loop_closures_tpu_torch.ops import reg_kernel
    from egomotion_with_local_loop_closures_tpu_torch.runtime import (
        ellc_lc, io as ellc_io, pipeline, runner)
    check(os.path.dirname(os.path.abspath(port.__file__))
          == os.path.join(ROOT, PKG), "the port imported from this checkout")
    check("jax" not in sys.modules, "jax stays unimported")

    # float32 everywhere: no TF32 in matrix products or convolutions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    phase("1 toolchain")
    gpu = run(["nvidia-smi", "--query-gpu=name,power.limit",
               "--format=csv,noheader"]).splitlines()[0]
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"cuda {torch.version.cuda}, device {torch.cuda.get_device_name(0)}"
          f", count {torch.cuda.device_count()}")
    print("nvcc: " + run([reg_kernel._find_nvcc(), "--version"]
                         ).splitlines()[-1])
    try:
        import triton
        print(f"triton {triton.__version__} imports")
    except ImportError as e:
        print(f"triton does not import: {e}")
    print(f"gpu (name, power limit): {gpu}")

    phase("2 build K3")
    t0 = time.perf_counter()
    lib = reg_kernel.build()
    reg_kernel._library()
    print(f"built {os.path.relpath(lib, ROOT)} in "
          f"{time.perf_counter() - t0:.2f} s")
    clock_mhz = float(run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                           "--format=csv,noheader,nounits"]).splitlines()[0])
    cuobjdump = os.path.join(os.path.dirname(reg_kernel._find_nvcc()),
                             "cuobjdump")
    resources = kernel_resources(lib, cuobjdump)
    cfg = ELLCConfig().replace(**PARITY_OVERRIDES)
    H, W = cfg.shape
    ty, tx = tile_of(reg_kernel.SOURCE.read_text())
    threads = -(-H // ty) * -(-W // tx) * ty * tx
    for fn, parts in sass_counts(lib, cuobjdump).items():
        # an upper estimate of the instruction time: the kernel runs one
        # thread per pixel of the tiles that cover the image, each thread
        # runs every instruction once, four warp instructions a clock on
        # each of 132 SMs
        instr_us = sum(parts) * threads / 32 / (132 * 4 * clock_mhz)
        print(f"{fn}: {resources.get(fn)}; {sum(parts)} SASS "
              f"instructions, by barrier {parts}; all of them on every "
              f"thread at {H}x{W} ({tx}x{ty} tiles): {instr_us:.3f} us at "
              f"{clock_mhz:.0f} MHz")

    frames = np.load(FRAMES)["frames"]
    check(frames.shape[1:] == cfg.shape, f"frames are {frames.shape[1:]}")

    phase("3 K3 against plain PyTorch, bit for bit")

    def on_card(planes_mg):
        planes, mg = planes_mg
        return (DepthMapState(**{k: torch.as_tensor(v, device=dev)
                                 for k, v in planes.items()}),
                torch.as_tensor(mg, device=dev))
    st = pipeline.init_pipeline(frames[0], cfg, dev)
    st, _, _ = pipeline.process_interval(st, list(frames[1:8]), cfg)
    real = (st.depth, st.kf.maxgrad)
    cases = [("seeded 270x480", on_card(random_planes(7, cfg.shape))),
             ("real 270x480", real),
             ("valid-border 270x480", on_card(border_planes(9, cfg.shape)))]
    cases += [(f"{kind} {H}x{W}", on_card(make(11, (H, W))))
              for H, W in ((37, 53), (21, 100))
              for kind, make in (("seeded", random_planes),
                                 ("valid-border", border_planes))]
    worst = {"do_regularization": 0.0, "regularize": 0.0}
    for label, (state, maxg) in cases:
        H, W = state.valid.shape
        for lsd in (False, True):
            c = cfg.replace(rows=H, cols=W, lsd_correct_hole_fill=lsd)
            for occl in (False, True):
                got = reg_kernel.do_regularization(state, maxg, c, occl)
                ref = propagate.do_regularization(state, maxg, c, occl)
                got_r = reg_kernel.regularize(state, c, occl)
                ref_r = propagate.regularize(state, c, occl)
                torch.cuda.synchronize()
                e1 = compare(ref, got, FIELDS)
                e2 = compare(ref_r, got_r, FIELDS)
                worst["do_regularization"] = max(worst["do_regularization"],
                                                 e1)
                worst["regularize"] = max(worst["regularize"], e2)
                print(f"{label} state, lsd_correct_hole_fill={lsd}, "
                      f"remove_occlusions={occl}: equal bit for bit "
                      f"(max abs err {e1:.3g} / {e2:.3g})")
    state, maxg = real
    timed = {
        "do_regularization": (
            lambda: reg_kernel.do_regularization(state, maxg, cfg),
            lambda: propagate.do_regularization(state, maxg, cfg)),
        "regularize": (
            lambda: reg_kernel.regularize(state, cfg, True),
            lambda: propagate.regularize(state, cfg, True)),
    }
    work = {
        "do_regularization": k3_work(
            state, maxg, cfg, False, propagate.fill_holes(state, maxg, cfg)),
        "regularize": k3_work(state, None, cfg, True, state),
    }
    times, bounds = {}, {}
    for name, (kern, plain) in timed.items():
        plain()
        kern()                                     # warm-up
        # turns plain/kernel/kernel/plain: device time per call, then the
        # latency of one call on an idle card (host dispatch included)
        runs = [device_ms(f, reps) for f, reps in
                ((plain, 10), (kern, 200), (kern, 200), (plain, 10))]
        ahead = all(a for _, a in runs)
        ts = [t for t, _ in runs]
        times[name] = ((ts[1] + ts[2]) / 2, (ts[0] + ts[3]) / 2)
        nbytes, ops = work[name]
        t_bytes, t_ops = nbytes / PEAK_BYTES_S, ops / PEAK_F32_S
        bounds[name] = (1e3 * max(t_bytes, t_ops),
                        "bytes" if t_bytes >= t_ops else "operations")
        lat_k, lat_p = call_ms(kern), call_ms(plain)
        print(f"{name} at 270x480: device time per call kernel "
              f"{times[name][0]:.5f} ms, plain {times[name][1]:.5f} ms"
              f" (turns: {' '.join(f'{t:.5f}' for t in ts)}; host "
              f"queue stayed ahead: {ahead}); latency of one call, median "
              f"of 30: kernel {lat_k:.4f} ms, plain {lat_p:.4f} ms; bound "
              f"{bounds[name][0]:.5f} ms by {bounds[name][1]} ({nbytes} B, "
              f"{ops} float32 ops: {1e6 * t_bytes:.3f} / {1e6 * t_ops:.3f} "
              f"us), {100 * bounds[name][0] / times[name][0]:.1f} % of it "
              f"reached; on {gpu}")

    phase(f"4 main path: run_sequence over {MAIN_FRAMES} frames on cuda")
    n_track, n_kf = schedule(MAIN_FRAMES, cfg.keyframe_interval)
    expect = {"do_regularization": n_track + 2 * n_kf, "regularize": 1 + n_kf}
    with tempfile.TemporaryDirectory() as out:
        torch.cuda.synchronize()
        reg_kernel.reset_launches()
        t0 = time.perf_counter()
        res = runner.run_sequence(iter(frames[:MAIN_FRAMES]), cfg, dev,
                                  out_dir=out)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(reg_kernel.launches)
        poses_file = ellc_io.read_pose_file(os.path.join(out,
                                                         "poses_orig.txt"))
        matches = ellc_io.read_pose_file(os.path.join(out, "matchframes.txt"))
    print(f"schedule: {n_track} track_refine + {n_kf} keyframe steps; K3 "
          f"launches {launches}, expected {expect}")
    check(launches == expect, "K3 launch counts match the frame schedule")
    check(len(res.frame_ids) == MAIN_FRAMES - 1, "every frame tracked")
    check(len(matches) == n_kf, "one matchframes line per keyframe")
    check(poses_file.shape == (MAIN_FRAMES - 1, 10), "poses_orig.txt shape")
    check(bool(np.isfinite(res.world_poses).all()), "poses finite")
    check(bool((res.seeds > 0).all()), "seeds% > 0 on every frame")
    (n_a, t_a), (n_b, t_b) = res.extra["block_times"][0], \
        res.extra["block_times"][-1]
    fps = (n_b - n_a) / (t_b - t_a)
    print(f"tracked {len(res.frame_ids)} frames in {wall:.3f} s; "
          f"{fps:.3f} frames/s over frames {n_a + 2}..{n_b + 1} (after the "
          f"first interval) on {gpu}; seeds% min {res.seeds.min():.2f} "
          f"last {res.seeds[-1]:.2f}")

    phase("5 golden: JAX package output, first 17 frames")
    with open(GOLDEN) as f:
        golden = json.load(f)
    n_in = golden["num_input_frames"]
    res17 = runner.run_sequence(iter(frames[:n_in]), cfg, dev)
    check(res17.frame_ids.tolist() == golden["frame_ids"], "frame ids")
    g_pose = np.asarray(golden["world_poses"])
    first = res17.frame_ids <= cfg.keyframe_interval
    d_pose = np.abs(res17.world_poses - g_pose)
    d_seeds = np.abs(res17.seeds - np.asarray(golden["seeds"]))
    print(f"max |pose diff| first interval {d_pose[first].max():.3g} "
          f"(tol {POSE_TOL}), all frames {d_pose.max():.3g}; "
          f"max |seeds% diff| {d_seeds.max():.3g} (tol {SEEDS_TOL})")
    check(d_pose[first].max() <= POSE_TOL, "poses match the golden file")
    check(d_seeds.max() <= SEEDS_TOL, "seeds% match the golden file")

    with open(LC_GOLDEN) as f:
        lc_golden = json.load(f)
    lc_cfg = ELLCConfig().replace(**lc_golden["config_overrides"])
    lc_frames = np.load(os.path.join(ROOT, lc_golden["frames_file"]))[
        "frames"]
    n_lc = lc_golden["num_input_frames"]
    check(n_lc == lc_golden["max_frames"] == LC_BOOTSTRAP_FRAMES,
          f"the LC golden file covers {LC_BOOTSTRAP_FRAMES} frames")
    phase(f"6 LC bootstrap: run_ellc_lc over {n_lc} frames of run_lc "
          f"(max_frames {lc_golden['max_frames']}) on cuda")
    expect6 = LC_BOOTSTRAP_LAUNCHES
    stats6 = {}
    torch.cuda.synchronize()
    reg_kernel.reset_launches()
    t0 = time.perf_counter()
    res6 = ellc_lc.run_ellc_lc(iter(lc_frames[:n_lc]), lc_cfg, dev,
                               max_frames=lc_golden["max_frames"],
                               stats=stats6)
    torch.cuda.synchronize()
    wall6 = time.perf_counter() - t0
    launches6 = dict(reg_kernel.launches)
    print(f"K3 launches {launches6}, expected {expect6}; {res6.num_batches} "
          f"batch(es), {len(res6.frame_ids)} corrected poses in "
          f"{wall6:.3f} s; phases (s) "
          f"{ {k: round(v, 3) for k, v in stats6.items()} }")
    check(launches6 == expect6, "K3 launch counts match the LC bootstrap")
    check(res6.num_batches == lc_golden["num_batches"], "LC batch count")
    check(res6.frame_ids.tolist() == lc_golden["frame_ids"], "LC frame ids")
    ours = [(int(e.frame_id), int(e.matched_kf_id)) for e in res6.loop_edges]
    g_edges = lc_golden["edges"]
    theirs = [(e["frame_id"], e["matched_kf_id"]) for e in g_edges]
    binary = {(int(r[0]), int(r[1]))
              for r in np.atleast_2d(np.loadtxt(LC_EDGES))}
    print(f"loop edges: {len(ours)} here, {len(theirs)} in the golden file; "
          f"against the binary's {len(binary)}: {len(binary & set(ours))} in "
          f"common, only the binary's {sorted(binary - set(ours))}, only "
          f"here {sorted(set(ours) - binary)}")
    check(ours == theirs, "loop-edge pairs equal the golden file's")
    d_kl = max(abs(e.match_value - g["match_value"])
               for e, g in zip(res6.loop_edges, g_edges))
    d_rot = max(float(np.abs(np.asarray(e.pose_wrt_matched[:3])
                             - np.asarray(g["pose_wrt_matched"][:3])).max())
                for e, g in zip(res6.loop_edges, g_edges))
    d_cor = float(np.abs(res6.world_poses
                         - np.asarray(lc_golden["world_poses"])).max())
    print(f"max |KL diff| {d_kl:.3g} (tol 1e-4), max |edge rotation diff| "
          f"{d_rot:.3g} rad (tol 4.4e-3), max |corrected pose diff| "
          f"{d_cor:.3g} (tol 1e-2)")
    check(d_kl <= 1e-4 and d_rot <= 4.4e-3 and d_cor <= 1e-2,
          "LC bootstrap matches the golden file")

    phase(f"7 LC mode: run_ellc_lc over {LC_FRAMES} frames of run_lc on "
          f"cuda")
    expect7 = LC_MODE_LAUNCHES
    stats7 = {}
    torch.cuda.synchronize()
    reg_kernel.reset_launches()
    t0 = time.perf_counter()
    res7 = ellc_lc.run_ellc_lc(iter(lc_frames[:LC_FRAMES]), lc_cfg, dev,
                               stats=stats7)
    torch.cuda.synchronize()
    wall7 = time.perf_counter() - t0
    launches7 = dict(reg_kernel.launches)
    n_push = sum(1 for f in res7.frame_ids if f % lc_cfg.keyframe_interval
                 == 0)
    print(f"K3 launches {launches7}, expected {expect7}; "
          f"{res7.num_batches} batches, {res7.num_loop_edges} loop edges, "
          f"{len(res7.frame_ids)} corrected poses")
    print(f"LC mode: {len(res7.frame_ids) / wall7:.3f} frames/s over "
          f"{len(res7.frame_ids)} frames in {wall7:.3f} s (kernel builds "
          f"done); phases (s) "
          f"{ {k: round(v, 3) for k, v in stats7.items()} }; window "
          f"{1e3 * stats7.get('window', 0.0) / n_push:.1f} ms a keyframe "
          f"push over {n_push} pushes; on {gpu}")
    check(launches7 == expect7, "K3 launch counts match the LC schedule")
    check(res7.num_batches == 3, "three LC batches")
    check(res7.frame_ids.tolist() == list(range(2, LC_FRAMES + 1)),
          "frame ids 2..144 once each")
    check(bool(np.isfinite(res7.world_poses).all()), "LC poses finite")
    check(res7.num_loop_edges >= 1, "at least one loop edge")

    src = os.path.join(PKG, "csrc", "reg_kernel.cu")
    replaces = "egomotion_with_local_loop_closures_tpu/ops/reg_kernel.py:161"
    by_path = {"gn_run_sequence": launches, "lc_bootstrap": launches6,
               "lc_mode": launches7}
    print(json.dumps({"kernels": [
        {"name": f"reg_kernel.{name}", "route": "cuda", "source": src,
         "replaces": replaces, "launches": launches[name],
         "launches_by_path": {k: v[name] for k, v in by_path.items()},
         "max_abs_err": worst[name], "ms": times[name][0],
         "plain_ms": times[name][1], "bound_ms": bounds[name][0],
         "bound_by": bounds[name][1], "library_ms": None}
        for name in ("do_regularization", "regularize")]}))
    print(gpu)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
