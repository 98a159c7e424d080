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
   remove_occlusions and both hole-fill modes; batches of distinct
   states in one launch (3 seeded at 480x270 and 37x53, 5 seeded at
   480x270 as in phase 8's recovery trials, and 20 at 480x270, the
   window cap, made by rolling the real state), each state held bit for
   bit against the plain version on it alone, for both
   remove_occlusions, with the fill and without; then the time of each
   on the card at 480x270, alone and as that batch of 20 (CUDA events;
   the JSON line reports the card's time per call from CUDA-graph
   replays, in turns with the plain version, the printed line also one
   eager call's latency, host dispatch included);
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
   matchframes_globalopt.txt.  It runs with do_sim3_refine: the port's
   Sim(3) refinement on the golden file's own corrected poses and edges
   must give the JAX package's refined poses within 1e-4 per component,
   and the run's refined poses must be within 1e-2 of them;
7. LC mode: run_ellc_lc over exactly 144 frames of run_lc, no
   max_frames: the bootstrap batch and two batches of 32 frames, each
   rotation-averaged and replayed, the stream ending on a batch boundary;
   every pose finite, frame ids 2..144 once each, three batches, at least
   one loop edge, K3's launch counts equal to the schedule with replays;
   prints LC frames/s and the time of each phase (track, window, ra,
   replay);
8. connection recovery: runner.run_sequence with restore_connection over
   the first 48 frames of run_gn under the parity config, frames 40 and
   41 replaced by a flat gray image, against the JAX package's run
   (tests/data/port_golden_recovery.json, tools/make_port_golden.py
   --recovery): the same recoveries (frame, matched keyframe), dropped
   frames and frame ids, the recovered pose w.r.t. its keyframe within
   4.4e-3 rad in rotation, the recovery's seeds% within 2 points, every
   pose finite, K3's launch counts equal to a hand count of the schedule;
9. batched videos: parallel.sharded.batched_init and four
   batched_process_interval calls (7, 8, 8 and 8 frames) over V = 8
   videos of run_gn, video v being frames 64v..64v+31, at 480x270 under
   the parity config.  K3 runs once per call for all eight videos, so its
   launch counts are one video's, 35 and 5; video 0 (frames 0..31) is
   held against the golden file as in phase 5, and every video against
   the port's single-video process_interval on the card over its first
   interval (init and 7 frames: poses within 2e-3, the JAX package's vmap
   tolerance, seeds% within 2 points); every pose finite.  The JAX
   package's run of each video alone
   (tests/data/port_golden_batched_run_gn.json, tools/make_port_golden.py
   --batched) sorts the videos: one whose seeds% stays above 2 points at
   every interval's end there is held to it over its first interval with
   phase 5's limits and must keep seeds% above 0 at every interval's end.
   The others start or end on a map of a few hundred pixels (videos 5-7
   of this run: a map that empties does not come back without connection
   recovery, and the pose of a sparse map moves with the summation order),
   and are printed.  K3 is held state by
   state on the run's (8, 270, 480) states and timed on them as phase 3
   times its batch of 20.  Then the same four intervals at V = 1, 2, 4
   and 8 (the run above is the last): wall time, aggregate tracked
   frames/s and torch.cuda.max_memory_allocated beside
   utils/footprint.py's prediction from its V = 1 and 2 probes, which
   must hold within 25 % at V = 4 and 8; check_fits(8) must pass.

Each driven path (phases 4, 6, 7, 8 and 9) sets K3's launch counts to 0 just
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
import types

ROOT = os.path.dirname(os.path.abspath(__file__))
PKG = "egomotion_with_local_loop_closures_tpu_torch"
FRAMES = os.path.join(ROOT, "reference_build", "run_gn", "frames_480x270.npz")
GOLDEN = os.path.join(ROOT, "tests", "data", "port_golden_run_gn.json")
LC_GOLDEN = os.path.join(ROOT, "tests", "data", "port_golden_run_lc.json")
LC_EDGES = os.path.join(ROOT, "reference_build", "run_lc", "outputs",
                        "matchframes_globalopt.txt")
RECOVERY_GOLDEN = os.path.join(ROOT, "tests", "data",
                               "port_golden_recovery.json")
BATCHED_GOLDEN = os.path.join(ROOT, "tests", "data",
                              "port_golden_batched_run_gn.json")
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
# Phase 8, 48 frames with frames 40 and 41 flat: keyframe steps at 8, 16,
# 24, 32 and 40 (the last builds keyframe 40 on the flat frame, with no
# seeds); frame 41 finds no candidate among keyframes 32, 24, 16, 8 and 1
# (one batched trial: one launch of each wrapper) and is dropped; frame 42
# is recovered (another batched trial) and becomes a keyframe; frames 43-47
# track and 48 is a keyframe step.  track_refine steps: 34 (frames 2-39)
# + 5 = 39; keyframe steps 6: 39 + 2 x 6 + 2 = 53 and 1 + 6 + 2 = 9.
RECOVERY_LAUNCHES = {"do_regularization": 53, "regularize": 9}
# connection recovery's batch at its largest: the loop window's cap
RECOVERY_BATCH = 20
# Phase 9: V videos of run_gn, video v from frame BATCH_STRIDE * v on, four
# intervals (the first K-1 frames after the init frame).  K3 launches, one
# video's count whatever V: the init launches one regularize; 6 + 7 + 7 + 7
# = 27 track_refine steps one do_regularization each; 4 keyframe steps two
# and one regularize each: 27 + 2 x 4 = 35 and 1 + 4 = 5.
BATCH_VIDEOS, BATCH_STRIDE, BATCH_INTERVALS = 8, 64, (7, 8, 8, 8)
BATCH_SWEEP = (1, 2, 4, 8)
BATCH_LAUNCHES = {"do_regularization": 35, "regularize": 5}
# the JAX package's tolerance for vmap against serial
# (tests/test_parallel.py), and the footprint prediction's
BATCH_POSE_TOL, FOOTPRINT_TOL = 2e-3, 0.25
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
    """(compulsory bytes, float32 operations) of one K3 call on this data
    (one state or a batch).  Bytes: each input plane read once, each
    output plane written once.
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
    H, W = state.valid.shape[-2:]
    planes = [getattr(state, n) for n in FIELDS]
    written = FIELDS if maxg is not None else reg_kernel._SMOOTHED
    nbytes = sum(t.numel() * t.element_size() for t in planes)
    nbytes += sum(getattr(state, n).numel() * getattr(state, n).element_size()
                  for n in written)
    ops = 0
    if maxg is not None:
        nbytes += maxg.numel() * maxg.element_size()
        holes = ~state.valid[..., 3:H - 3, 3:W - 2] & (
            maxg[..., 3:H - 3, 3:W - 2] >= cfg.min_abs_grad_decrease)
        ops += 2 * int(state.valid.sum()) + 101 * int(holes.sum())
    touched = int(filled.valid[..., 3:H - 3, 2:W - 2].sum())
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
                 LC_GOLDEN, LC_EDGES, RECOVERY_GOLDEN, BATCHED_GOLDEN):
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
    from egomotion_with_local_loop_closures_tpu_torch.parallel import sharded
    from egomotion_with_local_loop_closures_tpu_torch.runtime import (
        ellc_lc, io as ellc_io, pipeline, runner)
    from egomotion_with_local_loop_closures_tpu_torch.utils import footprint
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

    def one_of(batch, b):
        return batch.replace(**{n: getattr(batch, n)[b] for n in FIELDS})

    def hold_batch(label, states):
        """A batch of distinct (state, maxgrad) pairs in one launch of each
        wrapper, each state held bit for bit against the plain version on
        it alone; returns the batch."""
        H, W = states[0][1].shape
        c = cfg.replace(rows=H, cols=W)
        batch = DepthMapState(**{n: torch.stack([getattr(st_b, n) for st_b, _
                                                 in states])
                                 for n in FIELDS})
        maxg_b = torch.stack([m for _, m in states])
        for occl in (False, True):
            got = reg_kernel.do_regularization(batch, maxg_b, c, occl)
            got_r = reg_kernel.regularize(batch, c, occl)
            torch.cuda.synchronize()
            errs = []
            for b, (st_b, m_b) in enumerate(states):
                errs.append((compare(propagate.do_regularization(
                    st_b, m_b, c, occl), one_of(got, b), FIELDS),
                    compare(propagate.regularize(st_b, c, occl),
                            one_of(got_r, b), FIELDS)))
            worst["do_regularization"] = max(
                [worst["do_regularization"]] + [e for e, _ in errs])
            worst["regularize"] = max([worst["regularize"]]
                                      + [e for _, e in errs])
            print(f"{label}, remove_occlusions={occl}: each state equal bit "
                  f"for bit to the plain version alone (max abs err "
                  f"{max(e for e, _ in errs):.3g} / "
                  f"{max(e for _, e in errs):.3g})")
        return batch, maxg_b

    def seeded(B, shape):
        return [on_card((random_planes, border_planes)[k % 2](13 + k, shape))
                for k in range(B)]

    # three seeded states, at full size and ragged; five, the batch of
    # phase 8's recovery trials; and the window cap's twenty, the real
    # state rolled by (7b, 23b) pixels for b = 0..19
    B = RECOVERY_BATCH
    hold_batch(f"batch of 3 seeded states {cfg.rows}x{cfg.cols}",
               seeded(3, cfg.shape))
    hold_batch("batch of 3 seeded states 37x53", seeded(3, (37, 53)))
    hold_batch(f"batch of 5 seeded states {cfg.rows}x{cfg.cols}",
               seeded(5, cfg.shape))
    rolled = hold_batch(
        f"batch of {B} rolled real states {cfg.rows}x{cfg.cols}",
        [(real[0].replace(**{n: torch.roll(getattr(real[0], n),
                                           (7 * b, 23 * b), (0, 1))
                             for n in FIELDS}),
          torch.roll(real[1], (7 * b, 23 * b), (0, 1))) for b in range(B)])

    def timing(label, state, maxg):
        """Device time per call of each wrapper on ``state``, in turns
        with its plain version, beside its bound."""
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
                state, maxg, cfg, False,
                propagate.fill_holes(state, maxg, cfg)),
            "regularize": k3_work(state, None, cfg, True, state),
        }
        out = {}
        for name, (kern, plain) in timed.items():
            plain()
            kern()                                     # warm-up
            # turns plain/kernel/kernel/plain: device time per call, then
            # the latency of one call on an idle card (host dispatch
            # included)
            runs = [device_ms(f, reps) for f, reps in
                    ((plain, 10), (kern, 200), (kern, 200), (plain, 10))]
            ahead = all(a for _, a in runs)
            ts = [t for t, _ in runs]
            k_ms, p_ms = (ts[1] + ts[2]) / 2, (ts[0] + ts[3]) / 2
            nbytes, ops = work[name]
            t_bytes, t_ops = nbytes / PEAK_BYTES_S, ops / PEAK_F32_S
            bound = (1e3 * max(t_bytes, t_ops),
                     "bytes" if t_bytes >= t_ops else "operations")
            out[name] = (k_ms, p_ms, *bound)
            lat_k, lat_p = call_ms(kern), call_ms(plain)
            print(f"{name} {label}: device time per call kernel "
                  f"{k_ms:.5f} ms, plain {p_ms:.5f} ms (turns: "
                  f"{' '.join(f'{t:.5f}' for t in ts)}; host queue stayed "
                  f"ahead: {ahead}); latency of one call, median of 30: "
                  f"kernel {lat_k:.4f} ms, plain {lat_p:.4f} ms; bound "
                  f"{bound[0]:.5f} ms by {bound[1]} ({nbytes} B, {ops} "
                  f"float32 ops: {1e6 * t_bytes:.3f} / {1e6 * t_ops:.3f} "
                  f"us), {100 * bound[0] / k_ms:.1f} % of it reached; on "
                  f"{gpu}")
        return out

    timed_one = timing("at 270x480", *real)
    timed_batch = timing(
        f"on a batch of {B} states at 270x480 (the real state rolled)",
        *rolled)

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
          f"(max_frames {lc_golden['max_frames']}) on cuda, with Sim(3) "
          f"refinement")
    expect6 = LC_BOOTSTRAP_LAUNCHES
    stats6 = {}
    torch.cuda.synchronize()
    reg_kernel.reset_launches()
    t0 = time.perf_counter()
    res6 = ellc_lc.run_ellc_lc(iter(lc_frames[:n_lc]),
                               lc_cfg.replace(do_sim3_refine=True), dev,
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
    # Sim(3) refinement: on the golden file's own inputs (the JAX
    # package's corrected poses and edges), then the run's
    g_sim3 = np.asarray(lc_golden["sim3_world_poses"])
    t0 = time.perf_counter()
    own = ellc_lc._sim3_refine_trajectory(
        np.asarray(lc_golden["frame_ids"]),
        np.asarray(lc_golden["world_poses"], np.float32),
        [types.SimpleNamespace(**e) for e in g_edges],
        lc_cfg.replace(do_sim3_refine=True), dev)
    sim3_s = time.perf_counter() - t0
    d_own = float(np.abs(own - g_sim3).max())
    d_run = float(np.abs(res6.sim3_world_poses - g_sim3).max())
    print(f"Sim(3): on the golden file's inputs max |refined pose diff| "
          f"{d_own:.3g} (tol 1e-4) in {sim3_s:.3f} s; the run's refined "
          f"poses {d_run:.3g} (tol 1e-2), moved up to "
          f"{float(np.abs(res6.sim3_world_poses - res6.world_poses).max()):.3g}"
          f" from the corrected ones; sim3 phase {stats6['sim3']:.3f} s")
    check(d_own <= 1e-4, "Sim(3) on the golden inputs matches the JAX "
          "package")
    check(d_run <= 1e-2, "the run's Sim(3) poses match the golden file")

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

    with open(RECOVERY_GOLDEN) as f:
        rec_golden = json.load(f)
    check(rec_golden["frames_file"] == os.path.relpath(FRAMES, ROOT),
          "the recovery golden file ran on run_gn's frames")
    n_rec = rec_golden["num_input_frames"]
    rec_cfg = ELLCConfig().replace(**rec_golden["config_overrides"])
    rec_frames = frames[:n_rec].copy()
    for fid in rec_golden["flat_frame_ids"]:
        rec_frames[fid - 1] = rec_golden["flat_gray"]
    phase(f"8 connection recovery: run_sequence over {n_rec} frames of "
          f"run_gn, frames {rec_golden['flat_frame_ids']} flat, on cuda")
    expect8 = RECOVERY_LAUNCHES
    torch.cuda.synchronize()
    reg_kernel.reset_launches()
    t0 = time.perf_counter()
    res8 = runner.run_sequence(iter(rec_frames), rec_cfg, dev)
    torch.cuda.synchronize()
    wall8 = time.perf_counter() - t0
    launches8 = dict(reg_kernel.launches)
    recs = res8.extra["recoveries"]
    pairs8 = [(r["frame_id"], r["matched_kf_id"]) for r in recs]
    g_pairs8 = [(r["frame_id"], r["matched_kf_id"])
                for r in rec_golden["recoveries"]]
    print(f"K3 launches {launches8}, expected {expect8}; recoveries "
          f"{pairs8} (golden {g_pairs8}), dropped "
          f"{res8.extra['dropped_frames']} (golden "
          f"{rec_golden['dropped_frames']}); {len(res8.frame_ids)} frames in "
          f"{wall8:.3f} s on {gpu}")
    check(launches8 == expect8, "K3 launch counts match the recovery "
          "schedule")
    check(pairs8 == g_pairs8 and len(pairs8) >= 1,
          "the recoveries equal the golden file's")
    check(res8.extra["dropped_frames"] == rec_golden["dropped_frames"],
          "the dropped frames equal the golden file's")
    check(res8.frame_ids.tolist() == rec_golden["frame_ids"], "frame ids")
    check(bool(np.isfinite(res8.world_poses).all()), "recovery poses finite")
    g_attempts = {a["frame_id"]: a for a in rec_golden["attempts"]}
    for r, g in zip(recs, rec_golden["recoveries"]):
        g_pose = np.asarray(g_attempts[g["frame_id"]]["pose_wrt_matched"])
        d_rot8 = float(np.abs(r["pose_wrt_matched"][:3] - g_pose[:3]).max())
        d_seeds8 = abs(r["seeds"] - g["seeds"])
        print(f"frame {r['frame_id']} recovered against keyframe "
              f"{r['matched_kf_id']} from {len(g_attempts[g['frame_id']]['candidates'])}"
              f" candidates: max |rotation diff| {d_rot8:.3g} rad (tol "
              f"4.4e-3), |translation diff| "
              f"{float(np.abs(r['pose_wrt_matched'][3:] - g_pose[3:]).max()):.3g}"
              f", seeds% {r['seeds']:.3f} against {g['seeds']:.3f} (tol 2)")
        check(d_rot8 <= 4.4e-3, "recovered rotation matches the golden file")
        check(d_seeds8 <= 2.0, "recovery seeds% match the golden file")

    n_per = 1 + sum(BATCH_INTERVALS)
    with open(BATCHED_GOLDEN) as f:
        b_golden = json.load(f)
    check(b_golden["stride"] == BATCH_STRIDE
          and tuple(b_golden["intervals"]) == BATCH_INTERVALS
          and len(b_golden["videos"]) == BATCH_VIDEOS,
          "the batched golden file covers phase 9's videos")
    phase(f"9 batched videos: batched_init and {len(BATCH_INTERVALS)} "
          f"batched_process_interval calls over {BATCH_VIDEOS} videos of "
          f"run_gn ({n_per} frames each, from frame {BATCH_STRIDE}v) on cuda")
    vids = np.stack([frames[BATCH_STRIDE * v:BATCH_STRIDE * v + n_per]
                     for v in range(BATCH_VIDEOS)])
    t0 = time.perf_counter()
    predicted = {V: footprint.interval_footprint(V, cfg, dev)
                 for V in BATCH_SWEEP}
    print(f"footprint probes (V = 1 and 2, one interval each) in "
          f"{time.perf_counter() - t0:.3f} s; "
          f"{footprint.check_fits(BATCH_VIDEOS, cfg, dev).describe()}")

    def batched_run(V):
        """batched_init and the intervals over the first V videos: (final
        states, per-interval outputs, wall s, peak bytes above the bytes
        allocated before it)."""
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        states = sharded.batched_init(vids[:V, 0], cfg, dev)
        outs, start = [], 1
        for n in BATCH_INTERVALS:
            states, o = sharded.batched_process_interval(
                states, vids[:V, start:start + n], cfg)
            outs.append(o)
            start += n
        torch.cuda.synchronize()
        return (states, outs, time.perf_counter() - t0,
                torch.cuda.max_memory_allocated() - base)

    sweep = {}
    for V in BATCH_SWEEP:
        if V == BATCH_VIDEOS:
            reg_kernel.reset_launches()
        states9, outs9, wall9, peak9 = batched_run(V)
        if V == BATCH_VIDEOS:
            launches9 = dict(reg_kernel.launches)
        pred = predicted[V].peak_bytes
        sweep[V] = (wall9, V * (n_per - 1) / wall9, peak9, pred)
        print(f"V={V}: {V * (n_per - 1)} tracked frames in {wall9:.3f} s, "
              f"{V * (n_per - 1) / wall9:.3f} aggregate frames/s; peak "
              f"{peak9 / 2**20:.1f} MiB, predicted {pred / 2**20:.1f} MiB "
              f"({100 * (peak9 / pred - 1):+.1f} %); on {gpu}")
        if V in (4, 8):
            check(abs(peak9 / pred - 1) <= FOOTPRINT_TOL,
                  f"the footprint prediction holds within 25 % at V={V}")
        if V != BATCH_VIDEOS:
            del states9, outs9
    print(f"K3 launches {launches9}, expected {BATCH_LAUNCHES} (one "
          f"video's count for {BATCH_VIDEOS} videos)")
    check(launches9 == BATCH_LAUNCHES, "the videos share each K3 launch")
    poses9 = torch.cat([o.pose_wrt_world for o in outs9], 1).cpu().numpy()
    seeds9 = torch.cat([o.seeds for o in outs9], 1).cpu().numpy()
    check(poses9.shape == (BATCH_VIDEOS, n_per - 1, 6), "batched outputs")
    check(bool(np.isfinite(poses9).all()), "batched poses finite")
    ends = np.cumsum(BATCH_INTERVALS) - 1
    n1 = BATCH_INTERVALS[0]
    for v, g in enumerate(b_golden["videos"]):
        g_seeds = np.asarray(g["seeds"])
        d_p = float(np.abs(poses9[v, :n1]
                           - np.asarray(g["pose_wrt_world"])[:n1]).max())
        d_s = float(np.abs(seeds9[v, :n1] - g_seeds[:n1]).max())
        dense = bool((g_seeds[ends] > SEEDS_TOL).all())
        print(f"video {v} (frames {BATCH_STRIDE * v}..): seeds% at the "
              f"interval ends {np.round(seeds9[v, ends], 3).tolist()}, the "
              f"JAX package's {np.round(g_seeds[ends], 3).tolist()}; first "
              f"interval against it: max |pose diff| {d_p:.3g}, max |seeds% "
              f"diff| {d_s:.3g} (held to {POSE_TOL} / {SEEDS_TOL} and seeds% "
              f"> 0 at every end: {dense})")
        if dense:
            check(d_p <= POSE_TOL and d_s <= SEEDS_TOL,
                  f"video {v} matches the JAX package's run of it")
            check(bool((seeds9[v, ends] > 0).all()),
                  f"video {v} keeps seeds at each interval's end, as the "
                  f"JAX package's run of it does")
    # video 0 is frames 0..31 of run_gn: the golden file's frames 2..17
    n_g = len(golden["frame_ids"])
    first9 = np.asarray(golden["frame_ids"]) <= cfg.keyframe_interval
    d_pose0 = np.abs(poses9[0, :n_g] - np.asarray(golden["world_poses"]))
    d_seeds0 = np.abs(seeds9[0, :n_g] - np.asarray(golden["seeds"]))
    print(f"video 0 against the golden file: max |pose diff| first interval "
          f"{d_pose0[first9].max():.3g} (tol {POSE_TOL}), all {n_g} frames "
          f"{d_pose0.max():.3g}; max |seeds% diff| {d_seeds0.max():.3g} (tol "
          f"{SEEDS_TOL})")
    check(d_pose0[first9].max() <= POSE_TOL and d_seeds0.max() <= SEEDS_TOL,
          "video 0 matches the golden file")
    d_single = []
    for v in range(BATCH_VIDEOS):
        st1 = pipeline.init_pipeline(vids[v, 0], cfg, dev)
        _, o1, _ = pipeline.process_interval(st1, list(vids[v, 1:1 + n1]),
                                             cfg)
        d_single.append((
            float(np.abs(o1.pose_wrt_world.cpu().numpy()
                         - poses9[v, :n1]).max()),
            float(np.abs(o1.seeds.cpu().numpy() - seeds9[v, :n1]).max())))
    print(f"each video against its single-video run, first interval: max "
          f"|pose diff| {max(d for d, _ in d_single):.3g} (tol "
          f"{BATCH_POSE_TOL}), max |seeds% diff| "
          f"{max(d for _, d in d_single):.3g} (tol {SEEDS_TOL}); per video "
          f"{[f'{d:.2g}' for d, _ in d_single]}")
    check(all(d <= BATCH_POSE_TOL and e <= SEEDS_TOL for d, e in d_single),
          "every video matches its single-video run")
    batch9 = (states9.depth, states9.kf.maxgrad)
    for occl in (False, True):
        got = reg_kernel.do_regularization(*batch9, cfg, occl)
        got_r = reg_kernel.regularize(batch9[0], cfg, occl)
        torch.cuda.synchronize()
        errs = [(compare(propagate.do_regularization(
            one_of(batch9[0], b), batch9[1][b], cfg, occl), one_of(got, b),
            FIELDS), compare(propagate.regularize(one_of(batch9[0], b), cfg,
                                                  occl), one_of(got_r, b),
                             FIELDS)) for b in range(BATCH_VIDEOS)]
        worst["do_regularization"] = max(
            [worst["do_regularization"]] + [e for e, _ in errs])
        worst["regularize"] = max([worst["regularize"]]
                                  + [e for _, e in errs])
        print(f"K3 on the {BATCH_VIDEOS} videos' states, remove_occlusions="
              f"{occl}: each state equal bit for bit to the plain version "
              f"alone (max abs err {max(e for e, _ in errs):.3g} / "
              f"{max(e for _, e in errs):.3g})")
    timed_videos = timing(f"on the batch of {BATCH_VIDEOS} videos' states "
                          f"at 270x480", *batch9)

    src = os.path.join(PKG, "csrc", "reg_kernel.cu")
    replaces = "egomotion_with_local_loop_closures_tpu/ops/reg_kernel.py:161"
    by_path = {"gn_run_sequence": launches, "lc_bootstrap": launches6,
               "lc_mode": launches7, "recovery": launches8,
               "batched_videos": launches9}
    print(json.dumps({"kernels": [
        {"name": f"reg_kernel.{name}", "route": "cuda", "source": src,
         "replaces": replaces, "launches": launches[name],
         "launches_by_path": {k: v[name] for k, v in by_path.items()},
         "max_abs_err": worst[name], "ms": timed_one[name][0],
         "plain_ms": timed_one[name][1], "bound_ms": timed_one[name][2],
         "bound_by": timed_one[name][3], "library_ms": None,
         "batched": {"states": RECOVERY_BATCH, "ms": timed_batch[name][0],
                     "plain_ms": timed_batch[name][1],
                     "bound_ms": timed_batch[name][2],
                     "bound_by": timed_batch[name][3]},
         "batched_videos": {"states": BATCH_VIDEOS,
                            "ms": timed_videos[name][0],
                            "plain_ms": timed_videos[name][1],
                            "bound_ms": timed_videos[name][2],
                            "bound_by": timed_videos[name][3]}}
        for name in ("do_regularization", "regularize")]}))
    print(gpu)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
