#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one CUDA card.

Run from the root of a checkout:  python3 chip_smoke.py

Phases, each announced on its own line:

1. toolchain: torch, CUDA, nvcc, triton, and the card's name and power
   limit from nvidia-smi;
2. build: compiles the K3 kernel (csrc/reg_kernel.cu), the two K1
   kernels (csrc/gn_kernel.cu: gn_level_cluster and gn_step), the K2
   kernel (csrc/stereo_kernel.cu) and propagate's two merge kernels
   (csrc/propagate_kernel.cu: propagate_link and propagate_merge) from
   this checkout, one nvcc each, started together, and prints each
   kernel's registers, stack and shared memory and its static SASS
   instruction count (cuobjdump);
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
3b. K1 against its plain PyTorch version on the card, at every level of
   the pyramid, for one video and for eight in one call, on numpy-seeded
   planes and on phase 3's real keyframe and the next frame of run_gn:
   gn_step's linearization alone (H within 1e-4 of its largest entry,
   g_i within 1e-4 of sqrt(H_ii E), the energy within 1e-4 relative, or
   else nearer the plain version's float64 sums than the plain float32
   ones are; the used count exact) against the plain linearization, each
   side's distance from float64 printed; gn_step's finish alone on the
   plain H, g and pose (the pose within 1e-5 a component, iters and
   freeze flags equal), from a fresh level and from a state with some
   videos frozen; a whole level of each kernel, gn_level_cluster and
   gn_step, against the plain level and its float64 run
   (ops/gn_reference.py::level_agreement: the plain stop and freeze
   flag, or one iteration apart where the plain metric lies within the
   level's measured float32 spread of 1; after as many plain iterations
   as the kernel used, the used count equal and the pose within 1e-5 a
   component, the energy and the metric within their measured
   tolerances, each or nearer float64 than twice the plain value's
   distance from it); each video of
   an eight-video call bit-equal to its own call (the partials and a
   whole level of each kernel) and a repeated call bit-equal to the
   first; then the time per launch of the two single modes from
   CUDA-graph replays, in turns with the plain linearization, update and
   iteration, beside its bound, and each level's iterations and one
   whole align as one graph, of either kernel and of the plain version,
   in turns, beside their bounds (tools/time_k1_levels.py);
3c. K2 against its plain PyTorch version (depth/stereo.py::plain_observe)
   on the card, for one video and for eight in one call (video b: the
   planes rolled by (b, 2b) pixels, the pose moved by 2e-4 b): numpy-seeded
   planes (3b's images, phase 3's seeded state or no hypothesis) and phase
   3's keyframe with the next frame of run_gn at its tracked pose, from no
   hypothesis (the create path), from the pipeline's state (the update
   path), from that state with a quarter of its variances near max_var,
   and at the kernel's most steps, 64, with a 70-pixel crop (some walks
   must pass 32 steps); and the seeded planes from no hypothesis with the
   pose's translation eight times over (segments clamped at the border:
   some walks must end within a pixel of the border line).
   Each video must equal the plain twin bit for bit in every output plane
   (NaN equal to NaN), its counts exactly; each video of an eight-video
   call bit-equal to its own call; the plain twin's codes and EKF branches
   are printed, and the real frames must reach every branch.  Then K2's
   and the plain version's time per call from CUDA-graph replays at V = 1
   and 8 on the update path, in turns, beside K2's bound;
3d. propagate's merge kernels against their plain twin
   (ops/propagate_kernel.py::plain_merge, whose sums add each cell's
   compatible candidates in ascending source index without a float
   atomic) on the card, bit for bit in every plane (NaN equal to NaN),
   on the candidates that depth/propagate.py::candidates makes of phase
   3's real keyframe (the pipeline's state after frame 8, propagated into
   frame 9 at its tracked pose): one state, 8 videos (video b rolled by
   (b, 2b) pixels, its pose moved by 2e-4 b) and the 20 trials of
   recovery's window cap (rolled by (7b, 23b)), and one state zoomed out
   (the pose moved back by MERGE_ZOOM); a second call bit-equal to the
   first.  Then the time per call of the kernels and of the merge as the
   port ran it before them (float index_add_, atomic order) from CUDA-graph
   replays, in turns, and of one eager call of the twin (it reads the
   largest fan-in back to the host), beside the kernels' bound by bytes;
4. main path: runner.run_sequence over the first 129 frames of
   reference_build/run_gn at 480x270 under the parity config; K3's, K1's
   and K2's launch counts must equal what the frame schedule implies (K1:
   a tracked frame's align one gn_level_cluster launch at each of levels
   2-3 and a gn_step launch an iteration at levels 0-1, 2 + 11; K2: one
   a track_refine step), every pose must be
   finite and seeds% positive; prints tracked frames/s after the first
   interval.  Then the same frames with intervals_per_dispatch 1 and 4
   (the default: outputs read every four intervals) in turns 1/4/4/1:
   the same frame and keyframe ids, frames/s and reads of each turn.
   Every turn's poses, seeds and ids must equal the first run's bit for
   bit (no step sums with a float atomic).
   Before those turns, the same run once more with CUDA events around
   every step (no profiler): the card's time inside and between steps
   beside a track_refine graph replayed alone, with the host ahead;
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
   and a second refinement the first one's bits (graph/ba.py sums each
   node's edge terms in a fixed order); the run's refined poses must be
   within 1e-2 of them;
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
   must hold within 25 % at V = 4 and 8; check_fits(8) must pass.  Each
   V's run captures its graphs afresh and releases them after, so its
   peak holds one V's state and that V's graph pool, whose bytes it
   prints;
10. synthetic: the port's CLI, ``runtime.cli --synthetic 65 --rows 270
   --cols 480 --glibc-init`` in a subprocess on the card (the JAX CLI's
   room and random walk, rendered on the card, tracked by run_sequence):
   poses_gt.txt within 5e-4 of the JAX package's trajectory, every pose
   finite, K3's launch counts in that process equal to the schedule's,
   and the ATE against poses_gt under the JAX package's ATE on its own
   render of the same frames plus a stated slack
   (tests/data/port_golden_synthetic.json, tools/make_port_golden.py
   --synthetic); the card's render of three poses against the port's CPU
   render of them;
11. accuracy: phase 4's poses scored against the binary's
   reference_build/run_gn/outputs/poses_orig.txt with utils/metrics.py
   (RPE-8f, RPE-40f, ATE, seeds%, tools/port_parity_eval.py's scoring),
   beside the JAX package's parity-config run of the same frames
   (tests/data/port_golden_parity_gn.json, tools/make_port_golden.py
   --parity-gn);
12. two ranks on the card: two processes on cuda:0 joined by
   parallel.mesh.initialize_multihost over gloo (NCCL refuses two ranks
   on one card): sharded_gn_quantities at level 0 of a real 270x480
   keyframe and frame, one gn_step launch (its linearization alone) a
   rank, against the single-process
   plain _gn_quantities (H within
   1e-4 of its largest entry, g_i of sqrt(H_ii E)), and refine_sharded on
   phase 6's golden Sim(3) graph against refine (within 1e-5);
13. profile: utils.profiling.trace and StageTimer around one keyframe
   interval of phase 10's frames, every step a graph replay: the stage
   times and the card's busy share from the trace;
14. graphs against eager: from one init state on phase 4's frames, the
   first interval with every frame step replayed from its captured CUDA
   graph (runtime/graphs.py) and run eagerly (the step bodies
   pipeline._track_refine_step and _keyframe_step): every track_refine
   step bit-equal on every state field and output (NaN equal to NaN), the
   K3 launches counted from the graph's nodes equal to the eager step's;
   the keyframe step, two graph replays and two eager runs, all four
   bit-equal, with one launch of each merge kernel; the same for two
   batched videos and for replay steps with an initial rotation.  Prints
   each captured graph's kernel nodes (from
   raw_cuda_graph() and libcuda's cuGraphGetNodes) beside the eager
   profile's 24,475 launches a frame before K1, its K3, K1, K2 and merge
   nodes (a keyframe graph one of each merge kernel, a track_refine
   graph none)
   (found by name) and its warm-up's launches, its capture and
   instantiate seconds and its pool's bytes, and GN frames/s graphed
   beside eager over the same 16 frames, in turns; then the device-idle
   gaps of one more graphed loop over them (CUDA events around every
   step, no profiler) beside a track_refine graph replayed alone.

Phases 4-13 run graphed: on the card every frame step of run_sequence,
process_interval, run_ellc_lc and batched_process_interval replays its
captured graph, and a replay counts the K3, K1, K2 and merge kernel nodes
of its graph (checked at capture against the wrapper calls the capture
made);
the eager warm-up before each capture counts apart, under
``warmup_launches_by_path``.  Each driven path (phases 4, 6, 7, 8, 9
and 10) sets K3's, K1's, K2's and the merge kernels' launch counts to 0
just before it and reads them just after, and holds them to a hand count
of its schedule; phase 14 holds each replayed step to the eager step's
launches, one of K2 a track_refine step, one of each merge kernel a
keyframe step.  The
last lines are one JSON object
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

import dataclasses
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
SYNTHETIC_GOLDEN = os.path.join(ROOT, "tests", "data",
                                "port_golden_synthetic.json")
PARITY_GOLDEN = os.path.join(ROOT, "tests", "data",
                             "port_golden_parity_gn.json")
BINARY_POSES = os.path.join(ROOT, "reference_build", "run_gn", "outputs",
                            "poses_orig.txt")
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
# Phase 10: the port's CLI over SYNTHETIC_FRAMES frames of the JAX CLI's
# synthetic room at 480x270.  K3 launches, by phase 4's schedule: frames
# 2..65 are 64 tracked frames, the first interval 7 and then 7 of 8, so 8
# keyframe steps (frames 8, 16, ..., 64) and 56 track_refine steps:
# 56 + 2 x 8 = 72 and 1 + 8 = 9.
SYNTHETIC_FRAMES = 65
SYNTHETIC_LAUNCHES = {"do_regularization": 72, "regularize": 9}
# The trajectory and render tolerances of tests/test_torch_synthetic.py:
# float32 lie.compose chains part by 1.9e-4 between XLA and ATen (log_se3's
# ill-conditioned coefficient near 0.01 rad); a render within 2e-3 grey
# levels and 1e-6 relative depth, but for at most 0.1 % seam pixels.
TRAJ_TOL, RENDER_TOL, DEPTH_RTOL, SEAM_FRAC = 5e-4, 2e-3, 1e-6, 1e-3
# ATE slack over the JAX package's 8.372e-3 on these frames: three times
# the largest gap of the port's CPU runs from it (7.98e-3 at 1 thread and
# 7.65e-3 at 4 threads with the glibc init, on a CPU: gap 7.3e-4)
SYNTHETIC_ATE_SLACK = 2.2e-3
# Phase 12: H within 1e-4 of its largest entry (the JAX package holds its
# pixel-sharded H at 2e-4) and each g_i within 1e-4 of sqrt(H_ii E), E
# the energy; the sharded Sim(3) nodes within 1e-5
SHARDED_GN_TOL, SHARDED_BA_TOL = 1e-4, 1e-5
# Propagate's merge (ops/propagate_kernel.py): one call, one launch of
# each of its two kernels, a keyframe step and a batched recovery trial
# (one for all candidates).  Calls per path, from the schedules counted for
# K3 above (each keyframe step one regularize, and the init one): phase 4
# 16 keyframe steps; phase 6 10; phase 7 10 + 10 replayed + 4 x 4 = 36;
# phase 8 6 keyframe steps and 2 trials; phase 9 4, one video's count
# whatever V; phase 10 8.
MERGE_CALLS = {"gn_run_sequence": 16, "lc_bootstrap": 10, "lc_mode": 36,
               "recovery": 8, "batched_videos": 4, "synthetic": 8}
# Phase 3d: the real keyframe's pose with the camera moved back by
# MERGE_ZOOM (a zoom-out, with the photometric gate opened: dozens of
# sources a cell, more than the kernel selects in one walk, kChunk), and
# the bytes the merge must move, each read once or written once: every
# source's candidate flag and every cell's seven planes, and only a
# candidate's target (int64), inverse depth, variance and validity (the
# kernels read nothing else of a source that is not a candidate)
MERGE_ZOOM, MERGE_BYTES_CELL, MERGE_BYTES_CAND = 3.0, 1 + 25, 8 + 4 + 4 + 4
# its float32 operations, counted by hand from csrc/propagate_kernel.cu:
# a candidate's winner test (2) and compatibility (5), a compatible
# candidate's reciprocal, product and four sums with its clamp test (7),
# a cell's finish (4)
MERGE_OPS_CAND, MERGE_OPS_COMPAT, MERGE_OPS_CELL = 7, 7, 4


def merge_expected(path):
    """The merge kernels' launches on a driven path, by the hand count
    above."""
    return {"propagate_link": MERGE_CALLS[path],
            "propagate_merge": MERGE_CALLS[path]}

# K1 (ops/gn_kernel.py) in one align at 480x270: levels 2 and 3 (67x120
# and 33x60: 8,040 and 1,980 pixels, each at most
# gn_kernel.CLUSTER_MAX_PIXELS) run one gn_level_cluster launch each,
# levels 0 and 1 (270x480 and 135x240: 129,600 and 32,400 pixels) one
# gn_step launch an iteration: a tracked frame (max_iters 4, 7, 9, 12)
# 2 + 4 + 7 launches, a replayed frame (max_iters_replay 5, 1, 1, 1)
# 2 + 5 + 1.  Connection recovery's trials and
# the LC rematch run the constant-weight aligner, no K1.  Frame steps
# (track_refine and keyframe, each one align) per path, from the
# schedules counted for K3 above, and replayed steps:
# phase 4 every tracked frame, 128; phase 6 69 + 10 = 79; phase 7 the
# bootstrap batch's 79 and two batches of 28 + 4, 143, each batch replayed
# once; phase 8 39 + 6 = 45 (frames 41 and 42 are recovery trials, no
# step); phase 9 27 + 4 = 31, one video's count whatever V; phase 10
# 56 + 8 = 64.
K1_ALIGN = {"gn_level_cluster": 2, "gn_step": 4 + 7}
K1_REPLAY_ALIGN = {"gn_level_cluster": 2, "gn_step": 5 + 1}
K1_STEPS = {"gn_run_sequence": (MAIN_FRAMES - 1, 0), "lc_bootstrap": (79, 0),
            "lc_mode": (143, 143), "recovery": (45, 0),
            "batched_videos": (31, 0),
            "synthetic": (SYNTHETIC_FRAMES - 1, 0)}
# Phase 3b: the linearization's H within K1_SUM_TOL of its largest entry,
# g_i of sqrt(H_ii E), the energy relative (float32 sums of up to 1.3e5
# terms in another order than the plain version's); the finish's pose
# within K1_POSE_TOL a component on the same system, and a whole level's
# within it or nearer float64 than twice the plain level's distance; eight
# videos in one call
K1_SUM_TOL, K1_POSE_TOL, K1_VIDEOS = 1e-4, 1e-5, 8


def k1_expected(path):
    """K1's launches on a driven path, by the hand count above."""
    steps, replayed = K1_STEPS[path]
    return {k: K1_ALIGN[k] * steps + K1_REPLAY_ALIGN[k] * replayed
            for k in K1_ALIGN}


# K2 (ops/stereo_kernel.py): one launch a track_refine step (each runs
# stereo.observe once, for all videos), replayed steps included; a keyframe
# step runs none.  track_refine steps per path, from the schedules counted
# for K3 above: phase 4 112 (128 tracked frames, 16 of them keyframe
# steps); phase 6 69; phase 7 the bootstrap batch's 69 and its replay's
# 69, then two batches of 28, each replayed: 69 + 69 + 4 x 28 = 250;
# phase 8 34 + 5 = 39; phase 9 6 + 7 + 7 + 7 = 27, one video's count
# whatever V; phase 10 56.
K2_STEPS = {"gn_run_sequence": 112, "lc_bootstrap": 69, "lc_mode": 250,
            "recovery": 39, "batched_videos": 27, "synthetic": 56}
# Phase 3c: K2 and its plain twin round alike on the card (the twin's pose
# blocks are geom/lie.py's entry-by-entry products, its divisions by a
# config value multiplications by the float32 reciprocal, as in the
# kernel), so every output plane must be bit-equal; eight videos in one call
K2_VIDEOS = 8
# the kernel's most steps (ops/stereo_kernel.py MAX_STEPS): phase 3c runs
# a case at it, with a crop long enough that walks reach past 32 steps
K2_MAX_STEPS, K2_LONG_CROP = 64, 70.0
# K2's float32 operations, counted by hand from csrc/stereo_kernel.cu (each
# add, sub, mul, div, sqrt, abs, floor, ceil, min, max and float compare
# one): the gates and epipolar direction of every pixel 32; the search band
# and segment of a pixel that runs 160; the descriptor, the four samples
# before the walk, the subpixel step, triangulation, variance model and
# EKF rules of a pixel whose segment passed 380; a step of its walk (the
# step test, one bilinear sample, the SSD, the correlation and both argmin
# updates) 68
K2_OPS_PIXEL, K2_OPS_RUN, K2_OPS_WALKED, K2_OPS_STEP = 32, 160, 380, 68
# bytes a pixel read once and written once: the state (five float planes,
# int32 and bool) in and out, the keyframe's image, gradients and max
# gradient and the current image; per video the pose and the two counts
K2_BYTES_PIXEL, K2_BYTES_VIDEO = 25 + 20 + 25, 24 + 8


def k2_expected(path):
    """K2's launches on a driven path, by the hand count above."""
    return {"stereo_observe": K2_STEPS[path]}


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
    """reg_kernel<kFill, kOccl>, gn_level_cluster, gn_step,
    stereo_observe, propagate_link or propagate_merge from a mangled
    kernel name."""
    m = re.search(r"reg_kernelILb(\d)ELb(\d)E", mangled)
    if m:
        return f"reg_kernel<fill={m.group(1)}, occl={m.group(2)}>"
    m = re.search(r"\d+(gn_level_cluster|gn_step|stereo_observe|"
                  r"propagate_link|propagate_merge)E", mangled)
    return m.group(1) if m else mangled


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


def load_tool(name):
    """A module of this checkout's tools/ directory."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def golden_sim3_graph(lc_golden, cfg, dev):
    """The keyframe Sim(3) graph that LC mode's final refinement builds
    from the LC golden file's corrected poses and loop edges
    (ellc_lc._sim3_refine_trajectory)."""
    import numpy as np
    from egomotion_with_local_loop_closures_tpu_torch.graph import sim3
    ids = np.asarray(lc_golden["frame_ids"])
    poses = np.asarray(lc_golden["world_poses"], np.float32)
    kf_idx = np.nonzero(ids % cfg.keyframe_interval == 0)[0]
    node = {int(f): k for k, f in enumerate(ids[kf_idx])}
    loops = [(node[e["matched_kf_id"]], node[e["frame_id"]],
              np.asarray(e["pose_wrt_matched"], np.float32))
             for e in lc_golden["edges"]
             if e["matched_kf_id"] in node and e["frame_id"] in node]
    return sim3.graph_from_trajectory(poses[kf_idx], np.ones(len(kf_idx)),
                                      loop_edges=loops, device=dev)


def k1_phase(cases, cfg, dev, gpu):
    """Phase 3b: K1 against its plain version on ``cases``, each (label,
    keyframe levels, current levels, pose, timed), at every level, for one
    video and for K1_VIDEOS (video b: the planes rolled by (b, 2b) pixels,
    the pose moved by 2e-4 b in each component).  Returns the worst
    errors, {"linearize": max of the normalized H and g errors, "finish":
    max |pose diff|, "gn_level_cluster" and "gn_step": max |pose diff| of
    a whole level}, and for the timed case {(level, V): {single mode or
    plain function: (ms, plain ms, bound ms, bound by)}}."""
    import torch
    from egomotion_with_local_loop_closures_tpu_torch.ops import (
        gn_kernel, gn_reference)
    from egomotion_with_local_loop_closures_tpu_torch.track import alignment
    KL, CL = alignment.KeyframeLevel, alignment.CurrentLevel
    term_w = alignment._termination_weights(cfg.termination_weights,
                                            torch.float32, dev)
    worst = dict.fromkeys(("linearize", "finish", *gn_kernel.KERNELS), 0.0)
    timed = {}

    def videos_of(kf, cur, pose, V):
        if V == 1:
            return (KL(*(t.contiguous() for t in kf)),
                    CL(*(t.contiguous() for t in cur)), pose.contiguous())

        def stack(t):
            return torch.stack([torch.roll(t, (b, 2 * b), (0, 1))
                                for b in range(V)])
        return (KL(*map(stack, kf)), CL(*map(stack, cur)),
                pose + 2e-4 * torch.arange(V, device=dev,
                                           dtype=torch.float32)[:, None])

    def sum_errors(got, want):
        (Hg, gg, eg, ng), (Hw, gw, ew, nw) = got, want
        dH = ((Hg - Hw).abs().amax((-2, -1))
              / Hw.abs().amax((-2, -1))).max()
        g_scale = torch.sqrt(torch.diagonal(Hw, dim1=-2, dim2=-1)
                             * ew[..., None])
        dg = ((gg - gw).abs() / g_scale).max()
        de = ((eg - ew).abs() / ew.abs()).max()
        return float(dH), float(dg), float(de), int((ng != nw).sum())

    def state_clone(st):
        return gn_kernel.GNState(*(t.clone() for t in st))

    def same(a, b):
        return all(torch.equal(x.nan_to_num(7.0), y.nan_to_num(7.0))
                   for x, y in zip(a, b))

    for label, kf_levels, cur_levels, pose0, is_timed in cases:
        for level in range(cfg.num_levels):
            intr = cfg.level_intrinsics(level)
            n_iters = int(cfg.max_iters[level])
            for V in (1, K1_VIDEOS):
                kf, cur, pose = videos_of(kf_levels[level], cur_levels[level],
                                          pose0, V)
                lead = pose.shape[:-1]
                got = gn_kernel.gn_quantities(kf, cur, pose, intr, cfg)
                want = alignment._gn_quantities(kf, cur, pose, intr, cfg)
                dH, dg, de, dn = sum_errors(got, want)
                # both against the plain version in float64: how far
                # float32 itself leaves each from the exact sums.  A sum
                # past K1_SUM_TOL from the plain one still passes if the
                # kernel's lies nearer the exact sum than the plain
                # version's does (on the real frames the plain g is the
                # farther one)
                kf64 = KL(*(t.double() for t in kf))
                cur64 = CL(*(t.double() for t in cur))
                exact = alignment._gn_quantities(kf64, cur64, pose.double(),
                                                 intr, cfg)
                err64 = [sum_errors(tuple(t.double() for t in x), exact)
                         for x in (got, want)]
                close = [d <= K1_SUM_TOL or k <= p for d, k, p in zip(
                    (dH, dg, de), err64[0][:3], err64[1][:3])]
                check(all(close) and dn == 0,
                      f"gn_step's linearization on {label} level {level} "
                      f"V={V}: H {dH:.3g}, g {dg:.3g}, energy {de:.3g} (tol "
                      f"{K1_SUM_TOL}, or nearer float64 than the plain sums: "
                      f"{close}), {dn} used counts differ")
                # the finish alone on the plain system: a fresh level, then
                # an iteration from a state with every other video frozen
                partials = gn_kernel.pack(*want)[..., None, :]
                ref = gn_kernel._update(*want, pose, None, term_w)
                got1 = gn_kernel.finish(partials, pose,
                                        gn_kernel.empty_state(pose), cfg,
                                        True)
                frozen = ref._replace(done=(torch.arange(
                    V, device=dev) % 2).to(torch.int32).reshape(lead))
                ref2 = gn_kernel._update(*want, frozen.pose, frozen, term_w)
                st2 = state_clone(frozen)
                got2 = gn_kernel.finish(partials, st2.pose, st2, cfg, False)
                dp = max(float((got1.pose - ref.pose).abs().max()),
                         float((got2.pose - ref2.pose).abs().max()))
                flags = all(torch.equal(getattr(a, f), getattr(b, f))
                            for a, b in ((got1, ref), (got2, ref2))
                            for f in ("iters", "done"))
                check(dp <= K1_POSE_TOL and flags,
                      f"gn_step's finish on {label} level {level} V={V}: max "
                      f"|pose diff| {dp:.3g} (tol {K1_POSE_TOL}), iters and "
                      f"done equal: {flags}")
                worst["linearize"] = max(worst["linearize"], dH, dg)
                worst["finish"] = max(worst["finish"], dp)
                # a whole level of each kernel against the plain iterations
                # and their float64 evaluation
                traj = gn_reference.plain_trajectory(
                    kf, cur, pose, level, cfg, n_iters, term_w)
                traj64 = gn_reference.plain_trajectory(
                    kf64, cur64, pose.double(), level, cfg, n_iters,
                    term_w.double())
                plain = traj.level()
                lvl_msg = []
                for kernel in gn_kernel.KERNELS:
                    lvl = gn_kernel.run_level(kf, cur, pose, intr, cfg,
                                              n_iters, kernel)
                    again = gn_kernel.run_level(kf, cur, pose, intr, cfg,
                                                n_iters, kernel)
                    diff = float((lvl.pose - plain.pose).abs().max())
                    agrees, apart = gn_reference.level_agreement(
                        lvl, traj, traj64, level, K1_POSE_TOL)
                    check(agrees, f"{kernel} on {label} level {level} V={V} "
                          f"against the plain level: {'; '.join(apart)}")
                    check(same(lvl, again), f"{kernel} on {label} level "
                          f"{level} V={V}: a repeated call bit-equal")
                    worst[kernel] = max(worst[kernel], diff)
                    lvl_msg.append(
                        f"{kernel} max |pose diff| {diff:.3g}" + (
                            f" (parted where the plain metric lies within "
                            f"{gn_reference.METRIC_TOL[level]} of 1: "
                            f"{'; '.join(apart)})" if apart else ""))
                    if V > 1:
                        for b in range(V):
                            alone = gn_kernel.run_level(
                                KL(*(t[b] for t in kf)),
                                CL(*(t[b] for t in cur)), pose[b], intr,
                                cfg, n_iters, kernel)
                            check(same(alone, (x[b] for x in lvl)),
                                  f"{kernel}: a level of video {b} of {V} "
                                  f"equals its own call bit for bit")
                bits = ""
                if V > 1:
                    parts = gn_kernel.linearize(kf, cur, pose, intr, cfg)
                    for b in range(V):
                        kf1, cur1 = KL(*(t[b] for t in kf)), \
                            CL(*(t[b] for t in cur))
                        check(torch.equal(gn_kernel.linearize(
                            kf1, cur1, pose[b], intr, cfg), parts[b]),
                            f"gn_step's partials of video {b} of {V} equal "
                            f"its own call's")
                    bits = (f"; each of the {V} videos bit-equal to its own "
                            f"call (partials and a level of {n_iters} "
                            f"iterations of each kernel)")
                print(f"K1 {label} level {level} "
                      f"({kf.image.shape[-2]}x{kf.image.shape[-1]}) V={V}: "
                      f"linearization H {dH:.3g}, g {dg:.3g}, energy "
                      f"{de:.3g} of their scales (from float64: kernel "
                      f"{err64[0][0]:.3g} / {err64[0][1]:.3g} / "
                      f"{err64[0][2]:.3g}, plain {err64[1][0]:.3g} / "
                      f"{err64[1][1]:.3g} / {err64[1][2]:.3g}); finish max "
                      f"|pose diff| {dp:.3g}; a level: "
                      f"{', '.join(lvl_msg)}, iters {plain.iters.tolist()}, "
                      f"repeated calls bit-equal{bits}")
                if is_timed:
                    timed[(level, V)] = k1_times(kf, cur, pose, intr, cfg,
                                                 term_w, gpu, label, level)
    return worst, timed


def k1_times(kf, cur, pose, intr, cfg, term_w, gpu, label, level):
    """Device time per call of gn_step's two single modes (a linearization
    alone, a finish alone on given partials) and their plain versions
    (the linearization, the update, the whole iteration) from CUDA-graph
    replays, in turns, beside each mode's bound."""
    import torch
    from egomotion_with_local_loop_closures_tpu_torch.ops import gn_kernel
    from egomotion_with_local_loop_closures_tpu_torch.track import alignment
    from egomotion_with_local_loop_closures_tpu_torch.utils.card_timing \
        import PEAK_BYTES_S, PEAK_F32_S, device_ms
    lead = pose.shape[:-1]
    V = pose[..., 0].numel()
    h, w = kf.image.shape[-2:]
    nb = gn_kernel.blocks(h, w)
    parts = gn_kernel.linearize(kf, cur, pose, intr, cfg)
    st = gn_kernel.empty_state(pose)
    sys_ = alignment._gn_quantities(kf, cur, pose, intr, cfg)
    start = (torch.zeros(lead, dtype=torch.bool, device=pose.device),
             torch.full(lead, float("inf"), device=pose.device),
             torch.zeros(lead, dtype=torch.int32, device=pose.device),
             torch.zeros(lead, device=pose.device),
             torch.zeros(lead, device=pose.device))
    fns = {
        "linearize": lambda: gn_kernel.linearize(kf, cur, pose, intr, cfg),
        "finish": lambda: gn_kernel.finish(parts, pose, st, cfg, True),
        "plain_linearize": lambda: alignment._gn_quantities(
            kf, cur, pose, intr, cfg),
        "plain_update": lambda: alignment._gn_update(*sys_, pose, *start,
                                                     term_w),
        "plain_iteration": lambda: alignment._gn_update(
            *alignment._gn_quantities(kf, cur, pose, intr, cfg), pose,
            *start, term_w),
    }
    for f in fns.values():
        f()
    order = ["plain_iteration", "plain_linearize", "plain_update",
             "linearize", "finish"]
    turns = {k: [] for k in fns}
    for name in order + order[::-1]:
        reps = 10 if name.startswith("plain") else 200
        turns[name].append(device_ms(fns[name], reps)[0])
    ms = {k: sum(v) / len(v) for k, v in turns.items()}
    work = {
        # six planes read, the pose read, the partials written
        "linearize": (V * (6 * h * w + 6 + nb * gn_kernel.SUMS) * 4,
                      V * h * w * gn_kernel.OPS_PER_PIXEL),
        # the partials and the pose read, pose and five scalars written
        "finish": (V * (nb * gn_kernel.SUMS + 6 + 11) * 4,
                   V * (gn_kernel.FINISH_OPS + nb * gn_kernel.SUMS)),
    }
    plain_of = {"linearize": "plain_linearize", "finish": "plain_update"}
    out = {}
    for name, (nbytes, ops) in work.items():
        t_bytes, t_ops = nbytes / PEAK_BYTES_S, ops / PEAK_F32_S
        bound = 1e3 * max(t_bytes, t_ops)
        by = "bytes" if t_bytes >= t_ops else "operations"
        out[name] = (ms[name], ms[plain_of[name]], bound, by)
        print(f"gn_step {name} alone {label} level {level} ({h}x{w}) V={V}: "
              f"device time per call {ms[name]:.5f} ms (turns "
              f"{' '.join(f'{t:.5f}' for t in turns[name])}), plain "
              f"{plain_of[name]} {ms[plain_of[name]]:.5f} ms; bound "
              f"{bound:.6f} ms by {by} ({nbytes} B, {ops} float32 ops), "
              f"{100 * bound / ms[name]:.1f} % of it reached; on {gpu}")
    out["plain_iteration"] = ms["plain_iteration"]
    print(f"GN iteration {label} level {level} V={V}: the two single modes "
          f"{ms['linearize'] + ms['finish']:.5f} ms against the plain "
          f"iteration's {ms['plain_iteration']:.5f} ms; on {gpu}")
    return out


def k2_videos(args, V):
    """observe's arguments for V videos: the planes rolled by (b, 2b)
    pixels for video b, the pose moved by 2e-4 b in each component; V = 1
    gives the arguments as they are."""
    import torch
    from egomotion_with_local_loop_closures_tpu_torch.depth.state import (
        FIELDS, DepthMapState)
    st, *planes, pose = args
    if V == 1:
        return args

    def stack(t):
        return torch.stack([torch.roll(t, (b, 2 * b), (0, 1))
                            for b in range(V)])
    return (DepthMapState(**{n: stack(getattr(st, n)) for n in FIELDS}),
            *map(stack, planes),
            pose + 2e-4 * torch.arange(V, device=pose.device,
                                       dtype=torch.float32)[:, None])


def k2_video(args, b):
    """Video b of batched observe arguments."""
    from egomotion_with_local_loop_closures_tpu_torch.depth.state import (
        FIELDS, DepthMapState)
    st, *rest = args
    return (DepthMapState(**{n: getattr(st, n)[b] for n in FIELDS}),
            *(t[b] for t in rest))


def k2_differ(got, want):
    """Per video (one entry for an unbatched call): (pixels not bit-equal
    to the plain twin in some output plane, NaN equal to NaN; the largest
    |float difference| over every pixel)."""
    import torch
    from egomotion_with_local_loop_closures_tpu_torch.depth.state import (
        FIELDS)
    shape = want.state.valid.shape
    not_bits = torch.zeros(shape, dtype=torch.bool,
                           device=want.state.valid.device)
    err = torch.zeros(shape, device=not_bits.device)
    for n in FIELDS:
        a, b = getattr(got.state, n), getattr(want.state, n)
        if b.dtype.is_floating_point:
            err = torch.maximum(err, (a - b).abs().nan_to_num(0.0))
            not_bits |= ~((a == b) | (a.isnan() & b.isnan()))
        else:
            not_bits |= a != b
    return [(int(nb.sum()), float(e.max()))
            for nb, e in zip(*(x.reshape((-1,) + shape[-2:])
                               for x in (not_bits, err)))]


def same_bits(a, b):
    """Equal bit for bit, NaN equal to NaN."""
    import torch
    if a.dtype.is_floating_point:
        return bool(((a == b) | (a.isnan() & b.isnan())).all())
    return torch.equal(a, b)


def k2_walks(args, cfg, branches):
    """(walked pixels, the longest walk in steps, walked pixels whose
    segment's near end lies within a pixel of the border line,
    sample_point_to_border from an edge, where the segment is clamped; one
    clamped onto the line itself is out, code -1): the plain twin's
    decisions and segments on ``args``."""
    import torch
    from egomotion_with_local_loop_closures_tpu_torch.depth import stereo
    from egomotion_with_local_loop_closures_tpu_torch.geom import camera
    st, kf, *_, pose = args
    H, W = kf.shape[-2:]
    walked = branches["run"] & ((branches["code"] == 0)
                                | (branches["code"] == -2)
                                | (branches["code"] == -3))
    # observe's search band and segments, as depth/stereo.py::_observe
    x, y = camera.pixel_grid(H, W, device=kf.device)
    t_kc = stereo._pose_blocks(pose, cfg).t_kf_from_cur
    epxn, epyn, _ = stereo.epl_direction(kf, t_kc, cfg)
    sv = stereo._sqrt(torch.clamp_min(st.var_smoothed, 0.0))
    ids = st.idepth_smoothed
    min_id = torch.where(st.valid, torch.clamp_min(
        ids - sv * cfg.stereo_epl_var_fac, 0.0), 0.0)
    max_id = torch.where(st.valid, torch.clamp_max(
        ids + sv * cfg.stereo_epl_var_fac, 1.0 / cfg.min_depth),
        1.0 / cfg.min_depth)
    prior = torch.where(st.valid, ids, 1.0)
    seg = stereo._segment_setup(x, y, epxn, epyn, min_id, prior, max_id,
                                pose, H, W, cfg)
    b = cfg.sample_point_to_border
    at = torch.zeros_like(walked)
    for v, lim in ((seg.pclose_x, (b, W - b)), (seg.pclose_y, (b, H - b))):
        for edge in lim:
            at |= (v - edge).abs() < 1.0
    steps = branches["steps"][walked]
    return (int(walked.sum()), int(steps.max()) if steps.numel() else 0,
            int((walked & at).sum()))


def step_gaps(run):
    """Device-idle gaps between frame steps: a CUDA event before and after
    every ``pipeline.track_refine_step`` and ``keyframe_step`` call while
    ``run()`` runs, no profiler.  Returns (steps, ms from the first step's
    start to the last one's end on the card, ms inside steps, host
    seconds of run())."""
    import torch
    from egomotion_with_local_loop_closures_tpu_torch.runtime import pipeline
    events = []

    def timed(step):
        def call(*a, **k):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = step(*a, **k)
            end.record()
            events.append((start, end))
            return out
        return call
    steps = pipeline.track_refine_step, pipeline.keyframe_step
    pipeline.track_refine_step, pipeline.keyframe_step = map(timed, steps)
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        pipeline.track_refine_step, pipeline.keyframe_step = steps
    inside = sum(s.elapsed_time(e) for s, e in events)
    return (len(events), events[0][0].elapsed_time(events[-1][1]), inside,
            wall)


def replay_ms(graph, reps=50):
    """The card's time for one replay of a captured graph, the host ahead
    (a spin kernel holds the stream while the host queues the replays)."""
    import torch
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    torch.cuda.synchronize()
    ev[0].record()
    torch.cuda._sleep(100_000_000)
    ev[1].record()
    for _ in range(reps):
        graph.replay()
    ev[2].record()
    ev[2].synchronize()
    return ev[1].elapsed_time(ev[2]) / reps


def track_graph():
    """The captured graph of a one-video track_refine step (not a
    replay)."""
    from egomotion_with_local_loop_closures_tpu_torch.runtime import (
        graphs, pipeline)
    for (fn, (_, replay, *_)), g in graphs._graphs.items():
        if fn is pipeline._track_refine_step and g.lead == () and not replay:
            return g.graph
    raise RuntimeError("no one-video track_refine graph captured")


def print_gaps(label, gaps, frames, step_ms, gpu):
    """One line of step_gaps' reading beside a step graph's replay alone."""
    n, span, inside, wall = gaps
    print(f"idle gaps, {label}: {n} steps, {span:.3f} ms on the card from "
          f"the first step's start to the last one's end, {inside:.3f} ms "
          f"inside steps, {span - inside:.3f} ms between them "
          f"({100 * (span - inside) / span:.1f} % of the span); host "
          f"{1e3 * wall / frames:.4f} ms a frame; a track_refine graph "
          f"replayed alone, the host ahead, {step_ms:.4f} ms of device "
          f"time: {100 * step_ms * n / (1e3 * wall):.1f} % of the host's "
          f"wall if every step took that; on {gpu}")


def k2_work(args, cfg, branches):
    """(compulsory bytes, float32 operations on this data) of one K2 call
    on ``args``, from the plain twin's decisions: every pixel's gates, the
    pixels that run, those whose segment passed and the steps they
    walked."""
    import math
    st = args[0]
    n_px = st.valid.numel()
    V = math.prod(st.valid.shape[:-2])
    run = branches["run"]
    walked = run & ((branches["code"] == 0) | (branches["code"] == -2)
                    | (branches["code"] == -3))
    steps = int(branches["steps"][walked].sum())
    ops = (K2_OPS_PIXEL * n_px + K2_OPS_RUN * int(run.sum())
           + K2_OPS_WALKED * int(walked.sum()) + K2_OPS_STEP * steps)
    return K2_BYTES_PIXEL * n_px + K2_BYTES_VIDEO * V, ops


def k2_phase(cases, cfg, gpu):
    """Phase 3c: K2 against its plain twin on ``cases``, each (label,
    observe's arguments, timed[, its own config]), for one video and for
    K2_VIDEOS (see
    k2_videos): each video bit-equal to the twin, its counts equal, and,
    for K2_VIDEOS, bit-equal to its own call.  Returns the worst (pixels
    not bit-equal in a video, |float difference|),
    the plain twin's branch counts by case, and for the timed case {V:
    (ms, plain ms, bound ms, bound by)}."""
    import torch
    from egomotion_with_local_loop_closures_tpu_torch.depth import stereo
    from egomotion_with_local_loop_closures_tpu_torch.depth.state import (
        FIELDS)
    from egomotion_with_local_loop_closures_tpu_torch.ops import (
        stereo_kernel)
    branch_names = ("create_ok", "create_blacklist", "u_notfound",
                    "inconsistent", "u_success", "nf_kill")
    worst = [0, 0.0]
    branch_counts, timed = {}, {}
    for label, args0, is_timed, *case_cfg in cases:
        cfg_c = case_cfg[0] if case_cfg else cfg
        walks = k2_walks(args0, cfg_c, stereo.observe_branches(*args0, cfg_c))
        print(f"K2 {label}: the plain twin's walked pixels {walks[0]}, "
              f"longest walk {walks[1]} of {cfg_c.stereo_max_steps} steps, "
              f"walked pixels with the segment clamped at the border "
              f"{walks[2]}")
        if "border" in label:
            check(walks[2] > 0, f"K2 {label}: some walks end at the border")
        if cfg_c.stereo_max_steps == K2_MAX_STEPS:
            check(walks[1] > 32, f"K2 {label}: some walks take a lane's "
                  f"second step (longest {walks[1]})")
        for V in (1, K2_VIDEOS):
            args = k2_videos(args0, V)
            got = stereo_kernel.observe(*args, cfg_c)
            want = stereo.plain_observe(*args, cfg_c)
            br = stereo.observe_branches(*args, cfg_c)
            torch.cuda.synchronize()
            per = k2_differ(got, want)
            dc = int((got.num_created - want.num_created).abs().max())
            du = int((got.num_updated - want.num_updated).abs().max())
            worst = [max([worst[0]] + [nb for nb, _ in per]),
                     max([worst[1]] + [e for _, e in per])]
            counts = {k: int(br[k].sum()) for k in branch_names}
            codes = {c: int((br["run"] & (br["code"] == c)).sum())
                     for c in (0, -1, -2, -3, -4)}
            branch_counts[f"{label} V={V}"] = counts
            check(all(nb == 0 for nb, _ in per) and dc == du == 0,
                  f"K2 on {label} V={V}: every video bit-equal to the plain "
                  f"twin (pixels not bit-equal {[nb for nb, _ in per]}), "
                  f"counts equal (differ by {dc}, {du})")
            bits = ""
            if V > 1:
                for b in range(V):
                    alone = stereo_kernel.observe(*k2_video(args, b),
                                                  cfg_c)
                    same = all(same_bits(getattr(alone.state, f),
                                         getattr(got.state, f)[b])
                               for f in FIELDS)
                    check(same and int(alone.num_created)
                          == int(got.num_created[b]) and int(
                              alone.num_updated) == int(got.num_updated[b]),
                          f"K2 video {b} of {V} on {label} equals its own "
                          f"call bit for bit")
                bits = (f"; each of the {V} videos bit-equal to its own "
                        f"call")
            print(f"K2 {label} V={V}: pixels not bit-equal to the plain "
                  f"twin in every plane, per video {[nb for nb, _ in per]} "
                  f"(must be 0), max |float diff| "
                  f"{max(e for _, e in per):.3g}; "
                  f"created {got.num_created.tolist()} (plain "
                  f"{want.num_created.tolist()}), updated "
                  f"{got.num_updated.tolist()} (plain "
                  f"{want.num_updated.tolist()}); plain twin's codes of "
                  f"the pixels that run {codes}, branches {counts}{bits}")
            if is_timed:
                timed[V] = k2_times(args, cfg_c, br, gpu, label)
    return worst, branch_counts, timed


def k2_times(args, cfg, branches, gpu, label):
    """Device time per call of K2 and of the plain twin from CUDA-graph
    replays, in turns plain/kernel/kernel/plain, beside K2's bound."""
    from egomotion_with_local_loop_closures_tpu_torch.depth import stereo
    from egomotion_with_local_loop_closures_tpu_torch.ops import (
        stereo_kernel)
    from egomotion_with_local_loop_closures_tpu_torch.utils.card_timing \
        import PEAK_BYTES_S, PEAK_F32_S, device_ms
    kern = lambda: stereo_kernel.observe(*args, cfg)  # noqa: E731
    plain = lambda: stereo.plain_observe(*args, cfg)  # noqa: E731
    kern()
    plain()
    ts = [device_ms(f, reps)[0] for f, reps in
          ((plain, 10), (kern, 200), (kern, 200), (plain, 10))]
    k_ms, p_ms = (ts[1] + ts[2]) / 2, (ts[0] + ts[3]) / 2
    nbytes, ops = k2_work(args, cfg, branches)
    t_bytes, t_ops = nbytes / PEAK_BYTES_S, ops / PEAK_F32_S
    bound = 1e3 * max(t_bytes, t_ops)
    by = "bytes" if t_bytes >= t_ops else "operations"
    V = args[0].valid[..., 0, 0].numel()
    print(f"stereo_observe {label} V={V}: device time per call {k_ms:.5f} "
          f"ms (turns {' '.join(f'{t:.5f}' for t in ts)}), plain observe "
          f"{p_ms:.5f} ms; bound {bound:.6f} ms by {by} ({nbytes} B, {ops} "
          f"float32 ops: {1e6 * t_bytes:.3f} / {1e6 * t_ops:.3f} us), "
          f"{100 * bound / k_ms:.1f} % of it reached; on {gpu}")
    return k_ms, p_ms, bound, by


def merge_phase(cases, cfg, gpu):
    """Phase 3d: the merge kernels against their plain twin on ``cases``,
    each (label, candidates()' outputs, state shape, timed): every plane
    bit-equal to the twin, a second call bit-equal to the first; prints
    each case's candidates, compatible candidates and largest fan-in, and
    how many cells the merge before the kernels (float index_add_)
    differs from them in.  Returns the largest |float difference| (0),
    for each timed case (kernel ms, index_add_ ms, twin ms, bound ms,
    bound by), and each case's largest fan-in (by its label up to " (")."""
    import torch
    from egomotion_with_local_loop_closures_tpu_torch.depth.state import (
        FIELDS)
    from egomotion_with_local_loop_closures_tpu_torch.ops import (
        propagate_kernel as pk)
    from egomotion_with_local_loop_closures_tpu_torch.utils.card_timing \
        import PEAK_BYTES_S, PEAK_F32_S, device_ms
    worst, timed, fans = 0.0, {}, {}
    for label, args, shape, is_timed in cases:
        got = pk.merge(*args, shape, cfg)
        again = pk.merge(*args, shape, cfg)
        want = pk.plain_merge(*args, shape, cfg)
        old = index_add_merge(pk, *args, shape, cfg)
        torch.cuda.synchronize()
        worst = max(worst, compare(want, got, FIELDS))
        compare(got, again, FIELDS)
        tgt, cand = args[0], args[1]
        compat = pk._compat(tgt, cand, args[2], args[3], cfg, tgt.numel())
        n_cand, n_compat = int(cand.sum()), int(compat.sum())
        fan = int(torch.bincount(tgt[compat]).max()) if n_compat else 0
        fans[label.split(" (")[0]] = fan
        moved = sum(int((~same_elements(getattr(old, f), getattr(want, f)))
                        .sum()) for f in FIELDS)
        print(f"merge {label}: {tgt.numel()} cells, {n_cand} candidates, "
              f"{n_compat} compatible, largest fan-in {fan}; kernels "
              f"bit-equal to the twin in every plane and a second call "
              f"bit-equal to the first; the index_add_ merge differs from "
              f"the twin in {moved} plane elements")
        if not is_timed:
            continue
        kern = lambda: pk.merge(*args, shape, cfg)  # noqa: E731
        atomic = lambda: index_add_merge(pk, *args, shape, cfg)  # noqa: E731
        ts = [device_ms(f, reps)[0] for f, reps in
              ((atomic, 50), (kern, 200), (kern, 200), (atomic, 50))]
        k_ms, a_ms = (ts[1] + ts[2]) / 2, (ts[0] + ts[3]) / 2
        p_ms = call_ms(lambda: pk.plain_merge(*args, shape, cfg), reps=10)
        nbytes = MERGE_BYTES_CELL * tgt.numel() + MERGE_BYTES_CAND * n_cand
        ops = (MERGE_OPS_CAND * n_cand + MERGE_OPS_COMPAT * n_compat
               + MERGE_OPS_CELL * tgt.numel())
        t_bytes, t_ops = nbytes / PEAK_BYTES_S, ops / PEAK_F32_S
        bound = 1e3 * max(t_bytes, t_ops)
        by = "bytes" if t_bytes >= t_ops else "operations"
        print(f"merge {label}: device time per call (memset and two "
              f"launches) {k_ms:.5f} ms, the index_add_ merge {a_ms:.5f} ms "
              f"(turns {' '.join(f'{t:.5f}' for t in ts)}); the twin, one "
              f"eager call with its host read, {p_ms:.4f} ms; bound "
              f"{bound:.6f} ms by {by} ({nbytes} B, {ops} float32 ops: "
              f"{1e6 * t_bytes:.3f} / {1e6 * t_ops:.3f} us), "
              f"{100 * bound / k_ms:.1f} % of it reached; on {gpu}")
        timed[label] = (k_ms, a_ms, p_ms, bound, by)
    return worst, timed, fans


def index_add_merge(pk, tgt, cand, idepth, var, validity, shape, cfg):
    """The merge as the port ran it before the kernels, with float
    ``index_add_``: on the card its sums come in atomic order.  Phase 3d
    times the kernels beside it and counts the plane elements in which it
    parts from the twin; ``pk`` is ``ops/propagate_kernel.py``."""
    import torch
    n = tgt.numel()
    compat = pk._compat(tgt, cand, idepth, var, cfg, n)
    sums = [torch.zeros((n,), device=tgt.device).index_add_(0, tgt, t)
            for t in pk._terms(compat, idepth, var, validity)]
    return pk._finish(sums, shape, cfg)


def same_elements(a, b):
    """Elementwise bit-equality, NaN equal to NaN."""
    return (a == b) | (a != a) & (b != b)


def rank_child(argv) -> int:
    """One rank of phase 12: ``chip_smoke.py --rank-child RANK PORT DIR
    DEVICE``.  Joins the two-rank gloo group, runs the pixel-sharded GN
    linearization and the edge-sharded Sim(3) refinement on DEVICE (phase
    12 gives both ranks cuda:0) on the inputs in DIR/inputs.pt, and writes
    DIR/rank<RANK>.pt."""
    import torch
    sys.path.insert(0, ROOT)
    from egomotion_with_local_loop_closures_tpu_torch.config import (
        ELLCConfig)
    from egomotion_with_local_loop_closures_tpu_torch.graph import ba, sim3
    from egomotion_with_local_loop_closures_tpu_torch.ops import gn_kernel
    from egomotion_with_local_loop_closures_tpu_torch.parallel import (
        mesh, sharded)
    from egomotion_with_local_loop_closures_tpu_torch.track import alignment
    torch.backends.cuda.matmul.allow_tf32 = False
    rank, port, work, dev = int(argv[0]), argv[1], argv[2], torch.device(
        argv[3])
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    mesh.initialize_multihost(f"127.0.0.1:{port}", 2, rank, backend="gloo")
    inp = {k: v.to(dev) if isinstance(v, torch.Tensor) else v
           for k, v in torch.load(os.path.join(work, "inputs.pt")).items()}
    cfg = ELLCConfig(**inp["config"])
    gn_kernel.reset_launches()
    H, g = sharded.sharded_gn_quantities(
        alignment.KeyframeLevel(inp["kf_image"], inp["kf_depth"],
                                inp["kf_var"]),
        alignment.CurrentLevel(inp["cur_image"], inp["cur_gradx"],
                               inp["cur_grady"]), inp["pose"], 0, cfg)
    graph = sim3.Sim3Graph(inp["nodes"], inp["edges"], inp["meas"],
                           inp["weights"])
    nodes = ba.refine_sharded(graph, num_iters=cfg.sim3_iters).nodes
    torch.save({"H": H.cpu(), "g": g.cpu(), "nodes": nodes.cpu(),
                "k1": dict(gn_kernel.launches)},
               os.path.join(work, f"rank{rank}.pt"))
    torch.distributed.destroy_process_group()
    return 0


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    for need in (os.path.join(ROOT, PKG, "__init__.py"), FRAMES, GOLDEN,
                 LC_GOLDEN, LC_EDGES, RECOVERY_GOLDEN, BATCHED_GOLDEN,
                 SYNTHETIC_GOLDEN, PARITY_GOLDEN, BINARY_POSES):
        if not os.path.exists(need):
            print(f"chip_smoke: {need} is missing: run from a checkout of "
                  f"the repository", file=sys.stderr)
            return 2
    sys.path.insert(0, ROOT)
    import numpy as np

    import egomotion_with_local_loop_closures_tpu_torch as port
    from egomotion_with_local_loop_closures_tpu_torch.config import (
        ELLCConfig, PARITY_OVERRIDES)
    from egomotion_with_local_loop_closures_tpu_torch.depth import (
        propagate, state as dstate)
    from egomotion_with_local_loop_closures_tpu_torch.depth.state import (
        FIELDS, DepthMapState)
    from egomotion_with_local_loop_closures_tpu_torch.ops import (
        gn_kernel, propagate_kernel, reg_kernel, stereo_kernel)
    from egomotion_with_local_loop_closures_tpu_torch.parallel import sharded
    from egomotion_with_local_loop_closures_tpu_torch.runtime import (
        ellc_lc, graphs, io as ellc_io, pipeline, runner)
    from egomotion_with_local_loop_closures_tpu_torch.graph import ba
    from egomotion_with_local_loop_closures_tpu_torch.utils.card_timing \
        import PEAK_BYTES_S, PEAK_F32_S, device_ms
    from egomotion_with_local_loop_closures_tpu_torch.image import pyramid
    from egomotion_with_local_loop_closures_tpu_torch.runtime import cli
    from egomotion_with_local_loop_closures_tpu_torch.track import alignment
    from egomotion_with_local_loop_closures_tpu_torch.utils import (
        footprint, metrics, profiling, synthetic)
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

    phase("2 build K3, K1, K2 and the merge")
    t0 = time.perf_counter()
    # one nvcc for each source, started together
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(4) as pool:
        lib, lib_k1, lib_k2, lib_mg = pool.map(lambda m: m.build(), (
            reg_kernel, gn_kernel, stereo_kernel, propagate_kernel))
    reg_kernel._library()
    gn_kernel._library()
    stereo_kernel._library()
    propagate_kernel._library()
    print(f"built {os.path.relpath(lib, ROOT)}, "
          f"{os.path.relpath(lib_k1, ROOT)}, "
          f"{os.path.relpath(lib_k2, ROOT)} and "
          f"{os.path.relpath(lib_mg, ROOT)} in "
          f"{time.perf_counter() - t0:.2f} s")
    clock_mhz = float(run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                           "--format=csv,noheader,nounits"]).splitlines()[0])
    cuobjdump = os.path.join(os.path.dirname(reg_kernel._find_nvcc()),
                             "cuobjdump")
    for lib_k in (lib_k1, lib_k2, lib_mg):
        k_sass = sass_counts(lib_k, cuobjdump)
        for fn, res in kernel_resources(lib_k, cuobjdump).items():
            print(f"{fn}: {res}; {sum(k_sass[fn])} SASS instructions")
    # K2's registers, stack and shared memory (its list and the current
    # image's box are dynamic shared memory, kSmemBytes a block)
    res_k2 = kernel_resources(lib_k2, cuobjdump)["stereo_observe"]
    print(f"K2 stereo_observe: {res_k2}")
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

    phase(f"3b K1 against plain PyTorch: every level, V = 1 and "
          f"{K1_VIDEOS}, seeded and real planes")
    check(gn_kernel.align_launches(cfg) == K1_ALIGN
          and gn_kernel.align_launches(cfg, cfg.max_iters_replay)
          == K1_REPLAY_ALIGN, "K1's hand counts are the config's iteration "
          "counts and levels, by gn_kernel.CLUSTER_MAX_PIXELS")
    tk = load_tool("time_k1_levels")
    img0, depth0, var0, img1 = (torch.as_tensor(a, device=dev) for a in
                                tk.gn_planes(5, cfg.shape))
    seeded_kf = alignment.make_keyframe_levels(img0, depth0, var0, cfg)
    seeded_cur = alignment.make_current_levels(pyramid.build_pyramid(
        img1, cfg.num_levels))
    seeded_pose = torch.tensor([2e-3, -1e-3, 1.5e-3, 4e-3, 7e-3, -3e-3],
                               device=dev)
    # phase 3's keyframe (frame 8) and frame 9 at the pose K1 tracks it to
    real_kf = pipeline._kf_levels(st.kf)
    real_cur = alignment.make_current_levels(pyramid.build_pyramid(
        torch.as_tensor(frames[8], device=dev), cfg.num_levels))
    real_pose, _ = alignment.align(real_kf, real_cur, st.prev_wrt_kf, cfg)
    worst_k1, timed_k1 = k1_phase(
        [("seeded 270x480", seeded_kf, seeded_cur, seeded_pose, False),
         ("real 270x480", real_kf, real_cur, real_pose, True)], cfg, dev, gpu)
    # each level's iterations and one align as one graph each, as the
    # step graphs hold them, from the pose the pipeline starts align at
    levels_k1 = tk.level_times(
        real_kf, real_cur, st.prev_wrt_kf, cfg, gpu)

    phase(f"3c K2 against plain PyTorch: V = 1 and {K2_VIDEOS}, seeded and "
          f"real planes, fresh and evolved states")
    # seeded: phase 3b's images and phase 3's seeded state; real: phase 3's
    # keyframe (frame 8) and frame 9 at the pose K1 tracks it to, from no
    # hypothesis (the create path), from the pipeline's state (the update
    # path) and from that state with a quarter of its variances near
    # max_var (a failed update there kills its pixel)
    def kf_planes(img):
        gx, gy = pyramid.gradients(img)
        return img, gx, gy, pyramid.max_abs_gradient(gx, gy)
    seeded_st, _ = on_card(random_planes(7, cfg.shape))
    seeded_obs = (*kf_planes(img0), img1, seeded_pose)
    real_obs = (st.kf.images[0], st.kf.gradx, st.kf.grady, st.kf.maxgrad,
                torch.as_tensor(frames[8], device=dev), real_pose)
    quarter = torch.as_tensor(np.random.default_rng(3).uniform(
        size=cfg.shape) < 0.25, device=dev)
    stressed = st.depth.replace(var=torch.where(
        st.depth.valid & quarter, 0.24, st.depth.var))
    fresh = dstate.empty(cfg.shape, dev)
    # the seeded pose's translation eight times over: long segments, some
    # of them walked to within a pixel of the border line (the real frames
    # have no texture there); and the kernel's most steps
    border_obs = seeded_obs[:-1] + (seeded_pose * torch.tensor(
        [1.0, 1.0, 1.0, 8.0, 8.0, 8.0], device=dev),)
    cfg_long = cfg.replace(stereo_max_steps=K2_MAX_STEPS,
                           max_epl_length_crop=K2_LONG_CROP)
    worst_k2, branches_k2, timed_k2 = k2_phase(
        [("seeded 270x480, seeded state", (seeded_st, *seeded_obs), False),
         ("seeded 270x480, fresh state", (fresh, *seeded_obs), False),
         ("real 270x480, fresh state", (fresh, *real_obs), False),
         ("real 270x480, pipeline state", (st.depth, *real_obs), True),
         ("real 270x480, pipeline state, variances near max_var",
          (stressed, *real_obs), False),
         ("seeded 270x480, fresh state, segments at the border (the "
          "translation x8)", (fresh, *border_obs), False),
         (f"real 270x480, pipeline state, {K2_MAX_STEPS} steps and a "
          f"{K2_LONG_CROP:g}-pixel crop", (st.depth, *real_obs), False,
          cfg_long)], cfg, gpu)
    on_real = {k: sum(c[k] for label, c in branches_k2.items()
                      if label.startswith("real"))
               for k in next(iter(branches_k2.values()))}
    print(f"K2 branches on the real frames, summed: {on_real}")
    check(all(n > 0 for n in on_real.values()),
          "the real frames exercise every EKF branch")

    phase("3d propagate's merge kernels against their plain twin: one "
          "state, 8 videos, 20 trials and a zoom-out, at 270x480")
    # phase 3's keyframe (the state after frame 8) propagated into frame 9
    # at its tracked pose, as a keyframe step propagates
    img9 = torch.as_tensor(frames[8], device=dev)
    mg9 = pyramid.max_abs_gradient(*pyramid.gradients(img9))

    def merge_case(B, dy, dx, dpose, c=cfg):
        """candidates() of B copies of phase 3's state and keyframe, copy b
        rolled by (dy b, dx b) pixels, its pose moved by dpose b."""
        if B is None:
            return (propagate.candidates(st.depth, st.kf.images[0], img9,
                                         mg9, real_pose + dpose, c),
                    cfg.shape)
        depth = DepthMapState(**{n: torch.stack([
            torch.roll(getattr(st.depth, n), (dy * b, dx * b), (0, 1))
            for b in range(B)]) for n in FIELDS})
        old = torch.stack([torch.roll(st.kf.images[0], (dy * b, dx * b),
                                      (0, 1)) for b in range(B)])
        poses = torch.stack([real_pose + dpose * b for b in range(B)])
        return (propagate.candidates(depth, old, img9, mg9, poses, cfg),
                (B,) + cfg.shape)
    zoom = torch.zeros(6, device=dev)
    zoom[5] = MERGE_ZOOM
    worst_mg, timed_mg, fans_mg = merge_phase(
        [(label, *merge_case(*spec), is_timed) for label, spec, is_timed in (
            ("one state", (None, 0, 0, torch.zeros(6, device=dev)), True),
            (f"{K2_VIDEOS} videos", (K2_VIDEOS, 1, 2,
                                     torch.full((6,), 2e-4, device=dev)),
             True),
            (f"{RECOVERY_BATCH} trials", (RECOVERY_BATCH, 7, 23,
                                          torch.zeros(6, device=dev)), True),
            (f"zoom-out (the camera {MERGE_ZOOM:g} back)",
             (None, 0, 0, zoom, cfg.replace(max_diff_constant=1e6)),
             False))], cfg, gpu)
    chunk = int(re.search(r"kChunk = (\d+);",
                          propagate_kernel.SOURCE.read_text()).group(1))
    check(fans_mg["zoom-out"] > chunk, f"the zoom-out's largest fan-in "
          f"{fans_mg['zoom-out']} passes the kernel's {chunk} a walk")

    phase(f"4 main path: run_sequence over {MAIN_FRAMES} frames on cuda")
    n_track, n_kf = schedule(MAIN_FRAMES, cfg.keyframe_interval)
    expect = {"do_regularization": n_track + 2 * n_kf, "regularize": 1 + n_kf}
    check(n_track + n_kf == K1_STEPS["gn_run_sequence"][0],
          "K1's hand count of phase 4 is the schedule's")
    check(n_kf == MERGE_CALLS["gn_run_sequence"],
          "the merge's hand count of phase 4 is the schedule's")
    with tempfile.TemporaryDirectory() as out:
        torch.cuda.synchronize()
        reg_kernel.reset_launches()
        gn_kernel.reset_launches()
        stereo_kernel.reset_launches()
        propagate_kernel.reset_launches()
        t0 = time.perf_counter()
        res = runner.run_sequence(iter(frames[:MAIN_FRAMES]), cfg, dev,
                                  out_dir=out)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(reg_kernel.launches)
        launches_k1 = {"gn_run_sequence": dict(gn_kernel.launches)}
        launches_k2 = {"gn_run_sequence": dict(stereo_kernel.launches)}
        launches_mg = {"gn_run_sequence": dict(propagate_kernel.launches)}
        warmups = {"gn_run_sequence": dict(reg_kernel.warmup_launches)}
        warmups_k1 = {"gn_run_sequence": dict(gn_kernel.warmup_launches)}
        warmups_k2 = {"gn_run_sequence": dict(stereo_kernel.warmup_launches)}
        warmups_mg = {"gn_run_sequence": dict(
            propagate_kernel.warmup_launches)}
        poses_file = ellc_io.read_pose_file(os.path.join(out,
                                                         "poses_orig.txt"))
        matches = ellc_io.read_pose_file(os.path.join(out, "matchframes.txt"))
    print(f"schedule: {n_track} track_refine + {n_kf} keyframe steps; K3 "
          f"launches {launches}, expected {expect}; K1 launches "
          f"{launches_k1['gn_run_sequence']}, expected "
          f"{k1_expected('gn_run_sequence')}; the graphs' warm-ups launched "
          f"{warmups['gn_run_sequence']} and "
          f"{warmups_k1['gn_run_sequence']} more")
    check(launches == expect, "K3 launch counts match the frame schedule")
    check(launches_k1["gn_run_sequence"] == k1_expected("gn_run_sequence"),
          "K1 launch counts match the frame schedule")
    print(f"K2 launches {launches_k2['gn_run_sequence']}, expected "
          f"{k2_expected('gn_run_sequence')} (one a track_refine step); the "
          f"warm-ups launched {warmups_k2['gn_run_sequence']} more")
    check(n_track == K2_STEPS["gn_run_sequence"]
          and launches_k2["gn_run_sequence"]
          == k2_expected("gn_run_sequence"),
          "K2 launch counts match the frame schedule")
    print(f"merge launches {launches_mg['gn_run_sequence']}, expected "
          f"{merge_expected('gn_run_sequence')} (one a keyframe step)")
    check(launches_mg["gn_run_sequence"] == merge_expected("gn_run_sequence"),
          "the merge kernels' launch counts match one a keyframe step")
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

    # device-idle gaps (no profiler): CUDA events around every step of the
    # same run once more, its graphs captured, beside one track_refine
    # graph replayed alone with the host ahead
    with tempfile.TemporaryDirectory() as out:
        gaps4 = step_gaps(lambda: runner.run_sequence(
            iter(frames[:MAIN_FRAMES]), cfg, dev, out_dir=out))
    print_gaps(f"phase 4's run_sequence ({MAIN_FRAMES - 1} frames, init and "
               f"frame reads included)", gaps4, MAIN_FRAMES - 1,
               replay_ms(track_graph()), gpu)

    # intervals_per_dispatch: outputs read every 4 intervals (the default
    # above) against every interval, in turns 1/4/4/1 on the same frames;
    # every turn must give the first run's bits: no step sums with a float
    # atomic, so a run on the card reproduces
    turns4 = []
    for ipd in (1, 4, 4, 1):
        r = runner.run_sequence(iter(frames[:MAIN_FRAMES]), cfg, dev,
                                intervals_per_dispatch=ipd)
        (n_a, t_a), (n_b, t_b) = r.extra["block_times"][0], \
            r.extra["block_times"][-1]
        turns4.append((ipd, (n_b - n_a) / (t_b - t_a),
                       len(r.extra["block_times"]), r))
        check(r.frame_ids.tolist() == res.frame_ids.tolist()
              and r.kf_ids.tolist() == res.kf_ids.tolist(),
              f"intervals_per_dispatch {ipd}: the same frames and keyframes")
        same = [np.array_equal(getattr(r, f), getattr(res, f))
                for f in ("world_poses", "seeds", "rescales")]
        check(all(same), f"intervals_per_dispatch {ipd}: poses, seeds and "
              f"rescales bit-equal to the first run ({same})")
    d4 = max(float(np.abs(t[3].world_poses - res.world_poses).max())
             for t in turns4)
    print("intervals_per_dispatch in turns 1/4/4/1, frames/s after the "
          "first interval (reads): " + ", ".join(
              f"{ipd}: {v:.3f} ({n})" for ipd, v, n, _ in turns4)
          + f"; max |pose diff| from the run above {d4:.3g} (every turn "
          f"bit-equal to it); on {gpu}")

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
    gn_kernel.reset_launches()
    stereo_kernel.reset_launches()
    propagate_kernel.reset_launches()
    t0 = time.perf_counter()
    res6 = ellc_lc.run_ellc_lc(iter(lc_frames[:n_lc]),
                               lc_cfg.replace(do_sim3_refine=True), dev,
                               max_frames=lc_golden["max_frames"],
                               stats=stats6)
    torch.cuda.synchronize()
    wall6 = time.perf_counter() - t0
    launches6 = dict(reg_kernel.launches)
    launches_k1["lc_bootstrap"] = dict(gn_kernel.launches)
    launches_k2["lc_bootstrap"] = dict(stereo_kernel.launches)
    launches_mg["lc_bootstrap"] = dict(propagate_kernel.launches)
    warmups["lc_bootstrap"] = dict(reg_kernel.warmup_launches)
    warmups_k1["lc_bootstrap"] = dict(gn_kernel.warmup_launches)
    warmups_k2["lc_bootstrap"] = dict(stereo_kernel.warmup_launches)
    warmups_mg["lc_bootstrap"] = dict(
        propagate_kernel.warmup_launches)
    print(f"K1 launches {launches_k1['lc_bootstrap']}, expected "
          f"{k1_expected('lc_bootstrap')}")
    check(launches_k1["lc_bootstrap"] == k1_expected("lc_bootstrap"),
          "K1 launch counts match the LC bootstrap")
    print(f"K2 launches {launches_k2['lc_bootstrap']}, expected "
          f"{k2_expected('lc_bootstrap')}")
    check(launches_k2["lc_bootstrap"] == k2_expected("lc_bootstrap"),
          "K2 launch counts match the LC bootstrap")
    print(f"merge launches {launches_mg['lc_bootstrap']}, expected "
          f"{merge_expected('lc_bootstrap')} (one a keyframe step of the LC bootstrap)")
    check(launches_mg["lc_bootstrap"] == merge_expected("lc_bootstrap"),
          "the merge kernels' launch counts match one a keyframe step of the LC bootstrap")
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
    own, own2 = (ellc_lc._sim3_refine_trajectory(
        np.asarray(lc_golden["frame_ids"]),
        np.asarray(lc_golden["world_poses"], np.float32),
        [types.SimpleNamespace(**e) for e in g_edges],
        lc_cfg.replace(do_sim3_refine=True), dev) for _ in range(2))
    sim3_s = (time.perf_counter() - t0) / 2
    check(np.array_equal(own, own2), "two Sim(3) refinements of the golden "
          "inputs give the same nodes bit for bit")
    d_own = float(np.abs(own - g_sim3).max())
    d_run = float(np.abs(res6.sim3_world_poses - g_sim3).max())
    print(f"Sim(3): on the golden file's inputs max |refined pose diff| "
          f"{d_own:.3g} (tol 1e-4) in {sim3_s:.3f} s a refinement (two "
          f"runs bit-equal); the run's refined "
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
    gn_kernel.reset_launches()
    stereo_kernel.reset_launches()
    propagate_kernel.reset_launches()
    t0 = time.perf_counter()
    res7 = ellc_lc.run_ellc_lc(iter(lc_frames[:LC_FRAMES]), lc_cfg, dev,
                               stats=stats7)
    torch.cuda.synchronize()
    wall7 = time.perf_counter() - t0
    launches7 = dict(reg_kernel.launches)
    launches_k1["lc_mode"] = dict(gn_kernel.launches)
    launches_k2["lc_mode"] = dict(stereo_kernel.launches)
    launches_mg["lc_mode"] = dict(propagate_kernel.launches)
    warmups["lc_mode"] = dict(reg_kernel.warmup_launches)
    warmups_k1["lc_mode"] = dict(gn_kernel.warmup_launches)
    warmups_k2["lc_mode"] = dict(stereo_kernel.warmup_launches)
    warmups_mg["lc_mode"] = dict(
        propagate_kernel.warmup_launches)
    print(f"K1 launches {launches_k1['lc_mode']}, expected "
          f"{k1_expected('lc_mode')} (143 tracked and 143 replayed frames)")
    check(launches_k1["lc_mode"] == k1_expected("lc_mode"),
          "K1 launch counts match the LC schedule with replays")
    print(f"K2 launches {launches_k2['lc_mode']}, expected "
          f"{k2_expected('lc_mode')} (track_refine steps, replays included)")
    check(launches_k2["lc_mode"] == k2_expected("lc_mode"),
          "K2 launch counts match the LC schedule with replays")
    print(f"merge launches {launches_mg['lc_mode']}, expected "
          f"{merge_expected('lc_mode')} (the LC keyframe steps with replays)")
    check(launches_mg["lc_mode"] == merge_expected("lc_mode"),
          "the merge kernels' launch counts match the LC keyframe steps with replays")
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
    gn_kernel.reset_launches()
    stereo_kernel.reset_launches()
    propagate_kernel.reset_launches()
    t0 = time.perf_counter()
    res8 = runner.run_sequence(iter(rec_frames), rec_cfg, dev)
    torch.cuda.synchronize()
    wall8 = time.perf_counter() - t0
    launches8 = dict(reg_kernel.launches)
    launches_k1["recovery"] = dict(gn_kernel.launches)
    launches_k2["recovery"] = dict(stereo_kernel.launches)
    launches_mg["recovery"] = dict(propagate_kernel.launches)
    warmups["recovery"] = dict(reg_kernel.warmup_launches)
    warmups_k1["recovery"] = dict(gn_kernel.warmup_launches)
    warmups_k2["recovery"] = dict(stereo_kernel.warmup_launches)
    warmups_mg["recovery"] = dict(
        propagate_kernel.warmup_launches)
    print(f"K1 launches {launches_k1['recovery']}, expected "
          f"{k1_expected('recovery')}")
    check(launches_k1["recovery"] == k1_expected("recovery"),
          "K1 launch counts match the recovery schedule")
    print(f"K2 launches {launches_k2['recovery']}, expected "
          f"{k2_expected('recovery')}")
    check(launches_k2["recovery"] == k2_expected("recovery"),
          "K2 launch counts match the recovery schedule")
    print(f"merge launches {launches_mg['recovery']}, expected "
          f"{merge_expected('recovery')} (the keyframe steps and the two batched trials)")
    check(launches_mg["recovery"] == merge_expected("recovery"),
          "the merge kernels' launch counts match the keyframe steps and the two batched trials")
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
        graphs.release((V,))
        if V == BATCH_VIDEOS:
            reg_kernel.reset_launches()
            gn_kernel.reset_launches()
            stereo_kernel.reset_launches()
            propagate_kernel.reset_launches()
        states9, outs9, wall9, peak9 = batched_run(V)
        if V == BATCH_VIDEOS:
            launches9 = dict(reg_kernel.launches)
            launches_k1["batched_videos"] = dict(gn_kernel.launches)
            launches_k2["batched_videos"] = dict(stereo_kernel.launches)
            launches_mg["batched_videos"] = dict(propagate_kernel.launches)
            warmups["batched_videos"] = dict(reg_kernel.warmup_launches)
            warmups_k1["batched_videos"] = dict(gn_kernel.warmup_launches)
            warmups_k2["batched_videos"] = dict(stereo_kernel.warmup_launches)
            warmups_mg["batched_videos"] = dict(
                propagate_kernel.warmup_launches)
        pred = predicted[V].peak_bytes
        pools = {r["pool"]: r["pool_bytes"] for r in graphs.stats()
                 if r["lead"] == (V,)}
        sweep[V] = (wall9, V * (n_per - 1) / wall9, peak9, pred)
        print(f"V={V}: {V * (n_per - 1)} tracked frames in {wall9:.3f} s "
              f"(the graphs' captures included), "
              f"{V * (n_per - 1) / wall9:.3f} aggregate frames/s; peak "
              f"{peak9 / 2**20:.1f} MiB, predicted {pred / 2**20:.1f} MiB "
              f"({100 * (peak9 / pred - 1):+.1f} %), graph pool "
              f"{sum(pools.values()) / 2**20:.1f} MiB; on {gpu}")
        if V in (4, 8):
            check(abs(peak9 / pred - 1) <= FOOTPRINT_TOL,
                  f"the footprint prediction holds within 25 % at V={V}")
        graphs.release((V,))
        if V != BATCH_VIDEOS:
            del states9, outs9
    print(f"K3 launches {launches9}, expected {BATCH_LAUNCHES} (one "
          f"video's count for {BATCH_VIDEOS} videos)")
    check(launches9 == BATCH_LAUNCHES, "the videos share each K3 launch")
    print(f"K1 launches {launches_k1['batched_videos']}, expected "
          f"{k1_expected('batched_videos')} (one video's count for "
          f"{BATCH_VIDEOS} videos)")
    check(launches_k1["batched_videos"] == k1_expected("batched_videos"),
          "the videos share each K1 launch")
    print(f"K2 launches {launches_k2['batched_videos']}, expected "
          f"{k2_expected('batched_videos')} (one video's count for "
          f"{BATCH_VIDEOS} videos)")
    check(launches_k2["batched_videos"] == k2_expected("batched_videos"),
          "the videos share each K2 launch")
    print(f"merge launches {launches_mg['batched_videos']}, expected "
          f"{merge_expected('batched_videos')} (one video's count for all videos)")
    check(launches_mg["batched_videos"] == merge_expected("batched_videos"),
          "the merge kernels' launch counts match one video's count for all videos")
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

    with open(SYNTHETIC_GOLDEN) as f:
        syn_golden = json.load(f)["full_width"]
    syn_cfg = cfg.replace(rows=syn_golden["rows"], cols=syn_golden["cols"],
                          bootstrap_rng="glibc")
    phase(f"10 synthetic: the port's CLI --synthetic {SYNTHETIC_FRAMES} at "
          f"{syn_cfg.rows}x{syn_cfg.cols} in a subprocess on cuda")
    check(syn_golden["num_input_frames"] == SYNTHETIC_FRAMES,
          f"the synthetic golden file covers {SYNTHETIC_FRAMES} frames")
    n_track, n_kf = schedule(SYNTHETIC_FRAMES, cfg.keyframe_interval)
    check({"do_regularization": n_track + 2 * n_kf, "regularize": 1 + n_kf}
          == SYNTHETIC_LAUNCHES, "the synthetic hand count is the schedule's")
    with tempfile.TemporaryDirectory() as out:
        # the CLI in its own process; the wrapper resets K3's counts just
        # before cli.main and prints them just after
        code = (f"import json, sys; sys.path.insert(0, {ROOT!r}); "
                f"from {PKG}.ops import gn_kernel, propagate_kernel, "
                f"reg_kernel, stereo_kernel; "
                f"from {PKG}.runtime import cli; "
                f"reg_kernel.reset_launches(); "
                f"gn_kernel.reset_launches(); "
                f"stereo_kernel.reset_launches(); "
                f"propagate_kernel.reset_launches(); "
                f"rc = cli.main(sys.argv[1:]); "
                f"print('K3 launches ' + json.dumps(reg_kernel.launches)); "
                f"print('K3 warm-up launches ' + "
                f"json.dumps(reg_kernel.warmup_launches)); "
                f"print('K1 launches ' + json.dumps(gn_kernel.launches)); "
                f"print('K1 warm-up launches ' + "
                f"json.dumps(gn_kernel.warmup_launches)); "
                f"print('K2 launches ' + json.dumps(stereo_kernel.launches)); "
                f"print('K2 warm-up launches ' + "
                f"json.dumps(stereo_kernel.warmup_launches)); "
                f"print('merge launches ' + "
                f"json.dumps(propagate_kernel.launches)); "
                f"print('merge warm-up launches ' + "
                f"json.dumps(propagate_kernel.warmup_launches)); "
                f"sys.exit(rc)")
        argv = ["--synthetic", str(SYNTHETIC_FRAMES), "--rows",
                str(syn_cfg.rows), "--cols", str(syn_cfg.cols),
                "--glibc-init", "--device", "cuda", "--out", out]
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-c", code, *argv],
                              capture_output=True, text=True, cwd=ROOT,
                              timeout=600)
        wall10 = time.perf_counter() - t0
        print(proc.stdout.strip())
        check(proc.returncode == 0, f"the CLI exits 0: {proc.stderr[-3000:]}")
        launches10 = json.loads(re.search(r"K3 launches (\{.*\})",
                                          proc.stdout).group(1))
        warmups["synthetic"] = json.loads(re.search(
            r"K3 warm-up launches (\{.*\})", proc.stdout).group(1))
        launches_k1["synthetic"] = json.loads(re.search(
            r"K1 launches (\{.*\})", proc.stdout).group(1))
        warmups_k1["synthetic"] = json.loads(re.search(
            r"K1 warm-up launches (\{.*\})", proc.stdout).group(1))
        launches_k2["synthetic"] = json.loads(re.search(
            r"K2 launches (\{.*\})", proc.stdout).group(1))
        warmups_k2["synthetic"] = json.loads(re.search(
            r"K2 warm-up launches (\{.*\})", proc.stdout).group(1))
        launches_mg["synthetic"] = json.loads(re.search(
            r"merge launches (\{.*\})", proc.stdout).group(1))
        warmups_mg["synthetic"] = json.loads(re.search(
            r"merge warm-up launches (\{.*\})", proc.stdout).group(1))
        gt10 = np.loadtxt(os.path.join(out, "poses_gt.txt"))
        orig10 = ellc_io.read_pose_file(os.path.join(out, "poses_orig.txt"))
    ids10 = orig10[:, 0].astype(int)
    d_gt = float(np.abs(gt10 - np.asarray(syn_golden["poses_gt"])).max())
    ate10 = float(metrics.ate_rmse(torch.as_tensor(orig10[:, 2:8]),
                                   torch.as_tensor(gt10[ids10 - 1])))
    ate_limit = syn_golden["ate"] + SYNTHETIC_ATE_SLACK
    print(f"K3 launches {launches10}, expected {SYNTHETIC_LAUNCHES}; "
          f"{len(ids10)} tracked frames, subprocess wall {wall10:.3f} s "
          f"(process start, render and run); poses_gt.txt against the JAX "
          f"trajectory: max |diff| {d_gt:.3g} (tol {TRAJ_TOL}); ATE "
          f"{ate10:.6g} against the JAX package's {syn_golden['ate']:.6g} "
          f"(limit {ate_limit:.6g}, slack {SYNTHETIC_ATE_SLACK}); seeds% min "
          f"{orig10[:, 9].min():.3f} (JAX {min(syn_golden['seeds']):.3f}); "
          f"on {gpu}")
    check(launches10 == SYNTHETIC_LAUNCHES, "K3 launch counts match the "
          "synthetic schedule")
    check(n_track + n_kf == K1_STEPS["synthetic"][0]
          and launches_k1["synthetic"] == k1_expected("synthetic"),
          f"K1 launch counts {launches_k1['synthetic']} match the synthetic "
          f"schedule's {k1_expected('synthetic')}")
    check(n_track == K2_STEPS["synthetic"]
          and launches_k2["synthetic"] == k2_expected("synthetic"),
          f"K2 launch counts {launches_k2['synthetic']} match the synthetic "
          f"schedule's {k2_expected('synthetic')}")
    check(n_kf == MERGE_CALLS["synthetic"]
          and launches_mg["synthetic"] == merge_expected("synthetic"),
          f"the merge kernels' launch counts {launches_mg['synthetic']} "
          f"match the synthetic schedule's {merge_expected('synthetic')}")
    check(ids10.tolist() == syn_golden["frame_ids"], "synthetic frame ids")
    check(bool(np.isfinite(orig10).all()), "synthetic poses finite")
    check(d_gt <= TRAJ_TOL, "poses_gt.txt matches the JAX trajectory")
    check(ate10 <= ate_limit, "the synthetic ATE is within the JAX "
          "package's plus the slack")
    scene = synthetic.make_room_scene(seed=0, **cli.SYNTHETIC_SCENE)
    gt_t = synthetic.trajectory(SYNTHETIC_FRAMES, seed=0,
                                **cli.SYNTHETIC_TRAJECTORY)
    intr = syn_cfg.level_intrinsics(0)
    three = gt_t[[0, SYNTHETIC_FRAMES // 2, SYNTHETIC_FRAMES - 1]]
    img_c, z_c = synthetic.render_sequence(scene, three.to(dev), syn_cfg.rows,
                                           syn_cfg.cols, *intr)
    img_h, z_h = synthetic.render_sequence(scene, three, syn_cfg.rows,
                                           syn_cfg.cols, *intr)
    d_img = (img_c.cpu() - img_h).abs()
    d_z = (z_c.cpu() / z_h - 1.0).abs()
    off = float(((d_img > RENDER_TOL) | (d_z > DEPTH_RTOL)).float().mean())
    print(f"render of 3 poses on the card against the CPU: max |image "
          f"diff| {float(d_img.max()):.3g} (tol {RENDER_TOL}), max relative "
          f"depth diff {float(d_z.max()):.3g} (tol {DEPTH_RTOL}), pixels "
          f"past them {100 * off:.4f} % (at most {100 * SEAM_FRAC} %)")
    check(off <= SEAM_FRAC, "the card's render matches the CPU's")

    phase("11 accuracy: phase 4's poses against the binary's poses_orig.txt")
    parity = load_tool("port_parity_eval")
    binary = parity.load_reference(BINARY_POSES)
    ours11 = parity.score(binary, res.frame_ids, res.world_poses, res.seeds,
                          cfg.keyframe_interval, last_frame=MAIN_FRAMES)
    jax11 = parity.jax_scores(binary, MAIN_FRAMES, cfg.keyframe_interval)
    for who, sc in (("port (card)", ours11), ("JAX package (CPU golden)",
                                              jax11)):
        print(f"{who}: {sc['frames_compared']} frames to frame "
              f"{sc['compared_until']}; RPE-8f mean "
              f"{sc['rpe_8f']['mean_deg']:.4f} median "
              f"{sc['rpe_8f']['median_deg']:.4f} deg, RPE-40f mean "
              f"{sc['rpe_40f']['mean_deg']:.4f} deg, ATE {sc['ate']:.5f}, "
              f"seeds% {sc['seeds_mean']:.3f} (binary "
              f"{sc['seeds_reference_mean']:.3f})")
    check(ours11["frames_compared"] == MAIN_FRAMES - 1
          and jax11["frames_compared"] == MAIN_FRAMES - 1,
          "both runs track every frame the binary tracks to frame 129")
    check(all(np.isfinite([s["ate"], s["rpe_8f"]["mean_deg"],
                           s["rpe_40f"]["mean_deg"]]).all()
              for s in (ours11, jax11)), "the scores are finite")

    phase("12 two ranks on cuda:0 over gloo: pixel-sharded GN and "
          "edge-sharded Sim(3)")
    # a real keyframe (frame 8 of run_gn, phase 3's state) and the next
    # frame at the pose the pipeline tracks it to
    _, out12 = pipeline.track_refine_step(st, frames[8], cfg)
    kf12 = pipeline._kf_levels(st.kf)[0]
    cur12 = alignment.make_current_levels(pyramid.build_pyramid(
        torch.as_tensor(frames[8], device=dev), cfg.num_levels))[0]
    H1, g1, e1, _ = alignment._gn_quantities(kf12, cur12, out12.pose_wrt_kf,
                                             cfg.level_intrinsics(0), cfg)
    graph12 = golden_sim3_graph(lc_golden, lc_cfg, dev)
    nodes1 = ba.refine(graph12, num_iters=lc_cfg.sim3_iters).nodes
    with tempfile.TemporaryDirectory() as work:
        torch.save({"config": {k: getattr(cfg, k) for k in
                               ("rows", "cols", "fx", "fy", "cx", "cy")},
                    "kf_image": kf12.image.cpu(), "kf_depth": kf12.depth.cpu(),
                    "kf_var": kf12.var.cpu(), "cur_image": cur12.image.cpu(),
                    "cur_gradx": cur12.gradx.cpu(),
                    "cur_grady": cur12.grady.cpu(),
                    "pose": out12.pose_wrt_kf.cpu(),
                    **{k: getattr(graph12, k).cpu() for k in
                       ("nodes", "edges", "meas", "weights")}},
                   os.path.join(work, "inputs.pt"))
        import socket
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            port12 = sock.getsockname()[1]
        t0 = time.perf_counter()
        procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__),
                                   "--rank-child", str(r), str(port12), work,
                                   "cuda:0"],
                                  stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for r in range(2)]
        try:
            logs = [p.communicate(timeout=300)[0] for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
        wall12 = time.perf_counter() - t0
        for r, (p, log) in enumerate(zip(procs, logs)):
            check(p.returncode == 0, f"rank {r} exits 0:\n{log[-3000:]}")
        ranks = [torch.load(os.path.join(work, f"rank{r}.pt"))
                 for r in range(2)]
    # H against its largest entry; g_i against sqrt(H_ii E), the
    # Cauchy-Schwarz bound of |g_i| = |sum J_i w r| (g is a sum of terms
    # of both signs, so its largest entry says little of its rounding)
    g_scale = torch.sqrt(torch.diagonal(H1) * e1).cpu()
    H_scale = float(H1.abs().max())
    d_H = max(float((rk["H"] - H1.cpu()).abs().max()) for rk in ranks) \
        / H_scale
    d_g = max(float(((rk["g"] - g1.cpu()).abs() / g_scale).max())
              for rk in ranks)
    d_nodes = max(float((rk["nodes"] - nodes1.cpu()).abs().max())
                  for rk in ranks)
    print(f"two ranks in {wall12:.3f} s (process start included); "
          f"keyframe {cfg.rows}x{cfg.cols} with "
          f"{int((kf12.depth > 0).sum())} pixels of depth: max |H diff| "
          f"{d_H:.3g} of max |H| {H_scale:.4g}, max |g_i diff| {d_g:.3g} "
          f"of sqrt(H_ii E) (tol {SHARDED_GN_TOL}); Sim(3) graph of "
          f"{graph12.nodes.shape[0]} nodes and {graph12.edges.shape[0]} "
          f"edges: max |node diff| {d_nodes:.3g} (tol {SHARDED_BA_TOL})")
    print(f"K1 launches of each rank: {[rk['k1'] for rk in ranks]}")
    check(d_H <= SHARDED_GN_TOL and d_g <= SHARDED_GN_TOL,
          "the two-rank GN system equals the single-process one")
    check(all(rk["k1"] == {"gn_level_cluster": 0, "gn_step": 1}
              for rk in ranks), "each rank linearizes its rows with one "
          "gn_step launch")
    check(d_nodes <= SHARDED_BA_TOL, "the two-rank Sim(3) refinement "
          "equals refine")

    phase("13 profile: one keyframe interval of phase 10's frames, every "
          "step a graph replay, under utils.profiling.trace and StageTimer")
    K = syn_cfg.keyframe_interval
    syn_frames, _ = synthetic.render_sequence(
        scene, gt_t[:2 * K].to(dev), syn_cfg.rows, syn_cfg.cols, *intr)
    st13 = pipeline.init_pipeline(syn_frames[0], syn_cfg, dev)
    st13, _, _ = pipeline.process_interval(st13, list(syn_frames[1:K]),
                                           syn_cfg)
    timer = profiling.StageTimer()
    with tempfile.TemporaryDirectory() as log_dir:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with profiling.trace(log_dir):
            t_in = time.perf_counter()
            for i in range(K, 2 * K - 1):
                with timer.stage("track_refine_step") as o:
                    st13, out13 = pipeline.track_refine_step(
                        st13, syn_frames[i], syn_cfg)
                    o.append(out13.pose_wrt_world)
            with timer.stage("keyframe_step") as o:
                st13, out13, _ = pipeline.keyframe_step(
                    st13, syn_frames[2 * K - 1], syn_cfg)
                o.append(out13.pose_wrt_world)
            wall13 = time.perf_counter() - t_in
        trace_file = os.path.join(log_dir, "trace.json")
        trace_mb = os.path.getsize(trace_file) / 2**20
        busy_ms, n_dev = profiling.trace_device_time(trace_file)
    post13 = time.perf_counter() - t0 - wall13
    print(timer.report())
    print(f"interval of {K} frames: wall {1e3 * wall13:.1f} ms under the "
          f"profiler ({1e3 * wall13 / K:.1f} ms a frame); device busy "
          f"{busy_ms:.2f} ms, a busy share of {100 * busy_ms / (1e3 * wall13):.2f}"
          f" %; {n_dev} device operations ({n_dev / K:.0f} a frame); trace "
          f"{trace_mb:.1f} MiB written, profiler post-processing "
          f"{post13:.1f} s; on {gpu}")
    check(n_dev > 0 and busy_ms > 0, "the trace holds the card's work")

    phase("14 graphs against eager: phase 4's frames, one video, two "
          "videos and replay steps")
    K = cfg.keyframe_interval

    def leaf_names(tree, prefix="out"):
        """Field paths of the tensors of a tree, in tree_flatten's order."""
        if isinstance(tree, torch.Tensor):
            return [prefix]
        if tree is None:
            return []
        if isinstance(tree, tuple):
            names = getattr(tree, "_fields", range(len(tree)))
            kids = zip(names, tree)
        else:
            kids = ((f.name, getattr(tree, f.name))
                    for f in dataclasses.fields(tree))
        return [n for f, c in kids for n in leaf_names(c, f"{prefix}.{f}")]

    def leaf_diffs(a, b):
        """One row per tensor of two trees of one structure: (max |float
        difference|, the same in units of the last place of the larger
        magnitude, elements that differ and are not floats or differ in
        being NaN, one unit in the last place of the tensor's largest
        finite magnitude), NaN equal to NaN."""
        la, lb = graphs.tree_flatten(a)[0], graphs.tree_flatten(b)[0]
        check(len(la) == len(lb), "trees of one structure")
        rows = []
        for x, y in zip(la, lb):
            check(x.shape == y.shape and x.dtype == y.dtype, "leaf shapes")
            zero = torch.zeros((), device=x.device)
            if not x.numel():
                rows.append(torch.stack([zero, zero, zero, zero]))
            elif x.dtype.is_floating_point:
                x, y = x.float(), y.float()
                d = torch.where(x == y, 0.0, (x - y).abs()).nan_to_num(0.0)
                m = torch.maximum(x.abs(), y.abs()).nan_to_num(0.0)
                ulp = torch.nextafter(m, torch.full_like(m, float("inf"))) - m
                top = torch.where(m.isinf(), 0.0, m).max()
                rows.append(torch.stack([
                    d.max(), (d / ulp).nan_to_num(0.0).max(),
                    (x.isnan() != y.isnan()).sum().float(),
                    torch.nextafter(top, top.new_tensor(float("inf")))
                    - top]))
            else:
                rows.append(torch.stack([zero, zero,
                                         (x != y).sum().float(), zero]))
        return torch.stack(rows).cpu()

    def kernel_counts():
        return (dict(reg_kernel.launches), dict(gn_kernel.launches),
                dict(stereo_kernel.launches), dict(propagate_kernel.launches))

    def reset_counts():
        for mod in (reg_kernel, gn_kernel, stereo_kernel, propagate_kernel):
            mod.reset_launches()

    def graphed_vs_eager(label, start, imgs, c, replay=False, rots=None):
        """The interval ``imgs`` from ``start``, graphed and eager: every
        track_refine step bit-equal, with as many K3, K1, K2 and merge
        launches from the graph's nodes as the eager step's wrapper calls;
        then the keyframe step twice graphed and twice eager, all four
        bit-equal, with one launch of each merge kernel."""
        g = e = start
        for k in range(len(imgs) - 1):
            rot = None if rots is None else rots[k]
            reset_counts()
            g, og = pipeline.track_refine_step(g, imgs[k], c, replay, rot)
            n_g = kernel_counts()
            reset_counts()
            e, oe = pipeline._track_refine_step(e, imgs[k], c, replay, rot)
            n_e = kernel_counts()
            torch.cuda.synchronize()
            check(n_g == n_e and n_e[2] == {"stereo_observe": 1}
                  and sum(n_e[3].values()) == 0,
                  f"{label}: K3, K1, K2 and merge launches of a replay {n_g} "
                  f"equal the eager step's {n_e}, one K2 launch, no merge")
            d = leaf_diffs((g, og), (e, oe))
            check(not d[:, :3].any(), f"{label}: track_refine step {k + 1} "
                  f"graphed equals eager bit for bit (max |diff| "
                  f"{float(d[:, 0].max()):.3g}, {int(d[:, 2].sum())} "
                  f"elements differ)")
        rot = None if rots is None else rots[-1]
        runs, counts = [], []
        for step in (pipeline.keyframe_step, pipeline._keyframe_step) * 2:
            reset_counts()
            runs.append(step(g if step is pipeline.keyframe_step else e,
                             imgs[-1], c, replay, rot))
            counts.append(kernel_counts())
        torch.cuda.synchronize()
        check(all(n == counts[1] for n in counts)
              and counts[1][3] == {"propagate_link": 1,
                                   "propagate_merge": 1},
              f"{label}: the keyframe step's launches, graphed and eager, "
              f"{counts}: equal, one of each merge kernel")
        names = leaf_names(runs[0])
        for i, j, what in ((0, 1, "graph-eager"), (2, 0, "graph-graph"),
                           (3, 1, "eager-eager")):
            d = leaf_diffs(runs[i], runs[j])
            bad = d[:, :3].sum(1).nonzero().flatten().tolist()
            check(not bad, f"{label}: keyframe step {what} bit for bit; "
                  f"differing tensors " + ", ".join(
                      f"{names[li]} ({d[li, 0]:.3g}, {d[li, 1]:.0f} ulp, "
                      f"{d[li, 2]:.0f} el.)" for li in bad))
        print(f"{label}: {len(imgs) - 1} track_refine steps graphed equal "
              f"eager bit for bit; the keyframe step's two replays and two "
              f"eager runs equal bit for bit in all {len(names)} tensors; "
              f"launches of a keyframe step {counts[0]}")

    imgs14 = [torch.as_tensor(f, device=dev) for f in frames[1:K + 1]]
    graphed_vs_eager("one video", pipeline.init_pipeline(frames[0], cfg, dev),
                     imgs14[:K - 1], cfg)
    two = np.stack([frames[:K], frames[BATCH_STRIDE:BATCH_STRIDE + K]])
    graphed_vs_eager("two videos", sharded.batched_init(two[:, 0], cfg, dev),
                     [torch.as_tensor(two[:, k], device=dev)
                      for k in range(1, K)], cfg)
    # replay steps seeded with phase 4's world poses turned by 2e-3 rad
    rots14 = res.world_poses[:K - 1].astype(np.float32)
    rots14[:, 0] += 2e-3
    graphed_vs_eager("replay with init_rotation",
                     pipeline.init_pipeline(frames[0], cfg, dev),
                     imgs14[:K - 1], cfg, replay=True,
                     rots=torch.as_tensor(rots14, device=dev))
    pools14 = {}
    for r in graphs.stats():
        pools14[r["pool"]] = r["pool_bytes"]
        print(f"graph {r['step']} (lead {r['lead']}, replay {r['replay']}, "
              f"rotation {r['init_rotation']}, window "
              f"{pipeline._needs_window(r['cfg'])}, "
              f"{r['cfg'].rows}x{r['cfg'].cols}): nodes {r['nodes']} "
              f"(the eager GN frame before K1: 24,475 launches, "
              f"tools/profile_port_gn.py), K3 nodes {r['k3']} (its "
              f"warm-up launched {r['warmup_k3']}), K1 nodes {r['k1']} "
              f"(warm-up {r['warmup_k1']}), K2 nodes {r['k2']} (warm-up "
              f"{r['warmup_k2']}), merge nodes {r['merge']} (warm-up "
              f"{r['warmup_merge']}); capture "
              f"{r['capture_s']:.3f} s, instantiate "
              f"{r['instantiate_s']:.3f} s; pool "
              f"{r['pool_bytes'] / 2**20:.1f} MiB")
        per_call = int(r["step"] == "keyframe_step")
        check(r["merge"] == {"propagate_link": per_call,
                             "propagate_merge": per_call},
              f"graph {r['step']}: {per_call} node of each merge kernel, "
              f"found by name")
    print(f"{len(graphs.stats())} graphs in {len(pools14)} pools, "
          f"{sum(pools14.values()) / 2**20:.1f} MiB")

    def gn_loop(track, keyframe, n=16):
        """The loop over frames 9..8+n of run_gn, from the state after the
        first interval (made now), ending on a read of its last output."""
        st0 = pipeline.init_pipeline(frames[0], cfg, dev)
        st0, _, _ = pipeline.process_interval(st0, imgs14[:K - 1], cfg)
        imgs = [torch.as_tensor(f, device=dev) for f in frames[K:K + n]]

        def loop():
            st = st0
            for i, img in enumerate(imgs):
                if (K + i) % K == K - 1:
                    st, o, _ = keyframe(st, img, cfg)
                else:
                    st, o = track(st, img, cfg)
            float(o.seeds)
        return loop

    def gn_fps(track, keyframe, n=16):
        """Tracked frames/s of gn_loop, synced at both ends."""
        loop = gn_loop(track, keyframe, n)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loop()
        return n / (time.perf_counter() - t0)

    turns = []
    for graphed in (True, False, False, True):
        steps = ((pipeline.track_refine_step, pipeline.keyframe_step)
                 if graphed else (pipeline._track_refine_step,
                                  pipeline._keyframe_step))
        turns.append((graphed, gn_fps(*steps)))
    print(f"GN frames/s over frames {K + 1}..{3 * K} of run_gn, in turns "
          f"graphed/eager/eager/graphed: "
          f"{' '.join(f'{v:.3f}' for _, v in turns)}; graphed "
          f"{min(v for g, v in turns if g):.3f}-"
          f"{max(v for g, v in turns if g):.3f}, eager "
          f"{min(v for g, v in turns if not g):.3f}-"
          f"{max(v for g, v in turns if not g):.3f}; on {gpu}")
    # device-idle gaps of the graphed loop, no profiler (the steps looked
    # up at each call, so that step_gaps' events wrap them)
    gaps14 = step_gaps(gn_loop(
        lambda *a: pipeline.track_refine_step(*a),
        lambda *a: pipeline.keyframe_step(*a)))
    print_gaps("phase 14's graphed loop (16 frames on the card)", gaps14,
               16, replay_ms(track_graph()), gpu)

    src = os.path.join(PKG, "csrc", "reg_kernel.cu")
    replaces = "egomotion_with_local_loop_closures_tpu/ops/reg_kernel.py:161"
    by_path = {"gn_run_sequence": launches, "lc_bootstrap": launches6,
               "lc_mode": launches7, "recovery": launches8,
               "batched_videos": launches9, "synthetic": launches10}
    k3_rows = [
        {"name": f"reg_kernel.{name}", "route": "cuda", "source": src,
         "replaces": replaces, "launches": launches[name],
         "launches_by_path": {k: v[name] for k, v in by_path.items()},
         "warmup_launches_by_path": {k: v[name]
                                     for k, v in warmups.items()},
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
        for name in ("do_regularization", "regularize")]
    # K1: per launch, at the largest level each kernel runs on the main
    # path for one video (gn_level_cluster: level 2, one launch; gn_step:
    # level 0, the level's graph over its live launches: a launch after
    # the video froze returns at once); every level and V of both kernels
    # under "levels", one align under "align", and the single modes'
    # one-node times under "single_modes"
    def k1_row(name, level):
        t = levels_k1["V1"][f"level{level}"]
        var = t["variants"][name]
        n = sum(var["launches"].values())
        live = 1 if name == "gn_level_cluster" else max(t["iters_used"][0])
        return {
            "name": f"gn_kernel.{name}", "route": "cuda",
            "source": os.path.join(PKG, "csrc", "gn_kernel.cu"),
            "replaces": "egomotion_with_local_loop_closures_tpu/track/"
                        "alignment.py:89",
            "launches": launches_k1["gn_run_sequence"][name],
            "launches_by_path": {k: v[name] for k, v in launches_k1.items()},
            "warmup_launches_by_path": {k: v[name]
                                        for k, v in warmups_k1.items()},
            "max_abs_err": worst_k1[name],
            "max_abs_err_of": "max |pose component diff| of a whole level "
                              "against the plain level",
            "ms": var["ms"] / live, "plain_ms": t["plain_ms"] / live,
            "bound_ms": var["bound_ms"] / live, "bound_by": var["bound_by"],
            "library_ms": None, "of": f"level {level}, one video: a "
                                      f"level of {n} launches, {live} of "
                                      f"them live, / {live}",
            "levels": {f"level{lv}_V{V}": dict(
                ms=levels_k1[f"V{V}"][f"level{lv}"]["variants"][name]["ms"],
                plain_ms=levels_k1[f"V{V}"][f"level{lv}"]["plain_ms"],
                bound_ms=levels_k1[f"V{V}"][f"level{lv}"]["variants"][name][
                    "bound_ms"],
                launches=levels_k1[f"V{V}"][f"level{lv}"]["variants"][name][
                    "launches"])
                for V in (1, K1_VIDEOS) for lv in range(cfg.num_levels)},
            "align": {f"V{V}": dict(
                ms=levels_k1[f"V{V}"]["align"]["variants"]["gn_level"]["ms"],
                plain_ms=levels_k1[f"V{V}"]["align"]["plain_ms"],
                bound_ms=levels_k1[f"V{V}"]["align"]["variants"]["gn_level"][
                    "bound_ms"]) for V in (1, K1_VIDEOS)}}
    k1_rows = [k1_row("gn_level_cluster", 2), k1_row("gn_step", 0)]
    k1_rows[1]["single_modes"] = {
        "linearize_max_abs_err": worst_k1["linearize"],
        "finish_max_abs_err": worst_k1["finish"],
        **{f"{mode}_level{lv}_V{V}": dict(
            ms=t[mode][0], plain_ms=t[mode][1], bound_ms=t[mode][2],
            bound_by=t[mode][3])
            for (lv, V), t in sorted(timed_k1.items())
            for mode in ("linearize", "finish")}}
    # K2: the real frames from the pipeline's state, one video; eight
    # videos under "videos"
    k2_rows = [
        {"name": "stereo_kernel.observe", "route": "cuda",
         "source": os.path.join(PKG, "csrc", "stereo_kernel.cu"),
         "replaces": "egomotion_with_local_loop_closures_tpu/depth/"
                     "stereo.py:674",
         "launches": launches_k2["gn_run_sequence"]["stereo_observe"],
         "launches_by_path": {k: v["stereo_observe"]
                              for k, v in launches_k2.items()},
         "warmup_launches_by_path": {k: v["stereo_observe"]
                                     for k, v in warmups_k2.items()},
         "max_abs_err": worst_k2[1],
         "max_abs_err_of": "max |float plane diff| over every pixel",
         "not_bit_equal_px": worst_k2[0],
         "resources": res_k2,
         "ms": timed_k2[1][0], "plain_ms": timed_k2[1][1],
         "bound_ms": timed_k2[1][2], "bound_by": timed_k2[1][3],
         "library_ms": None,
         "videos": {"V": K2_VIDEOS, "ms": timed_k2[K2_VIDEOS][0],
                    "plain_ms": timed_k2[K2_VIDEOS][1],
                    "bound_ms": timed_k2[K2_VIDEOS][2],
                    "bound_by": timed_k2[K2_VIDEOS][3]}}]
    # the merge: one call's memset and two launches on phase 3d's one
    # state; 8 videos and 20 trials under "batched"
    one_mg = timed_mg["one state"]
    mg_rows = [
        {"name": "propagate_kernel.merge", "route": "cuda",
         "source": os.path.join(PKG, "csrc", "propagate_kernel.cu"),
         "replaces": "egomotion_with_local_loop_closures_tpu/depth/"
                     "propagate.py:101",
         "launches": launches_mg["gn_run_sequence"]["propagate_merge"],
         "launches_by_path": {k: v["propagate_merge"]
                              for k, v in launches_mg.items()},
         "warmup_launches_by_path": {k: v["propagate_merge"]
                                     for k, v in warmups_mg.items()},
         "kernels_a_call": ["propagate_link", "propagate_merge"],
         "max_abs_err": worst_mg,
         "ms": one_mg[0], "plain_ms": one_mg[2], "bound_ms": one_mg[3],
         "bound_by": one_mg[4], "library_ms": None,
         "index_add_ms": one_mg[1],
         "plain_ms_of": "one eager call of the twin, its host read "
                        "included",
         "batched": {label: {"ms": t[0], "index_add_ms": t[1],
                             "plain_ms": t[2], "bound_ms": t[3],
                             "bound_by": t[4]}
                     for label, t in timed_mg.items()
                     if label != "one state"}}]
    print(json.dumps({"kernels": k3_rows + k1_rows + k2_rows + mg_rows}))
    print(gpu)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank-child"]:
        sys.exit(rank_child(sys.argv[2:]))
    sys.exit(main())
