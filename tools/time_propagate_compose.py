"""Device time of the whole propagate and of the SE(3) compose beside other
builds.

Times this checkout's propagate kernels (``csrc/propagate_kernel.cu``,
one memset and two launches a call) beside the path they replace (ATen
candidates followed by the merge kernel of
``tools/reference_csrc/propagate_merge_lists.cu``,
``tools/reference_kernels.py``), and this checkout's compose
(``csrc/se3_kernel.cu``), in turns, one card, one process.  With
``--root`` another checkout's builds are timed beside them (e.g. a parent
commit unpacked with ``git archive``, or a copy with a kernel changed;
only its ``csrc/`` and ``ops/`` are needed): its ops modules are loaded
from its files and launch its builds, a propagate module that only merges
taking this checkout's ATen ``candidates``.

The inputs are chip_smoke's: the pipeline's state after the first interval
of reference_build/run_gn, propagated into frame 9 at the pose the tracker
finds for it (phase 3d, ``chip_smoke.propagate_case``: one state, 8 videos
with a new keyframe each, 20 trials with one new keyframe, and one state
zoomed out by ``chip_smoke.PROPAGATE_ZOOM`` with the photometric gate
opened: lists longer than a walk of the merge selects) and the
pipeline's pose and keyframe world pose (phase 3e,
``chip_smoke.k4_case``: V = 1, V = 8, B = 20).  Before it is timed, each
propagate build must equal the plain twin (``candidates`` then
``ops/propagate_kernel.py::plain_merge``) bit for bit in every plane, and
each compose build this checkout's.  Each is timed from CUDA-graph
replays (``utils/card_timing.py``) in the order builds, then builds
reversed, beside the bound chip_smoke computes (``propagate_work``; the
compose's bytes and operations, ``SE3_BYTES`` and ``SE3_OPS``).

Then, for each compose build, a one-video track_refine step is captured
as the pipeline captures it (``runtime/graphs.py``), held bit for bit
against the eager step, and the graphs are replayed alone in turns (the
host ahead, ``chip_smoke.replay_ms``): a compose build earns its keep in
the step, where a kernel runs before it.

Usage (on the card): python tools/time_propagate_compose.py [--root DIR]
[--reps N] [--turns N] [--out F]
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
PKG = "egomotion_with_local_loop_closures_tpu_torch"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=None,
                    help="another checkout whose propagate and compose are "
                         "timed beside this one's")
    ap.add_argument("--reps", type=int, default=200)
    ap.add_argument("--graph-reps", type=int, default=50)
    ap.add_argument("--turns", type=int, default=1,
                    help="rounds of the builds in order and then reversed")
    ap.add_argument("--out", default="time_propagate_compose.json")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("time_propagate_compose: needs a CUDA card", file=sys.stderr)
        return 2
    import numpy as np
    from egomotion_with_local_loop_closures_tpu_torch import ops
    from egomotion_with_local_loop_closures_tpu_torch.config import (
        ELLCConfig, PARITY_OVERRIDES)
    from egomotion_with_local_loop_closures_tpu_torch.depth import propagate
    from egomotion_with_local_loop_closures_tpu_torch.depth.state import (
        FIELDS)
    from egomotion_with_local_loop_closures_tpu_torch.image import pyramid
    from egomotion_with_local_loop_closures_tpu_torch.ops import (
        propagate_kernel, se3_kernel)
    from egomotion_with_local_loop_closures_tpu_torch.runtime import (
        graphs, pipeline)
    from egomotion_with_local_loop_closures_tpu_torch.track import alignment
    from egomotion_with_local_loop_closures_tpu_torch.utils import card_timing
    cs_path = os.path.join(ROOT, "chip_smoke.py")
    tk4 = _load(os.path.join(ROOT, "tools", "time_k4.py"), "time_k4")
    cs = tk4.load(cs_path, "chip_smoke")
    rk = cs.load_tool("reference_kernels")
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.splitlines()[0]

    # every build, one nvcc each, started together
    prop = {"this": (propagate_kernel.SOURCE, propagate_kernel)}
    comp = {"this": (se3_kernel.SOURCE, se3_kernel)}
    if args.root:
        base = Path(args.root).resolve() / PKG
        for name, table in (("propagate_kernel", prop),
                            ("se3_kernel", comp)):
            table["other"] = (base / "csrc" / f"{name}.cu", tk4.load(
                base / "ops" / f"{name}.py", f"other_{name}"))
    jobs = [(k, label, path) for k, table in (("propagate", prop),
                                              ("compose", comp))
            for label, (path, _) in table.items()]
    with ThreadPoolExecutor(len(jobs) + 1) as pool:
        merge_lists = pool.submit(rk.build_merge_lists)
        paths = list(pool.map(lambda j: ops.build(
            j[2], "ellc_time_pc_" + re.sub(r"\W", "_", f"{j[0]}_{j[1]}")),
            jobs))
        merge_lib = rk.load_merge_lists(merge_lists.result())
    libs = {"propagate": {}, "compose": {}}
    cuobjdump = os.path.join(os.path.dirname(ops.find_nvcc()), "cuobjdump")
    report = {"gpu": gpu, "root": args.root, "resources": {}}
    for (k, label, src), path in zip(jobs, paths):
        mod = (prop if k == "propagate" else comp)[label][1]
        libs[k][label] = (mod, mod.bind(ctypes.CDLL(str(path))))
        res = cs.kernel_resources(path, cuobjdump)
        report["resources"][f"{k} {label}"] = res
        print(f"{k} {label}: {src}; {res}", flush=True)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = ELLCConfig().replace(**PARITY_OVERRIDES)
    dev = torch.device("cuda")
    frames = np.load(cs.FRAMES)["frames"]
    st = pipeline.init_pipeline(frames[0], cfg, dev)
    st, _, _ = pipeline.process_interval(st, list(frames[1:8]), cfg)
    img9 = torch.as_tensor(frames[8], device=dev)
    mg9 = pyramid.max_abs_gradient(*pyramid.gradients(img9))
    pose9, _ = alignment.align(
        pipeline._kf_levels(st.kf), alignment.make_current_levels(
            pyramid.build_pyramid(img9, cfg.num_levels)),
        st.prev_wrt_kf, cfg)

    def stream():
        return torch.cuda.current_stream().cuda_stream

    def same(a, b):
        return bool(((a == b) | (a.isnan() & b.isnan())).all())

    def in_turns(fns, reps):
        order = (list(fns) + list(fns)[::-1]) * args.turns
        turns = {k: [] for k in fns}
        for key in order:
            turns[key].append(card_timing.device_ms(fns[key], reps)[0])
        return turns

    def propagate_fn(mod, lib, pargs, c):
        if hasattr(mod, "propagate"):
            return lambda: mod._launch(lib, *pargs, c, stream())
        # a checkout whose kernels merge ATen candidates
        shape = tuple(pargs[0].idepth.shape)
        return lambda: mod._launch(
            lib, *rk.candidates(*pargs, c), shape, c, stream())

    report["propagate"] = {}
    for size, spec in (
            ("one state", None),
            ("8 videos", (8, 1, 2, torch.full((6,), 2e-4, device=dev),
                          True)),
            ("20 trials", (20, 7, 23, torch.zeros(6, device=dev), False)),
            ("zoom-out", "zoom")):
        c = cfg
        if spec == "zoom":
            c, spec = cfg.replace(max_diff_constant=1e6), None
            pose = pose9.clone()
            pose[5] += cs.PROPAGATE_ZOOM
        else:
            pose = pose9
        pargs = cs.propagate_case(st, img9, mg9, pose, spec)
        shape = tuple(pargs[0].idepth.shape)
        want = propagate_kernel.plain_merge(
            *propagate.candidates(*pargs, c), shape, c)
        fns = {label: propagate_fn(mod, lib, pargs, c)
               for label, (mod, lib) in libs["propagate"].items()}
        fns["ATen candidates and the merge kernel"] = (
            lambda: rk.aten_propagate(merge_lib, *pargs, c))
        for label, fn in fns.items():
            got = fn()
            torch.cuda.synchronize()
            if not all(same(getattr(got, f), getattr(want, f))
                       for f in FIELDS):
                raise SystemExit(f"time_propagate_compose: propagate "
                                 f"{label} at {size} is not bit-equal to "
                                 f"the twin")
        b_ms, by = card_timing.bound_ms(*cs.propagate_work(pargs, c))
        rows = {}
        for label, ts in in_turns(fns, args.reps).items():
            ms = sum(ts) / len(ts)
            rows[label] = dict(ms=ms, turns=ts, bound_ms=b_ms, bound_by=by,
                               share=b_ms / ms)
            print(f"propagate {label} {size}: device time per call "
                  f"{ms:.5f} ms (turns {' '.join(f'{t:.5f}' for t in ts)}); "
                  f"bound {b_ms:.6f} ms by {by}, {100 * b_ms / ms:.1f} % of "
                  f"it reached; bit-equal to the twin; on {gpu}", flush=True)
        report["propagate"][size] = rows

    report["compose"] = {}
    floor = [cs.floor_ms(args.reps), cs.floor_ms(args.reps)]
    report["floor_ms"] = floor
    for size, spec in cs.K4_SIZES:
        _, _, pose, world = cs.k4_case(st, img9, spec)
        n = pose[..., 0].numel()
        shape = torch.broadcast_shapes(pose.shape, world.shape)
        a, b = pose.expand(shape), world.expand(shape)
        for inv in (False, True):
            want = se3_kernel._launch(libs["compose"]["this"][1], a, b, inv,
                                      stream())
            for label, (mod, lib) in libs["compose"].items():
                got = mod._launch(lib, a, b, inv, stream())
                torch.cuda.synchronize()
                if not same(got, want):
                    raise SystemExit(f"time_propagate_compose: compose "
                                     f"{label} at {size} (relative {inv}) "
                                     f"is not bit-equal to this checkout's")
        fns = {label: (lambda mod=mod, lib=lib:
                       mod._launch(lib, a, b, False, stream()))
               for label, (mod, lib) in libs["compose"].items()}
        b_ms, by = card_timing.bound_ms(cs.SE3_BYTES * n, cs.SE3_OPS * n)
        rows = {}
        for label, ts in in_turns(fns, args.reps).items():
            ms = sum(ts) / len(ts)
            rows[label] = dict(ms=ms, turns=ts, bound_ms=b_ms, bound_by=by)
            print(f"compose {label} {size}: device time per call {ms:.5f} "
                  f"ms (turns {' '.join(f'{t:.5f}' for t in ts)}); bound "
                  f"{b_ms:.3g} ms by {by}; the device_ms floor "
                  f"{floor[0]:.5f} ms; bit-equal to this checkout's; on "
                  f"{gpu}", flush=True)
        report["compose"][size] = rows

    # a one-video track_refine graph with each compose build
    own = se3_kernel._lib
    # each build's captured step, kept whole (its static inputs and
    # outputs with it) when the next build's capture takes its cache slot
    step_graphs, outputs, kept = {}, {}, []
    try:
        for label, (_, lib) in libs["compose"].items():
            se3_kernel._lib = lib
            for key in [k for k, g in graphs._graphs.items()
                        if k[0] is pipeline._track_refine_step
                        and g.lead == () and not k[1][1]]:
                kept.append(graphs._graphs.pop(key))
            g_out = pipeline.track_refine_step(st, img9, cfg, False, None)
            e_out = pipeline._track_refine_step(st, img9, cfg, False, None)
            torch.cuda.synchronize()
            leaves_g, _ = graphs.tree_flatten(g_out)
            leaves_e, _ = graphs.tree_flatten(e_out)
            if not all(same(x, y) for x, y in zip(leaves_g, leaves_e)):
                raise SystemExit(f"time_propagate_compose: the track_refine "
                                 f"graph with compose {label} is not "
                                 f"bit-equal to the eager step")
            outputs[label] = leaves_g
            step_graphs[label] = cs.track_graph()
        first = next(iter(outputs.values()))
        if not all(all(same(x, y) for x, y in zip(first, o))
                   for o in outputs.values()):
            raise SystemExit("time_propagate_compose: the compose builds' "
                             "track_refine steps differ")
    finally:
        se3_kernel._lib = own
    order = (list(step_graphs) + list(step_graphs)[::-1]) * args.turns
    turns = {k: [] for k in step_graphs}
    for key in order:
        turns[key].append(cs.replay_ms(step_graphs[key], args.graph_reps))
    report["track_refine_graph"] = {}
    for label, ts in turns.items():
        ms = sum(ts) / len(ts)
        report["track_refine_graph"][label] = dict(ms=ms, turns=ts)
        print(f"track_refine graph replayed alone with compose {label}: "
              f"{ms:.5f} ms a replay (turns "
              f"{' '.join(f'{t:.5f}' for t in ts)}); bit-equal to the eager "
              f"step and to the other builds' graphs; on {gpu}", flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)
    return 0


def _load(path, name):
    import importlib.util
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


if __name__ == "__main__":
    sys.exit(main())
