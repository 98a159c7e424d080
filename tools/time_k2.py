"""Device time of K2 (``csrc/stereo_kernel.cu``) beside another build of it.

Times this checkout's K2, the K2 of another checkout (``--root``, e.g. a
parent commit unpacked with ``git archive``) and copies of this
checkout's source with some of its ``#define`` constants set otherwise
(``--variants``: ``ELLC_K2_TILE_H``, the rows of a block's tile,
``ELLC_K2_BOX``, the floats of the current image it holds, or
``ELLC_K2_MIN_BLOCKS``, its register cap), in turns, one card, one
process.
Each is a build of its ``.cu`` file by ``ops.build`` with the port's
flags; every build's entry point takes the same arguments, so this
checkout's ``ops/stereo_kernel.py::_launch`` calls each one.

The inputs are chip_smoke phase 3c's timed case: the keyframe after the
first interval of reference_build/run_gn (frame 8), the pipeline's depth
state and frame 9 at the pose K1 tracks it to, for one video and for
eight in one call (video b: the planes rolled by (b, 2b) pixels, the pose
moved by 2e-4 b).  Before it is timed, each build's result must equal
the plain twin (``depth/stereo.py::plain_observe``) bit for bit in every
plane, its counts exactly.  Each is timed from CUDA-graph replays
(``utils/card_timing.py``) in the order builds, then builds reversed,
beside K2's bound (chip_smoke's ``k2_work``: each input byte read once,
each output byte written once, the float32 operations this data needs),
and its registers, stack and shared memory are printed (cuobjdump).

Usage (on the card): python tools/time_k2.py [--root DIR] [--variants
ELLC_K2_TILE_H=16 ELLC_K2_BOX=4096,ELLC_K2_MIN_BLOCKS=2 ...] [--out F]
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import re
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def chip_smoke():
    """This checkout's chip_smoke.py as a module (its K2 helpers)."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def sources(root, variants):
    """{label: .cu path}: this checkout's source, another checkout's, and
    a copy of this one for each ``NAME=VALUE[,NAME=VALUE...]`` of
    ``variants`` with each ``#define NAME`` set to VALUE (in the ignored
    build directory, beside copies of the headers)."""
    from egomotion_with_local_loop_closures_tpu_torch import ops
    from egomotion_with_local_loop_closures_tpu_torch.ops import (
        stereo_kernel)
    out = {"this": stereo_kernel.SOURCE}
    if root:
        out["other"] = (Path(root).resolve()
                        / "egomotion_with_local_loop_closures_tpu_torch"
                        / "csrc" / "stereo_kernel.cu")
    text = stereo_kernel.SOURCE.read_text()
    for var in variants:
        new = text
        for define in var.split(","):
            name, value = define.split("=")
            new, n = re.subn(rf"#define {name} \S+",
                             f"#define {name} {value}", new)
            if n != 1:
                raise SystemExit(f"time_k2: {stereo_kernel.SOURCE} has {n} "
                                 f"'#define {name}' lines, not one")
        d = ops.BUILD_DIR / ("k2_" + re.sub(r"\W", "_", var))
        d.mkdir(parents=True, exist_ok=True)
        for h in ops.CSRC.glob("*.cuh"):
            shutil.copy(h, d / h.name)
        (d / "stereo_kernel.cu").write_text(new)
        out[var] = d / "stereo_kernel.cu"
    return out


def real_case(cfg, dev):
    """Phase 3c's timed case: observe's arguments on the card."""
    import numpy as np
    import torch
    from egomotion_with_local_loop_closures_tpu_torch.image import pyramid
    from egomotion_with_local_loop_closures_tpu_torch.runtime import pipeline
    from egomotion_with_local_loop_closures_tpu_torch.track import alignment
    frames = np.load(os.path.join(ROOT, "reference_build", "run_gn",
                                  "frames_480x270.npz"))["frames"]
    st = pipeline.init_pipeline(frames[0], cfg, dev)
    st, _, _ = pipeline.process_interval(st, list(frames[1:8]), cfg)
    cur = torch.as_tensor(frames[8], device=dev)
    pose, _ = alignment.align(
        pipeline._kf_levels(st.kf), alignment.make_current_levels(
            pyramid.build_pyramid(cur, cfg.num_levels)), st.prev_wrt_kf, cfg)
    return (st.depth, st.kf.images[0], st.kf.gradx, st.kf.grady,
            st.kf.maxgrad, cur, pose)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=None,
                    help="another checkout whose K2 is timed beside this one")
    ap.add_argument("--variants", nargs="*", default=[],
                    help="NAME=VALUE[,NAME=VALUE...]: a copy of this "
                         "checkout's source with each #define NAME set to "
                         "VALUE")
    ap.add_argument("--reps", type=int, default=200)
    ap.add_argument("--out", default="time_k2.json")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("time_k2: needs a CUDA card", file=sys.stderr)
        return 2
    import ctypes
    from egomotion_with_local_loop_closures_tpu_torch import ops
    from egomotion_with_local_loop_closures_tpu_torch.config import (
        ELLCConfig, PARITY_OVERRIDES)
    from egomotion_with_local_loop_closures_tpu_torch.depth import stereo
    from egomotion_with_local_loop_closures_tpu_torch.depth.state import (
        FIELDS, DepthMapState)
    from egomotion_with_local_loop_closures_tpu_torch.ops import (
        stereo_kernel)
    from egomotion_with_local_loop_closures_tpu_torch.utils import card_timing
    cs = chip_smoke()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.splitlines()[0]
    srcs = sources(args.root, args.variants)
    with ThreadPoolExecutor(len(srcs)) as pool:
        libs = dict(zip(srcs, pool.map(
            lambda kv: ops.build(kv[1], "ellc_stereo_" + re.sub(
                r"\W", "_", kv[0])),
            srcs.items())))
    cuobjdump = os.path.join(os.path.dirname(ops.find_nvcc()), "cuobjdump")
    resources = {}
    for label, path in libs.items():
        resources[label] = cs.kernel_resources(path, cuobjdump).get(
            "stereo_observe")
        print(f"{label}: {srcs[label]}; {resources[label]}", flush=True)
    bound = {label: stereo_kernel.bind(ctypes.CDLL(str(path)))
             for label, path in libs.items()}
    cfg = ELLCConfig().replace(**PARITY_OVERRIDES)
    dev = torch.device("cuda")
    case = real_case(cfg, dev)
    report = {"gpu": gpu, "root": args.root, "sources": {
        k: str(v) for k, v in srcs.items()}, "resources": resources}
    for V in (1, cs.K2_VIDEOS):
        st, *planes = cs.k2_videos(case, V)
        obs = (DepthMapState(**{n: getattr(st, n).contiguous()
                                for n in FIELDS}),
               *(t.contiguous() for t in planes))
        want = stereo.plain_observe(*obs, cfg)
        branches = stereo.observe_branches(*obs, cfg)
        nbytes, ops_ = cs.k2_work(obs, cfg, branches)
        b_ms, by = card_timing.bound_ms(nbytes, ops_)
        fns = {}
        for label, lib in bound.items():
            fn = (lambda lib=lib: stereo_kernel._launch(
                lib, *obs, cfg, torch.cuda.current_stream().cuda_stream))
            got = fn()
            torch.cuda.synchronize()
            per = cs.k2_differ(got, want)
            same = (all(nb == 0 for nb, _ in per)
                    and torch.equal(got.num_created, want.num_created)
                    and torch.equal(got.num_updated, want.num_updated))
            if not same:
                raise SystemExit(f"time_k2: {label} at V={V} is not "
                                 f"bit-equal to the plain twin: {per}")
            fns[label] = fn
        order = list(fns) + list(fns)[::-1]
        turns = {k: [] for k in fns}
        for label in order:
            turns[label].append(card_timing.device_ms(fns[label],
                                                      args.reps)[0])
        rows = {}
        for label, ts in turns.items():
            ms = sum(ts) / len(ts)
            rows[label] = dict(ms=ms, turns=ts, bound_ms=b_ms, bound_by=by,
                               share=b_ms / ms, bytes=nbytes, ops=ops_)
            print(f"K2 {label} V={V}: device time per call {ms:.5f} ms "
                  f"(turns {' '.join(f'{t:.5f}' for t in ts)}); bound "
                  f"{b_ms:.6f} ms by {by} ({nbytes} B, {ops_} float32 "
                  f"ops), {100 * b_ms / ms:.1f} % of it reached; bit-equal "
                  f"to the plain twin; on {gpu}", flush=True)
        report[f"V{V}"] = rows
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
