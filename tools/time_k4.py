"""Device time of K4's pyramid and depth-pyramid refresh beside other builds.

Times this checkout's pyramid (``csrc/pyramid_kernel.cu``) and refresh
(``csrc/depth_refresh_kernel.cu``), those of another checkout (``--root``,
e.g. a parent commit unpacked with ``git archive``) and copies of this
checkout's sources with some ``#define`` constants set otherwise
(``--pyramid-variants``: ``ELLC_PYR_TILE_H``, ``ELLC_PYR_TILE_W``, a
block's level-0 tile; ``--refresh-variants``: ``ELLC_REF_TILE_H``,
``ELLC_REF_TILE_W``), in turns, one card, one process.  Each is a build
of its ``.cu`` file by ``ops.build`` with the port's flags, launched by
its own checkout's ``ops/pyramid_kernel.py::_levels`` or
``ops/depth_refresh_kernel.py::_launch`` (the other checkout's modules
are loaded from its files, so its entry points may differ from this
one's).

The inputs are chip_smoke phase 3e's: the pipeline's state after the
first interval of reference_build/run_gn and frame 9, for one video
(V = 1), eight (V = 8) and a batch of 20 (B = 20) at 270x480 (copy b
rolled by (dy b, dx b) pixels, ``chip_smoke.k4_case``).  Before it is
timed, each build's result must equal the plain twin
(``image/pyramid.py::plain_build_levels`` with and without the map,
``depth/fusion.py::plain_refresh_depth_pyramid``) bit for bit in every
output.  Each is timed from CUDA-graph replays (``utils/card_timing.py``)
in the order builds, then builds reversed, beside the bound chip_smoke
computes (``pyramid_work``, ``refresh_work``: each input byte read once,
each output byte written once) and beside the floor of that timing (a
one-node graph of ``torch.cuda._sleep(1)``); the pyramid is the
track_refine step's call (gradients, no map).  Each build's registers,
stack and static shared memory are printed (cuobjdump).

Usage (on the card): python tools/time_k4.py [--root DIR]
[--pyramid-variants ELLC_PYR_TILE_H=16,ELLC_PYR_TILE_W=16 ...]
[--refresh-variants ELLC_REF_TILE_H=16,ELLC_REF_TILE_W=16 ...] [--out F]
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
PKG = "egomotion_with_local_loop_closures_tpu_torch"


def load(path, name):
    """The Python file ``path`` as a module named ``name``."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def builds(module, stem, root, variants):
    """{label: (.cu path, its wrapper module)}: this checkout's source,
    another checkout's (with its own ops module), and a copy of this one
    for each ``NAME=VALUE[,NAME=VALUE...]`` of ``variants`` with each
    ``#define NAME`` set to VALUE (in the ignored build directory, beside
    copies of the headers)."""
    from egomotion_with_local_loop_closures_tpu_torch import ops
    src = module.SOURCE
    out = {"this": (src, module)}
    if root:
        base = Path(root).resolve() / PKG
        out["other"] = (base / "csrc" / src.name,
                        load(base / "ops" / f"{src.stem}.py",
                             f"other_{src.stem}"))
    text = src.read_text()
    for var in variants:
        new = text
        for define in var.split(","):
            name, value = define.split("=")
            new, n = re.subn(rf"#define {name} \S+",
                             f"#define {name} {value}", new)
            if n != 1:
                raise SystemExit(f"time_k4: {src} has {n} '#define {name}' "
                                 f"lines, not one")
        d = ops.BUILD_DIR / (f"{stem}_" + re.sub(r"\W", "_", var))
        d.mkdir(parents=True, exist_ok=True)
        for h in ops.CSRC.glob("*.cuh"):
            shutil.copy(h, d / h.name)
        (d / src.name).write_text(new)
        out[var] = (d / src.name, module)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=None,
                    help="another checkout whose pyramid and refresh are "
                         "timed beside this one's")
    ap.add_argument("--pyramid-variants", nargs="*", default=[],
                    help="NAME=VALUE[,NAME=VALUE...]: a copy of this "
                         "checkout's pyramid source with each #define NAME "
                         "set to VALUE")
    ap.add_argument("--refresh-variants", nargs="*", default=[],
                    help="the same for the refresh's source")
    ap.add_argument("--reps", type=int, default=200)
    ap.add_argument("--out", default="time_k4.json")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("time_k4: needs a CUDA card", file=sys.stderr)
        return 2
    import ctypes
    import numpy as np
    from egomotion_with_local_loop_closures_tpu_torch import ops
    from egomotion_with_local_loop_closures_tpu_torch.config import (
        ELLCConfig, PARITY_OVERRIDES)
    from egomotion_with_local_loop_closures_tpu_torch.depth import fusion
    from egomotion_with_local_loop_closures_tpu_torch.image import pyramid
    from egomotion_with_local_loop_closures_tpu_torch.ops import (
        depth_refresh_kernel, pyramid_kernel)
    from egomotion_with_local_loop_closures_tpu_torch.runtime import pipeline
    from egomotion_with_local_loop_closures_tpu_torch.utils import card_timing
    cs = load(os.path.join(ROOT, "chip_smoke.py"), "chip_smoke")
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.splitlines()[0]
    kernels = {
        "pyramid": builds(pyramid_kernel, "k4_pyramid", args.root,
                          args.pyramid_variants),
        "refresh": builds(depth_refresh_kernel, "k4_refresh", args.root,
                          args.refresh_variants)}
    jobs = [(k, label, path) for k, b in kernels.items()
            for label, (path, _) in b.items()]
    with ThreadPoolExecutor(len(jobs)) as pool:
        paths = list(pool.map(lambda j: ops.build(j[2], "ellc_time_k4_" + (
            re.sub(r"\W", "_", f"{j[0]}_{j[1]}"))), jobs))
    cuobjdump = os.path.join(os.path.dirname(ops.find_nvcc()), "cuobjdump")
    libs = {k: {} for k in kernels}
    report = {"gpu": gpu, "root": args.root, "resources": {}}
    for (k, label, src), path in zip(jobs, paths):
        mod = kernels[k][label][1]
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
    img = torch.as_tensor(frames[8], device=dev)
    L = cfg.num_levels
    floor = [cs.floor_ms(args.reps), cs.floor_ms(args.reps)]
    report["floor_ms"] = floor
    print(f"device_ms floor (a one-node graph of torch.cuda._sleep(1)): "
          f"{floor[0]:.5f} / {floor[1]:.5f} ms a replay; on {gpu}",
          flush=True)

    def differ(a, b):
        return int((~((a == b) | (a.isnan() & b.isnan()))).sum())

    def stream():
        return torch.cuda.current_stream().cuda_stream

    for size, spec in cs.K4_SIZES:
        image, depth, _, _ = cs.k4_case(st, img, spec)
        image = image.contiguous()
        planes = tuple(t.contiguous() for t in (
            depth.valid, depth.idepth_smoothed, depth.var_smoothed))
        fns = {}
        # the pyramid: bit-equal to the twin with and without the map,
        # timed without it
        want = {mg: pyramid.plain_build_levels(image, L, mg)
                for mg in (False, True)}
        for label, (mod, lib) in libs["pyramid"].items():
            for mg in (False, True):
                imgs, gx, gy, m, _ = mod._levels(lib, image, L, True, mg,
                                                 stream())
                got = pyramid.Levels(tuple(imgs), tuple(gx), tuple(gy), m)
                torch.cuda.synchronize()
                bad = [f for f in pyramid.Levels._fields
                       if getattr(want[mg], f) is not None and any(
                           differ(a, b) for a, b in zip(*(
                               x if isinstance(x, tuple) else (x,) for x in
                               (getattr(got, f), getattr(want[mg], f)))))]
                if bad:
                    raise SystemExit(f"time_k4: pyramid {label} at {size} "
                                     f"(map {mg}) is not bit-equal to the "
                                     f"twin in {bad}")
            fns[("pyramid", label)] = (
                lambda mod=mod, lib=lib: mod._levels(lib, image, L, True,
                                                     False, stream()))
        work = {"pyramid": cs.pyramid_work(want[False].images)}
        # the refresh
        wst, wd, wv = fusion.plain_refresh_depth_pyramid(depth, cfg)
        for label, (mod, lib) in libs["refresh"].items():
            valid, d, v = mod._launch(lib, *planes, cfg.border, L, stream())
            torch.cuda.synchronize()
            if not (torch.equal(valid, wst.valid) and all(
                    differ(a, b) == 0 for a, b in zip(d + v, wd + wv))):
                raise SystemExit(f"time_k4: refresh {label} at {size} is "
                                 f"not bit-equal to the twin")
            fns[("refresh", label)] = (
                lambda mod=mod, lib=lib: mod._launch(
                    lib, *planes, cfg.border, L, stream()))
        work["refresh"] = cs.refresh_work(wd)
        order = list(fns) + list(fns)[::-1]
        turns = {k: [] for k in fns}
        for key in order:
            turns[key].append(card_timing.device_ms(fns[key], args.reps)[0])
        rows = {}
        for (k, label), ts in turns.items():
            ms = sum(ts) / len(ts)
            nbytes, n_ops = work[k]
            b_ms, by = card_timing.bound_ms(nbytes, n_ops)
            rows[f"{k} {label}"] = dict(ms=ms, turns=ts, bound_ms=b_ms,
                                        bound_by=by, share=b_ms / ms,
                                        bytes=nbytes, ops=n_ops)
            print(f"{k} {label} {size}: device time per call {ms:.5f} ms "
                  f"(turns {' '.join(f'{t:.5f}' for t in ts)}); bound "
                  f"{b_ms:.6f} ms by {by} ({nbytes} B, {n_ops} float32 "
                  f"ops), {100 * b_ms / ms:.1f} % of it reached; the floor "
                  f"{floor[0]:.5f} ms; bit-equal to the twin; on {gpu}",
                  flush=True)
        report[size] = rows
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
