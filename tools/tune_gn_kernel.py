#!/usr/bin/env python3
"""Time K1 (csrc/gn_kernel.cu) built with other shapes, on one CUDA card.

Run from the root of a checkout:

    python3 tools/tune_gn_kernel.py [--variants V1;V2;...] [--out F]

A variant is a comma-separated list of ``NAME=VALUE``: a constant of the
source (``kStepMinBlocks``, the gn_step blocks an SM must hold, which
bounds its registers) rewritten in a copy, or a macro for nvcc
(``ELLC_CLUSTER_THREADS``, the cluster kernel's block;
``ELLC_CLUSTER_BLOCKS``, its cluster); the empty variant is the committed
build.
Each variant is built with the kernel's flags (one nvcc each, started
together) and ``-Xptxas -v``, whose registers, stack, spills and shared
memory are printed.  On chip_smoke.py phase 3b's real case
(``tools/time_k1_levels.py::real_case``), each variant's whole level of
each kernel, at every level, for one video and for eight, is held to the
plain level (``ops/gn_reference.py::level_agreement``) and then timed as
one CUDA graph (as chip_smoke.py times K1), in turns: the variants, then
the same in reverse order; it is also said whether each variant's level equals the first
variant's bit for bit.  The finish alone (gn_step's finish-only mode, on
the plain level-0 system of these videos, one partial a video) is timed
the same way, as a one-node graph.  Writes the times as JSON to F (default
tune_gn_kernel.json).
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import os
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tools"))


def build(variant: str):
    """(library path, ptxas's lines) of csrc/gn_kernel.cu built as the
    variant says: ``NAME=VALUE`` rewrites ``constexpr int NAME`` in a copy
    of the source where there is one, else defines the macro NAME."""
    from egomotion_with_local_loop_closures_tpu_torch import ops
    from egomotion_with_local_loop_closures_tpu_torch.ops import gn_kernel
    text, defines = gn_kernel.SOURCE.read_text(), []
    for item in filter(None, variant.split(",")):
        name, value = item.split("=")
        pattern = rf"constexpr int {name} = \d+;"
        if re.search(pattern, text):
            text = re.sub(pattern, f"constexpr int {name} = {value};", text)
        else:
            defines.append(f"-D{item}")
    flags = [*ops.NVCC_FLAGS, "-Xptxas", "-v", "-I", str(ops.CSRC), *defines]
    headers = b"".join(h.read_bytes() for h in sorted(ops.CSRC.glob("*.cuh")))
    digest = hashlib.sha256(text.encode() + headers
                            + " ".join(flags).encode()).hexdigest()[:16]
    ops.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu = ops.BUILD_DIR / f"gn_kernel_tune_{digest}.cu"
    cu.write_text(text)
    lib = cu.with_name(f"libellc_gn_tune_{digest}.so")
    proc = subprocess.run([ops.find_nvcc(), *flags, "-o", str(lib), str(cu)],
                          capture_output=True, text=True, check=True)
    lines, name = [], None
    for line in proc.stderr.splitlines():
        m = re.search(r"entry function '\S*?\d+(gn_level_cluster|gn_step)E",
                      line)
        if m:
            name = m.group(1)
        elif name and ("registers" in line or "stack frame" in line):
            lines.append(f"{name}: {line.strip()}")
    return str(lib), lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variants", default=";ELLC_CLUSTER_THREADS=256;"
                    "ELLC_CLUSTER_THREADS=1024;ELLC_CLUSTER_BLOCKS=4",
                    help="semicolon-separated variants")
    ap.add_argument("--out", default="tune_gn_kernel.json")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("tune_gn_kernel: needs a CUDA card", file=sys.stderr)
        return 2
    from egomotion_with_local_loop_closures_tpu_torch.config import (
        ELLCConfig, PARITY_OVERRIDES)
    from egomotion_with_local_loop_closures_tpu_torch.ops import (
        gn_kernel, gn_reference)
    from egomotion_with_local_loop_closures_tpu_torch.track import alignment
    from egomotion_with_local_loop_closures_tpu_torch.utils.card_timing \
        import device_ms
    import time_k1_levels as tk
    torch.backends.cuda.matmul.allow_tf32 = False
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.splitlines()[0]
    variants = args.variants.split(";")
    with ThreadPoolExecutor(len(variants)) as pool:
        built = list(pool.map(build, variants))
    libs = {}
    for variant, (path, lines) in zip(variants, built):
        libs[variant] = gn_kernel.bind(ctypes.CDLL(path))
        for line in lines:
            print(f"[{variant or 'committed'}] {line}")
    cfg = ELLCConfig().replace(**PARITY_OVERRIDES)
    dev = torch.device("cuda")
    term_w = alignment._termination_weights(cfg.termination_weights,
                                            torch.float32, dev)
    kf_levels, cur_levels, pose0 = tk.real_case(cfg, dev)
    report = {"gpu": gpu, "times": {}}
    for V in (1, 8):
        kfs, curs, pose = tk.videos_of(kf_levels, cur_levels, pose0, V)
        starts, p = {}, pose
        for lv in range(cfg.num_levels - 1, -1, -1):
            starts[lv] = p
            p = alignment.gn_level(kfs[lv], curs[lv], p, lv, cfg,
                                   int(cfg.max_iters[lv]))[0]
        ws = {vr: gn_kernel.make_workspace(V, dev) for vr in variants}
        for lv in range(cfg.num_levels):
            n = int(cfg.max_iters[lv])
            intr = cfg.level_intrinsics(lv)
            traj = gn_reference.plain_trajectory(
                kfs[lv], curs[lv], starts[lv], lv, cfg, n, term_w)
            traj64 = gn_reference.plain_trajectory(
                alignment.KeyframeLevel(*(t.double() for t in kfs[lv])),
                alignment.CurrentLevel(*(t.double() for t in curs[lv])),
                starts[lv].double(), lv, cfg, n, term_w.double())
            for kernel in gn_kernel.KERNELS:
                fns = {vr: (lambda vr=vr: gn_kernel.level_launches(
                    libs[vr], ws[vr], kfs[lv], curs[lv], starts[lv], intr,
                    cfg, n, kernel, gn_kernel._stream())) for vr in variants}
                first = None
                for vr, fn in fns.items():
                    st = fn()
                    ok, apart = gn_reference.level_agreement(
                        st, traj, traj64, lv, 1e-5)
                    if not ok:
                        raise RuntimeError(f"variant {vr!r} {kernel} level "
                                           f"{lv} V={V} disagrees with the "
                                           f"plain level: {apart}")
                    first = first or st
                    same = all(torch.equal(a.nan_to_num(7.0),
                                           b.nan_to_num(7.0))
                               for a, b in zip(first, st))
                    print(f"[{vr or 'committed'}] {kernel} level {lv} V={V}:"
                          f" bit-equal to the first variant's level: {same}")
                turns = {vr: [] for vr in variants}
                for vr in variants + variants[::-1]:
                    turns[vr].append(device_ms(fns[vr], 200)[0])
                for vr, ts in turns.items():
                    ms = sum(ts) / len(ts)
                    report["times"][f"{vr}|{kernel}|level{lv}|V{V}"] = ms
                    print(f"[{vr or 'committed'}] {kernel} level {lv} V={V}: "
                          f"{ms:.5f} ms a level of {n} iterations (turns "
                          f"{' '.join(f'{t:.5f}' for t in ts)}); on {gpu}",
                          flush=True)
        # the finish alone on the plain level-0 system, one partial a video
        parts = gn_kernel.pack(*alignment._gn_quantities(
            kfs[0], curs[0], pose, cfg.level_intrinsics(0), cfg))[
                ..., None, :].contiguous()
        st = gn_kernel.empty_state(pose)
        fns = {vr: (lambda vr=vr: gn_kernel._launch_step(
            libs[vr], gn_kernel._FINISH, True, pose, st, parts, cfg,
            gn_kernel._stream())) for vr in variants}
        turns = {vr: [] for vr in variants}
        for vr in variants + variants[::-1]:
            turns[vr].append(device_ms(fns[vr], 200)[0])
        for vr, ts in turns.items():
            ms = sum(ts) / len(ts)
            report["times"][f"{vr}|finish|V{V}"] = ms
            print(f"[{vr or 'committed'}] finish alone V={V}: {ms:.5f} ms a "
                  f"one-node graph (turns {' '.join(f'{t:.5f}' for t in ts)})"
                  f"; on {gpu}", flush=True)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
