#!/usr/bin/env python3
"""Time K3 (csrc/reg_kernel.cu) built with other tile heights, on one CUDA card.

Run from the root of a checkout:

    python3 tools/tune_reg_kernel.py [--tiles 8,16] [--sass DIR]

Each tile height T is a copy of the committed source with its
``kTileY`` set to T (32xT output tiles, blocks of 32xT threads), built
with the kernel's flags.  On the pipeline's state after 8 frames of
reference_build/run_gn at 480x270 (as chip_smoke.py phase 3 builds it),
every variant must equal the plain version bit for bit; then each is timed
as chip_smoke.py times K3 (CUDA-graph replays behind a spin), in turns
(the variants, then the same in reverse order), for do_regularization
and for regularize with remove_occlusions, beside an empty kernel on the
same grid (the launch floor).  Prints each variant's registers and shared
memory (cuobjdump -res-usage); with ``--sass DIR`` writes each variant's
SASS there.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EMPTY_CU = r"""
#include <cuda_runtime.h>
__global__ void empty_kernel() {}
extern "C" int ellc_empty(int gx, int gy, int bx, int by, void* stream) {
  empty_kernel<<<dim3(gx, gy), dim3(bx, by), 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
"""


def build(reg_kernel, src: str, suffix: str) -> str:
    """nvcc ``src`` with the kernel's flags; returns the library's path."""
    flags = reg_kernel.NVCC_FLAGS
    digest = hashlib.sha256((src + " ".join(flags)).encode()).hexdigest()[:16]
    lib = reg_kernel.BUILD_DIR / f"libellc_{suffix}_{digest}.so"
    if not lib.exists():
        reg_kernel.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        cu = lib.with_suffix(".cu")
        cu.write_text(src)
        subprocess.run([reg_kernel._find_nvcc(), *flags, "-o", str(lib),
                        str(cu)], check=True, capture_output=True)
    return str(lib)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tiles", default="8,16,4",
                    help="comma-separated tile heights")
    ap.add_argument("--sass", help="directory for each variant's SASS")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("tune_reg_kernel: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import numpy as np

    import chip_smoke
    from egomotion_with_local_loop_closures_tpu_torch.config import (
        ELLCConfig, PARITY_OVERRIDES)
    from egomotion_with_local_loop_closures_tpu_torch.depth import propagate
    from egomotion_with_local_loop_closures_tpu_torch.depth.state import (
        FIELDS)
    from egomotion_with_local_loop_closures_tpu_torch.ops import reg_kernel
    from egomotion_with_local_loop_closures_tpu_torch.runtime import pipeline
    from egomotion_with_local_loop_closures_tpu_torch.utils import card_timing

    dev = torch.device("cuda")
    gpu = chip_smoke.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"]).splitlines()[0]
    cfg = ELLCConfig().replace(**PARITY_OVERRIDES)
    frames = np.load(chip_smoke.FRAMES)["frames"]
    st = pipeline.init_pipeline(frames[0], cfg, dev)
    st, _, _ = pipeline.process_interval(st, list(frames[1:8]), cfg)
    state, maxg = st.depth, st.kf.maxgrad
    H, W = state.valid.shape
    stream = torch.cuda.current_stream().cuda_stream
    cuobjdump = os.path.join(os.path.dirname(reg_kernel._find_nvcc()),
                             "cuobjdump")

    src = reg_kernel.SOURCE.read_text()
    calls = {}
    for v in args.tiles.split(","):
        tile_y = int(v)
        variant, n = re.subn(r"constexpr int kTileY = \d+;",
                             f"constexpr int kTileY = {tile_y};", src)
        chip_smoke.check(n == 1, "reg_kernel.cu declares kTileY once")
        lib_path = build(reg_kernel, variant, "reg_tune")
        lib = reg_kernel.bind(ctypes.CDLL(lib_path))
        for line in chip_smoke.run([cuobjdump, "-res-usage", lib_path]
                                   ).splitlines():
            if "REG:" in line:
                print(f"{v}: {line.strip()}")
        if args.sass:
            os.makedirs(args.sass, exist_ok=True)
            with open(os.path.join(args.sass, f"reg_kernel_{v}.sass"),
                      "w") as fh:
                fh.write(chip_smoke.run([cuobjdump, "-sass", lib_path]))
        for occl in (False, True):
            for fill in (maxg, None):
                got = reg_kernel._launch(lib, state, fill, cfg, occl, stream)
                ref = (propagate.do_regularization(state, maxg, cfg, occl)
                       if fill is not None
                       else propagate.regularize(state, cfg, occl))
                chip_smoke.compare(ref, got, FIELDS)
        calls[v] = (tile_y, lib)
    print("every variant equal to the plain version bit for bit")

    empty = ctypes.CDLL(build(reg_kernel, EMPTY_CU, "empty"))
    empty.ellc_empty.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p]
    for name, fill, occl in (("do_regularization", maxg, False),
                             ("regularize", None, True)):
        fns = {v: (lambda lib=lib: reg_kernel._launch(
                   lib, state, fill, cfg, occl,
                   torch.cuda.current_stream().cuda_stream))
               for v, (_, lib) in calls.items()}
        for v, (tile_y, _) in calls.items():
            grid = ((W + 31) // 32, (H + tile_y - 1) // tile_y)
            fns[f"empty {v}"] = (lambda g=grid, b=(32, tile_y):
                                 empty.ellc_empty(
                                     *g, *b, ctypes.c_void_p(
                                         torch.cuda.current_stream()
                                         .cuda_stream)))
        order = list(fns) + list(reversed(list(fns)))
        for fn in fns.values():
            fn()                                       # warm-up
        times = {k: [] for k in fns}
        for k in order:
            times[k].append(card_timing.device_ms(fns[k], 200)[0])
        for k, ts in times.items():
            print(f"{name} at {H}x{W}, tile height {k}: "
                  f"{sum(ts) / len(ts):.5f} ms per "
                  f"call (turns {ts[0]:.5f} {ts[1]:.5f}) on {gpu}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
