"""Where a K2 launch spends its time: each block's passes, on the card.

Builds a copy of ``csrc/stereo_kernel.cu`` with a time stamp (the card's
``%globaltimer``, ns) taken by each block's thread 0 at the kernel's
start and after each of its phases: the pose blocks, pass A (a barrier
is added there, so that the stamp marks the block's last pixel), the
compaction with the box of the current image, pass B (the walks) and
pass C (the EKF rules and writes).  It runs the copy on chip_smoke phase
3c's timed case (``tools/time_k2.py``'s inputs) at V = 1 and 8 and prints,
for each phase, the mean, median, 90th percentile and largest time a
block took; the blocks' walkers; the kernel's span; and how late the
last block started (the waves of blocks).  The stamps cost a few stores
a block; the copy's times are for reading the split, not for the
kernel's time (``tools/time_k2.py`` gives that).

Usage (on the card): python tools/k2_pass_times.py [--out F]
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tools"))

MAX_BLOCKS = 1 << 14
# (anchor line in the source, code inserted before it)
STAMPS = [
    ("  if (tid == 0) {\n    float R[3][3], t[3];",
     "  const int stamp_b = blockIdx.x + gridDim.x * blockIdx.y;\n"
     "  if (tid == 0) ellc_stamp(0, stamp_b);\n"),
    ("  // pass A: a thread a pixel",
     "  if (tid == 0) ellc_stamp(1, stamp_b);\n"),
    ("  // the box a walk samples:",
     "  __syncthreads();\n  if (tid == 0) ellc_stamp(2, stamp_b);\n"),
    ("  // pass B: thread t walks",
     "  if (tid == 0) {\n    ellc_stamp(3, stamp_b);\n"
     "    ellc_walkers[stamp_b] = walkers;\n  }\n"),
    ("  // pass C: a thread a pixel",
     "  if (tid == 0) ellc_stamp(4, stamp_b);\n"),
    ("  if (tid == 0) {\n    if (s_count[0] != 0)",
     "  if (tid == 0) ellc_stamp(5, stamp_b);\n"),
]
PHASES = ["pose blocks", "pass A", "compaction and box", "pass B (walks)",
          "pass C"]


def stamped_source(text: str) -> str:
    """K2's source with the stamps and an entry point that reads them."""
    head = (f"__device__ unsigned long long ellc_stamps[6][{MAX_BLOCKS}];\n"
            f"__device__ int ellc_walkers[{MAX_BLOCKS}];\n"
            "__device__ __forceinline__ void ellc_stamp(int i, int b) {\n"
            "  unsigned long long t;\n"
            "  asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t));\n"
            "  ellc_stamps[i][b] = t;\n}\n")
    anchor = "namespace {\n"
    if text.count(anchor) < 1:
        raise SystemExit("k2_pass_times: no anonymous namespace in K2")
    text = text.replace(anchor, head + anchor, 1)
    for line, code in STAMPS:
        n = text.count(line)
        if n != 1:
            raise SystemExit(f"k2_pass_times: K2's source has {n} lines "
                             f"{line.strip()!r}, not one")
        text = text.replace(line, code + line)
    return text + (
        "\nextern \"C\" int ellc_read_stamps(unsigned long long* t,\n"
        "                                int* w) {\n"
        "  cudaMemcpyFromSymbol(t, ellc_stamps, sizeof(ellc_stamps));\n"
        "  return (int)cudaMemcpyFromSymbol(w, ellc_walkers,\n"
        "                                   sizeof(ellc_walkers));\n}\n")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="k2_pass_times.json")
    args = ap.parse_args(argv)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("k2_pass_times: needs a CUDA card", file=sys.stderr)
        return 2
    import time_k2
    from egomotion_with_local_loop_closures_tpu_torch import ops
    from egomotion_with_local_loop_closures_tpu_torch.config import (
        ELLCConfig, PARITY_OVERRIDES)
    from egomotion_with_local_loop_closures_tpu_torch.depth.state import (
        FIELDS, DepthMapState)
    from egomotion_with_local_loop_closures_tpu_torch.ops import (
        stereo_kernel)
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.splitlines()[0]
    d = ops.BUILD_DIR / "k2_stamps"
    d.mkdir(parents=True, exist_ok=True)
    for h in ops.CSRC.glob("*.cuh"):
        shutil.copy(h, d / h.name)
    (d / "stereo_kernel.cu").write_text(
        stamped_source(stereo_kernel.SOURCE.read_text()))
    lib = stereo_kernel.bind(ctypes.CDLL(str(
        ops.build(d / "stereo_kernel.cu", "ellc_stereo_stamps"))))
    cs = time_k2.chip_smoke()
    cfg = ELLCConfig().replace(**PARITY_OVERRIDES)
    case = time_k2.real_case(cfg, torch.device("cuda"))
    report = {"gpu": gpu}
    for V in (1, cs.K2_VIDEOS):
        st, *planes = cs.k2_videos(case, V)
        obs = (DepthMapState(**{n: getattr(st, n).contiguous()
                                for n in FIELDS}),
               *(t.contiguous() for t in planes))
        for _ in range(3):          # the last launch's stamps are read
            stereo_kernel._launch(lib, *obs, cfg,
                                  torch.cuda.current_stream().cuda_stream)
        torch.cuda.synchronize()
        stamps = np.zeros((6, MAX_BLOCKS), np.uint64)
        walkers = np.zeros(MAX_BLOCKS, np.int32)
        lib.ellc_read_stamps(ctypes.c_void_p(stamps.ctypes.data),
                             ctypes.c_void_p(walkers.ctypes.data))
        n = int((stamps[0] > 0).sum())
        t = stamps[:, :n].astype(np.int64)
        w = walkers[:n]
        t0 = int(t[0].min())
        row = {"blocks": n, "span_us": (int(t[5].max()) - t0) / 1e3,
               "last_start_us": (int(t[0].max()) - t0) / 1e3,
               "walkers": {"mean": float(w.mean()), "max": int(w.max())},
               "phases": {}}
        print(f"K2 V={V}: {n} blocks, kernel span {row['span_us']:.2f} us, "
              f"the last block started at {row['last_start_us']:.2f} us; "
              f"walkers a block mean {w.mean():.1f}, largest {w.max()}; on "
              f"{gpu}")
        for i, name in enumerate(PHASES):
            us = (t[i + 1] - t[i]) / 1e3
            row["phases"][name] = {
                "mean": float(us.mean()), "median": float(np.median(us)),
                "p90": float(np.percentile(us, 90)), "max": float(us.max())}
            print(f"  {name}: mean {us.mean():.2f}, median "
                  f"{np.median(us):.2f}, p90 {np.percentile(us, 90):.2f}, "
                  f"largest {us.max():.2f} us")
        total = (t[5] - t[0]) / 1e3
        walks = (t[4] - t[3]) / 1e3
        row["block_us"] = {"mean": float(total.mean()),
                           "max": float(total.max())}
        row["walks_vs_walkers_corr"] = float(np.corrcoef(walks, w)[0, 1])
        print(f"  a block: mean {total.mean():.2f}, largest {total.max():.2f}"
              f" us; correlation of pass B's time with the block's walkers "
              f"{row['walks_vs_walkers_corr']:.2f}")
        report[f"V{V}"] = row
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
