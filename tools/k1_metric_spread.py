"""How far float32 runs of a GN level stray from float64 in its outputs.

A video freezes at a pyramid level once its termination metric
wp = sum |delta_i term_w_i| falls below 1.  Near 1 the metric hangs on
the last bits of the sums, and over a level's iterations float32
rounding moves a video's path, so two float32 evaluations of one level
(the plain version on the card or on the CPU, K1's two kernels) can stop
a video one iteration apart and end with metrics and energies apart.
``ops/gn_reference.py``'s METRIC_TOL and ENERGY_TOL, which bound how
far ``level_agreement`` lets a kernel's level part from the plain one,
are set from what this tool measures.

On every case that ``chip_smoke.py`` phase 3b and the CUDA test
``test_cuda_level_two_launches_an_iteration_and_videos_bit_equal`` hold K1
to (the seeded and real 270x480 planes at V = 1 and 8, and TEST_CONFIG's
eight videos), at every level, it runs the plain iterations without the
freeze mask (``gn_reference.plain_trajectory``) in float32 on the card,
in float32 on the CPU and in float64 on the card, and each kernel's level
at every iteration count.  Over the iterations up to the float64 run's
stop (a kernel's while its video is live) it prints each float32 run's
largest distance from float64 in the metric (over the larger of the
float64 metric and 1) and in the energy (relative); each video whose
stop differs between any two runs, with the metrics there; and the
largest of the plain runs' distances over every case, which the two
constants are twice of (a kernel and the plain version, each that near
float64, lie at most twice that apart).

Usage (on the card): python tools/k1_metric_spread.py [--out F]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def spread(kf_levels, cur_levels, pose0, cfg, label, Vs, report):
    """Adds each level and V of one case to ``report``, printing it."""
    import torch
    from egomotion_with_local_loop_closures_tpu_torch.ops import (
        gn_kernel, gn_reference)
    from egomotion_with_local_loop_closures_tpu_torch.track import alignment
    import time_k1_levels as tk
    KL, CL = alignment.KeyframeLevel, alignment.CurrentLevel
    dev = pose0.device
    term_w = alignment._termination_weights(cfg.termination_weights,
                                            torch.float32, dev)
    for level in range(cfg.num_levels):
        n = int(cfg.max_iters[level])
        intr = cfg.level_intrinsics(level)
        for V in Vs:
            if V is None:
                kf, cur, pose = kf_levels[level], cur_levels[level], pose0
            else:
                kf, cur, pose = tk.videos_of([kf_levels[level]],
                                             [cur_levels[level]], pose0, V)
                kf, cur = kf[0], cur[0]
            runs = {
                "plain": gn_reference.plain_trajectory(
                    kf, cur, pose, level, cfg, n, term_w),
                "cpu": gn_reference.plain_trajectory(
                    KL(*(t.cpu() for t in kf)), CL(*(t.cpu() for t in cur)),
                    pose.cpu(), level, cfg, n, term_w.cpu()),
                "float64": gn_reference.plain_trajectory(
                    KL(*(t.double() for t in kf)),
                    CL(*(t.double() for t in cur)), pose.double(), level,
                    cfg, n, term_w.double()),
            }
            metric = {k: r.wp.double().cpu().reshape(n, -1)
                      for k, r in runs.items()}
            energy = {k: r.energy.double().cpu().reshape(n, -1)
                      for k, r in runs.items()}
            stops = {k: r.level().iters.cpu().reshape(-1).tolist()
                     for k, r in runs.items()}
            for kernel in gn_kernel.KERNELS:
                rows = [gn_kernel.run_level(kf, cur, pose, intr, cfg, j,
                                            kernel) for j in range(1, n + 1)]
                metric[kernel] = torch.stack([r.wp_last.double().cpu()
                                              .reshape(-1) for r in rows])
                energy[kernel] = torch.stack([r.energy.double().cpu()
                                              .reshape(-1) for r in rows])
                stops[kernel] = rows[-1].iters.cpu().reshape(-1).tolist()

            def upto(stop):
                # iterations j (0-based) up to a run's stop, per video
                return torch.stack([torch.as_tensor([j < s for s in stop])
                                    for j in range(n)])
            m64, e64 = metric["float64"], energy["float64"]
            row = {}
            for name in metric:
                if name == "float64":
                    continue
                mask = upto(stops["float64"]) & upto(stops[name])
                dm = ((metric[name] - m64).abs()
                      / m64.abs().clamp(min=1.0))[mask]
                de = ((energy[name] - e64).abs() / e64.abs())[mask]
                row[name] = {"metric": float(dm.max()) if dm.numel() else 0.0,
                             "energy": float(de.max()) if de.numel() else 0.0}
            parts = []
            for v in range(m64.shape[1]):
                s = {k: st[v] for k, st in stops.items()}
                if len(set(s.values())) > 1:
                    j = min(s.values()) - 1
                    parts.append({"video": v, "stops": s, "metrics": {
                        k: float(m[j, v]) for k, m in metric.items()}})
            key = f"{label} level {level}" + ("" if V is None else
                                               f" V={V}")
            report["cases"][key] = {"from_float64": row, "parted": parts}
            print(f"{key}: largest distance from float64, metric / energy: "
                  + ", ".join(f"{k} {x['metric']:.4g} / {x['energy']:.4g}"
                              for k, x in row.items())
                  + (f"; stops part: {parts}" if parts else ""),
                  flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="k1_metric_spread.json")
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("k1_metric_spread: needs a CUDA card", file=sys.stderr)
        return 2
    from egomotion_with_local_loop_closures_tpu_torch.config import (
        ELLCConfig, PARITY_OVERRIDES, TEST_CONFIG)
    from egomotion_with_local_loop_closures_tpu_torch.depth import fusion
    from egomotion_with_local_loop_closures_tpu_torch.image import pyramid
    from egomotion_with_local_loop_closures_tpu_torch.track import alignment
    import test_torch_gn_kernel as tests
    import time_k1_levels as tk
    torch.backends.cuda.matmul.allow_tf32 = False
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.splitlines()[0]
    dev = torch.device("cuda")
    report = {"gpu": gpu, "cases": {}}
    # the CUDA test's batch: TEST_CONFIG's three videos repeated to eight
    vids = [tests.make_video(v % 3) for v in range(8)]
    poses = torch.as_tensor(np.stack([tests.start_poses(3)[v % 3]
                                      for v in range(8)]), device=dev)
    test_kf, test_cur = zip(*(tests.levels(vids, lv, dev)
                              for lv in range(TEST_CONFIG.num_levels)))
    spread(test_kf, test_cur, poses, TEST_CONFIG, "TEST_CONFIG x8", [None],
           report)
    # chip_smoke.py phase 3b's cases
    cfg = ELLCConfig().replace(**PARITY_OVERRIDES)
    img0, depth0, var0, img1 = (torch.as_tensor(a, device=dev) for a in
                                tk.gn_planes(5, cfg.shape))
    depths0, vars0 = fusion.build_depth_var_pyramid(depth0, var0,
                                                    cfg.num_levels)
    seeded_kf = tuple(alignment.KeyframeLevel(*lv) for lv in zip(
        pyramid.build_pyramid(img0, cfg.num_levels), depths0, vars0))
    seeded_cur = alignment.make_current_levels(pyramid.build_pyramid(
        img1, cfg.num_levels))
    seeded_pose = torch.tensor([2e-3, -1e-3, 1.5e-3, 4e-3, 7e-3, -3e-3],
                               device=dev)
    spread(seeded_kf, seeded_cur, seeded_pose, cfg, "seeded 270x480", [1, 8],
           report)
    real_kf, real_cur, start = tk.real_case(cfg, dev)
    real_pose, _ = alignment.align(real_kf, real_cur, start, cfg)
    spread(real_kf, real_cur, real_pose, cfg, "real 270x480", [1, 8], report)
    # per pyramid level, the largest distance of the plain runs and of all
    # four float32 runs; the constants are twice the latter
    levels = {}
    for key, c in report["cases"].items():
        lv = int(key.split(" level ")[1].split()[0])
        row = levels.setdefault(lv, {})
        for name, x in c["from_float64"].items():
            for q in ("metric", "energy"):
                for grp in (("plain",) if name in ("plain", "cpu") else ()) \
                        + ("float32",):
                    row[f"{grp}_{q}"] = max(row.get(f"{grp}_{q}", 0.0), x[q])
    report["levels"] = levels
    for lv, row in sorted(levels.items()):
        m, e = row["float32_metric"], row["float32_energy"]
        print(f"level {lv}: largest distance from float64, metric: plain "
              f"runs {row['plain_metric']:.4g}, every float32 run {m:.4g} "
              f"(twice {2 * m:.4g}); energy: plain runs "
              f"{row['plain_energy']:.4g}, every float32 run {e:.4g} "
              f"(twice {2 * e:.4g}); on {gpu}")
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
