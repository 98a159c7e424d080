"""Device time of K1 (the tracker's GN iterations) as the step graphs run it.

K1's one-node times (chip_smoke phase 3b) include a graph launch each,
while a frame step's graph runs K1 as a run of launches inside one graph.
This tool times what the main path runs:

- each pyramid level's GN iterations (``alignment.gn_level`` at that
  level's ``max_iters``) captured as one CUDA graph;
- one whole ``alignment.align`` (32 iterations over the four levels) as
  one graph;

for one video and for eight in one call (video b: the planes rolled by
(b, 2b) pixels, the pose moved by 2e-4 b), in turns with the plain
PyTorch iterations of the same level or align (``_gn_quantities`` and
``_gn_update``, the CPU branch of ``gn_level``), each beside its bound:
each input byte read once a launch that reads the planes (a video whose
level froze early needs fewer of them), and ``gn_kernel.OPS_PER_PIXEL``
float32 operations a template pixel a live iteration.  It also prints the
serial finish's latency a level: the iterations used times one finish-only
launch's time from a graph of it.

The inputs are chip_smoke's phase 3b real case: the keyframe after the
first interval of reference_build/run_gn (frame 8) and frame 9, from the
pose the pipeline starts align at.

Usage (on the card): python tools/time_k1_levels.py [--root DIR] [--out F]
``--root`` imports the port from another checkout (a parent commit
unpacked with ``git archive``), so that two versions of K1 are timed in
one call on one card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _own(path):
    """A module of this checkout's port, loaded by its path under the
    port: with ``--root`` the port on ``sys.path`` is another checkout's,
    whose K1 is timed, while the timing (``utils/card_timing.py``), the
    plain twin (``ops/gn_reference.py``) and K1's operation count
    (``ops/gn_kernel.py``) stay this checkout's."""
    import importlib.util
    name = "ellc_own_" + path.replace("/", "_").removesuffix(".py")
    if name not in sys.modules:
        spec = importlib.util.spec_from_file_location(name, os.path.join(
            ROOT, "egomotion_with_local_loop_closures_tpu_torch", path))
        mod = importlib.util.module_from_spec(spec)
        sys.modules[name] = mod
        spec.loader.exec_module(mod)
    return sys.modules[name]


def videos_of(kf_levels, cur_levels, pose, V):
    """Every level's planes and the pose for V videos: video b the planes
    rolled by (b, 2b) pixels, the pose moved by 2e-4 b (chip_smoke phase
    3b); V = 1 gives them as they are."""
    import torch
    from egomotion_with_local_loop_closures_tpu_torch.track import alignment
    KL, CL = alignment.KeyframeLevel, alignment.CurrentLevel
    if V == 1:
        return ([KL(*(t.contiguous() for t in kf)) for kf in kf_levels],
                [CL(*(t.contiguous() for t in cur)) for cur in cur_levels],
                pose.contiguous())

    def stack(t):
        return torch.stack([torch.roll(t, (b, 2 * b), (0, 1))
                            for b in range(V)])
    return ([KL(*map(stack, kf)) for kf in kf_levels],
            [CL(*map(stack, cur)) for cur in cur_levels],
            pose + 2e-4 * torch.arange(V, device=pose.device,
                                       dtype=torch.float32)[:, None])


def level_times(kf_levels, cur_levels, pose0, cfg, gpu, label="real"):
    """{"V1"/"V8": {"level0".."level3", "align": {"plain_ms",
    "iters_used", "variants": {name: {ms, turns, bound_ms, bound_by,
    bytes, ops, launches}}}}}, printing each line.  The variant
    ``gn_level`` is what the main path runs (``alignment.gn_level`` and
    ``align``); where the port has ``gn_kernel.run_level``, each level is
    also timed with each of its kernels, whatever the level's size."""
    import torch
    from egomotion_with_local_loop_closures_tpu_torch.ops import gn_kernel
    from egomotion_with_local_loop_closures_tpu_torch.track import alignment
    timing = _own("utils/card_timing.py")
    plain_trajectory = _own("ops/gn_reference.py").plain_trajectory
    ops_per_pixel = _own("ops/gn_kernel.py").OPS_PER_PIXEL
    term_w = alignment._termination_weights(cfg.termination_weights,
                                            torch.float32, pose0.device)
    kernels = getattr(gn_kernel, "KERNELS", ()) \
        if hasattr(gn_kernel, "run_level") else ()
    out = {}
    for V in (1, 8):
        kfs, curs, pose = videos_of(kf_levels, cur_levels, pose0, V)
        # the pose each level starts from on the main path, and its result
        starts, res = {}, {}
        p = pose
        for level in range(cfg.num_levels - 1, -1, -1):
            starts[level] = p
            res[level] = alignment.gn_level(kfs[level], curs[level], p,
                                            level, cfg,
                                            int(cfg.max_iters[level]))
            p = res[level][0]
        torch.cuda.synchronize()

        def plain_of(lvls):
            return lambda: [plain_trajectory(
                kfs[lv], curs[lv], starts[lv], lv, cfg,
                int(cfg.max_iters[lv]), term_w) for lv in lvls]

        def variants_of(lv):
            n = int(cfg.max_iters[lv])
            v = {"gn_level": lambda: alignment.gn_level(
                kfs[lv], curs[lv], starts[lv], lv, cfg, n)}
            for k in kernels:
                v[k] = lambda k=k: gn_kernel.run_level(
                    kfs[lv], curs[lv], starts[lv], cfg.level_intrinsics(lv),
                    cfg, n, k)
            return v
        jobs = {f"level{lv}": (variants_of(lv), [lv])
                for lv in range(cfg.num_levels)}
        jobs["align"] = ({"gn_level": lambda: alignment.align(
            kfs, curs, pose, cfg)}, list(range(cfg.num_levels - 1, -1, -1)))
        rows, level_launches = {}, {}
        for name, (variants, lvls) in jobs.items():
            plain = plain_of(lvls)
            # eager first: lazy initialisations (cuBLAS's handle, the
            # workspaces) must not fall into a capture
            for fn in (plain, *variants.values()):
                fn()
            turns = {k: [] for k in ("plain", *variants)}
            order = list(variants)
            for which in ["plain"] + order + order[::-1] + ["plain"]:
                fn = plain if which == "plain" else variants[which]
                reps = 5 if which == "plain" else 200
                turns[which].append(timing.device_ms(fn, reps)[0])
            iters_used = [res[lv][2].reshape(-1).tolist() for lv in lvls]
            row = {"plain_ms": sum(turns["plain"]) / 2, "iters_used":
                   iters_used, "variants": {}}
            for vname, fn in variants.items():
                with gn_kernel.counting_into(
                        dict.fromkeys(gn_kernel.launches, 0)) as launches:
                    fn()
                launches = dict(launches)
                if name != "align":
                    level_launches[(lvls[0], vname)] = launches
                nbytes = ops = 0
                for lv, it in zip(lvls, iters_used):
                    h, w = kfs[lv].image.shape[-2:]
                    ch = curs[lv].image.shape[-2]
                    # a launch that reads the planes reads them once: one
                    # for a whole level in one launch, else one a live
                    # iteration (the two-kernel version's finish reads
                    # none)
                    reads = 1 if level_launches[(lv, vname)].get(
                        "gn_level_cluster") else max(it)
                    plane_b = (3 * h * w + 3 * ch * w) * 4
                    nbytes += sum(min(reads, i) for i in it) * plane_b \
                        + V * (6 + 6 + 11) * 4
                    ops += sum(it) * h * w * ops_per_pixel
                bound, by = timing.bound_ms(nbytes, ops)
                ms = sum(turns[vname]) / len(turns[vname])
                row["variants"][vname] = dict(
                    ms=ms, turns=turns[vname], bound_ms=bound, bound_by=by,
                    bytes=nbytes, ops=ops, launches=launches)
                print(f"K1 {label} {name} V={V} {vname}: device time of the "
                      f"graph {ms:.5f} ms (turns "
                      f"{' '.join(f'{t:.5f}' for t in turns[vname])}), plain "
                      f"{row['plain_ms']:.5f} ms; K1 launches {launches}, "
                      f"iterations used {iters_used}; bound {bound:.6f} ms "
                      f"by {by} ({nbytes} B, {ops} float32 ops), "
                      f"{100 * bound / ms:.2f} % of it reached; on {gpu}",
                      flush=True)
            rows[name] = row
        # the serial finish: one finish-only launch on the level-0 system
        # of these videos, from a graph of it, times the iterations used
        intr = cfg.level_intrinsics(0)
        sys_ = alignment._gn_quantities(kfs[0], curs[0], pose, intr, cfg)
        parts = gn_kernel.pack(*sys_)[..., None, :].contiguous()
        st = gn_kernel.empty_state(pose)
        fin_ms, _ = timing.device_ms(
            lambda: gn_kernel.finish(parts, pose, st, cfg, True), 200)
        for lv in range(cfg.num_levels):
            n = max(rows[f"level{lv}"]["iters_used"][0])
            rows[f"level{lv}"]["finish_ms"] = n * fin_ms
            print(f"K1 {label} level{lv} V={V}: serial finish latency "
                  f"{n} x {fin_ms:.5f} = {n * fin_ms:.5f} ms (one "
                  f"finish-only launch a graph, launch included); on {gpu}")
        out[f"V{V}"] = rows
    return out


def gn_planes(seed, shape):
    """A numpy-seeded GN pair: a keyframe (a smooth texture of integer
    grey levels, a smooth depth with 20 % holes, a variance) and a
    current image, the texture moved by (2.6, 1.3) pixels with noise."""
    import numpy as np
    rng = np.random.default_rng(seed)
    H, W = shape
    y, x = np.mgrid[0:H, 0:W].astype(np.float64)
    freq = rng.uniform(0.02, 0.25, size=(16, 2))
    phase_ = rng.uniform(0.0, 2 * np.pi, size=16)
    amp = rng.uniform(4.0, 12.0, size=16)

    def texture(dx, dy):
        return 128.0 + sum(amp[k] * np.sin(freq[k, 0] * (x - dx)
                                           + freq[k, 1] * (y - dy)
                                           + phase_[k]) for k in range(16))
    f32 = np.float32
    img0 = np.clip(np.round(texture(0.0, 0.0)), 0, 255).astype(f32)
    img1 = np.clip(np.round(texture(2.6, 1.3)
                            + rng.normal(0.0, 2.0, shape)), 0, 255).astype(f32)
    hole = rng.uniform(size=shape) < 0.2
    depth = np.where(hole, 0.0, 1.5 + 0.5 * np.sin(x / 70.0)
                     * np.cos(y / 50.0)).astype(f32)
    var = np.where(hole, -1.0, 0.0005 + 0.002 * rng.uniform(size=shape)
                   ).astype(f32)
    return img0, depth, var, img1


def real_case(cfg, dev):
    """Phase 3b's real case: the keyframe levels after the first interval
    of run_gn, frame 9's levels and the pose align starts from."""
    import numpy as np
    import torch
    from egomotion_with_local_loop_closures_tpu_torch.image import pyramid
    from egomotion_with_local_loop_closures_tpu_torch.runtime import pipeline
    from egomotion_with_local_loop_closures_tpu_torch.track import alignment
    frames = np.load(os.path.join(ROOT, "reference_build", "run_gn",
                                  "frames_480x270.npz"))["frames"]
    st = pipeline.init_pipeline(frames[0], cfg, dev)
    st, _, _ = pipeline.process_interval(st, list(frames[1:8]), cfg)
    cur = alignment.make_current_levels(pyramid.build_pyramid(
        torch.as_tensor(frames[8], device=dev), cfg.num_levels))
    return pipeline._kf_levels(st.kf), cur, st.prev_wrt_kf


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=ROOT,
                    help="checkout whose port is timed (default: this one)")
    ap.add_argument("--out", default="time_k1_levels.json")
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.root))
    import torch
    if not torch.cuda.is_available():
        print("time_k1_levels: needs a CUDA card", file=sys.stderr)
        return 2
    import egomotion_with_local_loop_closures_tpu_torch as port
    from egomotion_with_local_loop_closures_tpu_torch.config import (
        ELLCConfig, PARITY_OVERRIDES)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.splitlines()[0]
    print(f"port from {os.path.dirname(port.__file__)}; gpu {gpu}")
    cfg = ELLCConfig().replace(**PARITY_OVERRIDES)
    dev = torch.device("cuda")
    report = {"gpu": gpu, "root": os.path.abspath(args.root),
              "times": level_times(*real_case(cfg, dev), cfg, gpu)}
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
