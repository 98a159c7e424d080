"""GN mode over a backlog of videos at once: the port's
``parallel.sharded.batched_init`` and ``batched_process_interval``.

A pass tracks every video of the mix from its first frame: one
``batched_init`` on the first frames, then the keyframe intervals (the
first of K-1 frames, then K each), every video in the same calls; the
pass ends when its outputs are read back.  The frames of every video are
rendered once, on the device, in set-up.

The comparison follows the program step by step from its own state, since
tracking is chaotic: two float32 runs that differ in the last place part
after some tens of frames.  A sample of the videos and of the intervals,
drawn from the seed, is compared: the pass keeps those videos' states
before and after each sampled interval, and the plain reference
(``ellc_bench/reference``) runs each sampled interval from the state
before it, on the same frames.  The start is compared by itself: the
reference's ``batched_init`` of the same first frames against the
program's state before interval 0, which is always sampled.

Each quantity is a widest gap, for each sampled video apart, of the
interval's outputs (the tracked poses with respect to the keyframe and
the world: K1, K4's compose; the seeds and the keyframe's rescale factor:
K2, K3, K4's refresh and, at the interval's keyframe step, propagate and
``make_keyframe``) and of every field of the state after it (the depth
filter's maps, masks and counters; the keyframe's image, depth and
variance pyramids, its world pose and rescale; the last pose; the global
scale): see ``_state_gaps``.  The init is held by each quantity's widest
gap over the videos, since in sound runs it reads the program's float32
rounding at most; the intervals by the worst video's median over its
sampled intervals, so that a fault in one video's slot shows whole while
one chaotic step of one video does not.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, List, Tuple

import numpy as np
import torch

from ellc_bench import accuracy, compare
from ellc_bench.common import (add, map_tree, plain_float32,
                               port_config, reference_config, sample_rng,
                               render_traffic, to_reference)


def schedule(frames: int, K: int) -> List[Tuple[int, int]]:
    """(first frame, frames) of each keyframe interval of a clip of
    ``frames`` frames after its init frame: K-1 frames first, so keyframes
    land on multiples of K, then K each; a tail short of K is left out."""
    out, b = [], 1
    while b + (K - 1 if b == 1 else K) <= frames:
        size = K - 1 if b == 1 else K
        out.append((b, size))
        b += size
    return out


OUTPUT_FIELDS = ("pose_wrt_kf", "pose_wrt_world", "seeds", "rescale")
OUTPUT_QUANTITY = {"pose_wrt_kf": "pose_kf_gap",
                   "pose_wrt_world": "pose_world_gap",
                   "seeds": "seeds_gap", "rescale": "rescale_gap"}


def _state_gaps(a, b) -> Dict[str, np.ndarray]:
    """The gaps of every field of a program state ``a`` (the sampled
    videos) against the reference's ``b``, one entry a video, grouped by
    quantity (each the widest of its fields; the keyframe's loop-window
    weights, empty in GN mode, are left out):

    - ``pose_kf_gap``: the last pose with respect to the keyframe;
    - ``pose_world_gap``: the keyframe's world pose;
    - ``rescale_gap``: the keyframe's rescale factor and the global scale;
    - ``depth_gap``, ``var_gap``: inverse depth and variance, raw and
      smoothed, over the pixels valid on both sides (relative mean);
    - ``valid_flip``: pixels valid on one side only;
    - ``counter_flip``: pixels whose validity counter or blacklist count
      differ;
    - ``image_gap``: the keyframe's image pyramid and level-0 gradients;
    - ``kf_depth_gap``, ``kf_valid_flip``: the keyframe's depth and
      variance pyramids over the cells set on both sides, and the cells
      set on one side only.
    """
    da, db = a.depth, b.depth
    depth, flip = compare.masked_gaps(da.idepth_smoothed, db.idepth_smoothed,
                                      da.valid, db.valid)
    gaps = {
        "pose_kf_gap": [compare.value_gaps(a.prev_wrt_kf, b.prev_wrt_kf)],
        "pose_world_gap": [compare.value_gaps(a.kf.world_pose,
                                              b.kf.world_pose)],
        "rescale_gap": [compare.ratio_gaps(a.kf.rescale, b.kf.rescale),
                        compare.ratio_gaps(a.global_scale, b.global_scale)],
        "depth_gap": [depth, compare.masked_gaps(
            da.idepth, db.idepth, da.valid, db.valid)[0]],
        "var_gap": [compare.masked_gaps(getattr(da, f), getattr(db, f),
                                        da.valid, db.valid)[0]
                    for f in ("var", "var_smoothed")],
        "valid_flip": [flip],
        "counter_flip": [compare.changed_share(getattr(da, f), getattr(db, f))
                         for f in ("validity", "blacklisted")],
        "image_gap": [compare.value_gaps(x, y) for x, y in zip(
            a.kf.images + (a.kf.gradx, a.kf.grady, a.kf.maxgrad),
            b.kf.images + (b.kf.gradx, b.kf.grady, b.kf.maxgrad))],
        "kf_depth_gap": [], "kf_valid_flip": []}
    for x, y, valid in ([(x, y, lambda t: t > 0) for x, y in zip(
            a.kf.depths, b.kf.depths)] + [(x, y, lambda t: t >= 0)
                                          for x, y in zip(a.kf.vars_,
                                                          b.kf.vars_)]):
        rel, flip = compare.masked_gaps(x, y, valid(x), valid(y))
        gaps["kf_depth_gap"].append(rel)
        gaps["kf_valid_flip"].append(flip)
    return {q: np.max(v, axis=0) for q, v in gaps.items()}


class Driver:
    RATE_METRIC = "track_fps"

    def __init__(self, config: dict, traffic: dict, seed: int, device):
        self.cfg = port_config(config["overrides"])
        self.traffic = traffic
        self.seed = seed
        self.device = torch.device(device)
        self.V = int(traffic["videos"])
        self.N = int(traffic["clip_frames"])
        self.plan = schedule(self.N, self.cfg.keyframe_interval)
        rng = sample_rng(seed)
        self.sample = np.sort(rng.choice(
            self.V, size=min(int(traffic["check_videos"]), self.V),
            replace=False))
        n_int = min(int(traffic["check_intervals"]), len(self.plan))
        self.intervals = [0] + sorted(rng.choice(
            np.arange(1, len(self.plan)), size=n_int - 1,
            replace=False).tolist())
        # the states kept by a pass: before each sampled interval and
        # after it (index len(plan): after the last)
        self.kept = sorted(set(self.intervals)
                           | {k + 1 for k in self.intervals})
        self.outputs: List[Tuple[np.ndarray, ...]] = []
        self.snaps: Dict[int, object] = {}
        self.attempted = self.failed = 0

    # -- the timed path ---------------------------------------------------
    def setup(self) -> None:
        t = time.perf_counter()
        self.frames, self.gt = render_traffic(self.traffic, self.seed,
                                              self.V, self.cfg, self.device)
        self.idx = torch.as_tensor(self.sample, device=self.device)
        self.setup_s = {"render": time.perf_counter() - t}
        # the warm pass: every graph and shape of the window
        t = time.perf_counter()
        self.run_pass({}, {})
        self.setup_s["warm pass"] = time.perf_counter() - t
        self.outputs.clear()
        self.attempted = 0

    def pass_work(self) -> dict:
        steps = sum(size for _, size in self.plan)
        keyframe_steps = len(self.plan)
        return dict(videos=self.V, frames=self.V * steps,
                    aligns=self.V * steps,
                    track_refine_steps=steps - keyframe_steps,
                    keyframe_steps=keyframe_steps, frame_steps=steps,
                    rows=self.cfg.rows, cols=self.cfg.cols,
                    levels=self.cfg.num_levels)

    def _keep(self, k: int, states) -> None:
        if k in self.kept:
            self.snaps[k] = map_tree(lambda t: t[self.idx], states)

    def run_pass(self, spans: Dict[str, list], counters: dict,
                 profiled=contextlib.nullcontext) -> int:
        """One pass; ``profiled`` (a context manager) is held around the
        whole of it."""
        with profiled():
            return self._run_pass(spans, counters)

    def _run_pass(self, spans: Dict[str, list], counters: dict) -> int:
        from egomotion_with_local_loop_closures_tpu_torch.parallel import (
            sharded)
        cfg = self.cfg
        t = time.perf_counter()
        states = sharded.batched_init(self.frames[:, 0], cfg, self.device)
        add(spans, "init", time.perf_counter() - t)
        outs = []
        for k, (b, size) in enumerate(self.plan):
            self._keep(k, states)
            t = time.perf_counter()
            states, out = sharded.batched_process_interval(
                states, self.frames[:, b:b + size], cfg)
            add(spans, "interval", time.perf_counter() - t)
            add(spans, "interval_steps", size)
            outs.append(out)
        self._keep(len(self.plan), states)
        t = time.perf_counter()
        got = tuple(torch.cat([getattr(o, f) for o in outs], 1).cpu().numpy()
                    for f in OUTPUT_FIELDS)
        add(spans, "readback", time.perf_counter() - t)
        self.outputs.append(got)
        self.attempted += self.V
        counters["passes"] = counters.get("passes", 0) + 1
        return self.V * sum(size for _, size in self.plan)

    def report_lines(self) -> List[str]:
        lines = ["set-up: " + ", ".join(f"{k} {v:.3f} s"
                                       for k, v in self.setup_s.items())]
        for k in sorted({0, len(self.outputs) - 1}):
            poses = self.outputs[k][1]
            lost = int((~np.isfinite(poses).all(-1)).sum())
            ates = [float(accuracy.ate_rmse(torch.from_numpy(poses[v]),
                                            self.gt[v, 1:]))
                    for v in range(self.V)]
            lines.append(f"pass {k}: ATE against the ground truth over "
                         f"{self.V} videos: min {np.min(ates):.6g} median "
                         f"{np.median(ates):.6g} max {np.max(ates):.6g}; "
                         f"frames with a pose not finite {lost}")
        lines.append(f"{len(self.outputs)} passes of {self.V} videos; "
                     f"compared: videos {self.sample.tolist()}, intervals "
                     f"{self.intervals} of the last pass")
        return lines

    def release(self) -> None:
        """Keeps the last pass's sampled states and outputs, frees the rest
        of the program's memory."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            torch.cuda.empty_cache()

    # -- the comparison ---------------------------------------------------
    def reference_steps(self, control: bool = False):
        """The reference (with ``control``, the bfloat16 control) from the
        program's kept states: its init of the sampled videos, and for each
        sampled interval its outputs and the state after it."""
        from ellc_bench.reference import control as ctl
        from ellc_bench.reference import pipeline as ref
        rcfg = reference_config(self.cfg)
        frames = self.frames[self.idx]
        with plain_float32():
            with ctl.bfloat16_steps() if control else contextlib.nullcontext():
                init = ref.batched_init(frames[:, 0], rcfg, self.device)
                steps = {}
                for k in self.intervals:
                    b, size = self.plan[k]
                    st, out = ref.batched_process_interval(
                        to_reference(self.snaps[k]),
                        frames[:, b:b + size], rcfg)
                    steps[k] = (tuple(getattr(out, f).cpu().numpy()
                                      for f in OUTPUT_FIELDS), st)
        return init, steps

    def program_steps(self):
        """The program's side of the same: its state before interval 0, and
        for each sampled interval its outputs and the state after it."""
        out = self.outputs[-1]
        steps = {}
        for k in self.intervals:
            b, size = self.plan[k]
            steps[k] = (tuple(a[self.sample, b - 1:b - 1 + size]
                              for a in out), self.snaps[k + 1])
        return self.snaps[0], steps

    def entries(self, got, want) -> Dict[str, np.ndarray]:
        """Each quantity's gaps of ``got`` against the reference's ``want``
        (each an (init state, {interval: (outputs, state after)})), one
        entry a sampled video and a stage: ``init`` (videos,) and
        ``interval`` (sampled intervals, videos)."""
        init = _state_gaps(got[0], want[0])
        stages = []
        for k, (outs, after) in got[1].items():
            w_outs, w_after = want[1][k]
            row = _state_gaps(after, w_after)
            for f, a, b in zip(OUTPUT_FIELDS, outs, w_outs):
                q = OUTPUT_QUANTITY[f]
                gap = (compare.ratio_gaps if f == "rescale"
                       else compare.value_gaps)(a, b)
                row[q] = np.maximum(row[q], gap) if q in row else gap
            stages.append(row)
        return {"init": init,
                "interval": {q: np.stack([r[q] for r in stages])
                             for q in stages[0]}}

    def numbers(self, got, want) -> Dict[str, float]:
        """The compared numbers: at the init each quantity's widest gap
        over the sampled videos (``init.<quantity>``), over the sampled
        intervals the worst video's median (``interval.<quantity>``)."""
        e = self.entries(got, want)
        out = {f"init.{q}": compare.worst_video(v)
               for q, v in e["init"].items()}
        out.update({f"interval.{q}": compare.worst_video_median(v)
                    for q, v in e["interval"].items()})
        return out

    def readings(self, control: bool) -> dict:
        """After a pass: the numbers of the program and, with ``control``,
        of the bfloat16 control, each against the reference."""
        want = self.reference_steps()
        got = self.program_steps()
        out = {"program": self.numbers(got, want),
               "entries": {stage: {q: v.tolist() for q, v in e.items()}
                           for stage, e in self.entries(got, want).items()},
               "reference_pose_abs": float(max(
                   np.abs(o[0][1]).max() for o in want[1].values()))}
        if control:
            out["control"] = self.numbers(self.reference_steps(True), want)
        return out

    def check(self, limits: dict) -> List[Tuple[str, float, float]]:
        nums = self.numbers(self.program_steps(), self.reference_steps())
        checks = [(k, nums[k], float(limit)) for k, limit in limits.items()]
        self.failed = 0 if all(v <= lim for _, v, lim in checks) else len(
            self.sample)
        return checks
