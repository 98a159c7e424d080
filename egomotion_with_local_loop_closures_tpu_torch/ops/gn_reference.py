"""K1's plain twin at the scale of a level, and the rule that holds a
kernel's level to it.

K1 (``ops/gn_kernel.py``) runs a level's GN iterations on the card; its
plain twin is ``track/alignment.py``'s ``_gn_quantities`` and
``_gn_update``.  :func:`plain_trajectory` runs that twin's iterations of
a level (the CPU branch of ``gn_level``) on any device and in the pose's
float type without the freeze mask, so that a kernel's state can be
compared with the plain one after the same number of iterations whatever
either run's stop; :meth:`Trajectory.level` is the plain level's result.
:func:`level_agreement` is the rule that ``chip_smoke.py`` (phase 3b) and
``tests/test_torch_gn_kernel.py`` hold a kernel's level to.
"""

from __future__ import annotations

import math
from typing import List, NamedTuple, Tuple

import torch

from egomotion_with_local_loop_closures_tpu_torch.config import ELLCConfig
from egomotion_with_local_loop_closures_tpu_torch.ops.gn_kernel import GNState
from egomotion_with_local_loop_closures_tpu_torch.track import alignment

# How far float32 leaves a level's outputs from float64.  Over a level's
# iterations float32 rounding moves a video's path, most at the coarsest
# level, where videos end unconverged, and the termination metric
# wp = sum |delta_i term_w_i| (a video freezes where wp < 1) and the
# energy with it.  Twice the largest distance from the float64 run that
# tools/k1_metric_spread.py measured on an H100 (PERF.md, Findings)
# over chip_smoke.py phase 3b's cases and the CUDA test's, for the plain
# level in float32 on the card and on the CPU and for both kernels: in the
# metric over the larger of the float64 metric and 1, for each pyramid
# level (0.0179, 0.0317, 0.0597, 0.647), and in the energy relative, over
# every level (0.00096).  Two float32 runs, each that near float64, lie at
# most twice that apart.
METRIC_TOL = (0.036, 0.064, 0.12, 1.3)
ENERGY_TOL = 2e-3


class Trajectory(NamedTuple):
    """A level's plain iterations without the freeze mask, (n, ...) each:
    after iteration j + 1, the pose, that step's termination metric, the
    energy and used count of its linearization, and whether that step
    freezes the video (converged or failed)."""
    pose: torch.Tensor
    wp: torch.Tensor
    energy: torch.Tensor
    valid: torch.Tensor
    stop: torch.Tensor

    def after(self, iters: torch.Tensor) -> GNState:
        """The state of each video after ``iters`` (>= 1, the pose's
        leading axes) iterations; ``done`` is that iteration's stop."""
        j = (iters.long() - 1).clamp(0, self.wp.shape[0] - 1)[None]

        def pick(t):
            return torch.gather(t, 0, j).squeeze(0)
        pose = torch.gather(self.pose, 0, j[..., None].expand(
            (1,) + self.pose.shape[1:])).squeeze(0)
        return GNState(pose, pick(self.wp), iters.to(torch.int32),
                       pick(self.energy), pick(self.valid),
                       pick(self.stop).to(torch.int32))

    def level(self) -> GNState:
        """The plain level's result (``gn_level``'s CPU branch, with the
        freeze flag): each video's state after its first freezing
        iteration, or after the last."""
        n = self.wp.shape[0]
        steps = torch.arange(1, n + 1, device=self.wp.device).reshape(
            (n,) + (1,) * (self.wp.dim() - 1))
        first = torch.where(self.stop, steps, n + 1).amin(dim=0)
        return self.after(first.clamp(max=n))


def _start(pose0: torch.Tensor):
    lead = pose0.shape[:-1]
    f = dict(dtype=pose0.dtype, device=pose0.device)
    return (torch.zeros(lead, dtype=torch.bool, device=pose0.device),
            torch.full(lead, float("inf"), **f),
            torch.zeros(lead, dtype=torch.int32, device=pose0.device),
            torch.zeros(lead, **f), torch.zeros(lead, **f))


def plain_trajectory(kf: alignment.KeyframeLevel,
                     cur: alignment.CurrentLevel, pose0: torch.Tensor,
                     level: int, cfg: ELLCConfig, num_iters: int,
                     term_w: torch.Tensor) -> Trajectory:
    """``num_iters`` plain GN iterations of a level with no video frozen:
    each step from the last step's pose, whatever its stop.  ``term_w``:
    the termination weights on the pose's device, made outside a CUDA
    graph capture (which refuses a host copy).  A float64 run of CUDA
    tensors (a referee) runs on the CPU and comes back to the card: the
    card's compose (``ops/se3_kernel.py``) takes float32 poses only."""
    if pose0.is_cuda and pose0.dtype != torch.float32:
        cpu = plain_trajectory(
            type(kf)(*(t.cpu() for t in kf)),
            type(cur)(*(t.cpu() for t in cur)), pose0.cpu(), level, cfg,
            num_iters, term_w.cpu())
        return Trajectory(*(t.to(pose0.device) for t in cpu))
    intr = cfg.level_intrinsics(level)
    pose, start = pose0, _start(pose0)
    rows = []
    for _ in range(num_iters):
        pose, stop, wp, _, energy, valid = alignment._gn_update(
            *alignment._gn_quantities(kf, cur, pose, intr, cfg), pose,
            *start, term_w)
        rows.append((pose, wp, energy, valid, stop))
    return Trajectory(*(torch.stack(t) for t in zip(*rows)))


def _flat(st: GNState) -> GNState:
    """``st`` on the CPU with one video axis, its floats in float64."""
    V = st.iters.numel()

    def c(t):
        return t.detach().cpu()
    return GNState(c(st.pose).double().reshape(V, 6),
                   c(st.wp_last).double().reshape(V), c(st.iters).reshape(V),
                   c(st.energy).double().reshape(V),
                   c(st.valid).double().reshape(V), c(st.done).reshape(V))


def _near(got, want, want64, tol):
    """Per video, whether ``got`` lies within ``tol`` of ``want`` (the
    pose: in every component), or no farther from the float64 ``want64``
    than twice ``want``'s distance from it; NaN against NaN is no
    distance."""
    def dist(a, b):
        d = torch.where(torch.isnan(a) & torch.isnan(b), 0.0, (a - b).abs())
        return d.amax(-1) if d.dim() == 2 else d
    d, d64, w64 = dist(got, want), dist(got, want64), dist(want, want64)
    return (d <= tol) | (d64 <= 2.0 * w64)


def level_agreement(got: GNState, traj: Trajectory, traj64: Trajectory,
                    level: int, pose_tol: float) -> Tuple[bool, List[str]]:
    """Whether a kernel's state after pyramid level ``level``, ``got``,
    agrees with the plain level of the same inputs (``traj``, the plain
    float32 iterations on any device, and ``traj64``, the float64 ones),
    video by video.

    The stop: the iterations used and the freeze flag equal the plain
    level's.  A video may part only where float32 rounding can decide the
    stop, by one iteration or by the freeze flag after the level's last
    iteration: at the iteration where the two runs part (the earlier
    one's last) the plain metric lies within ``METRIC_TOL[level]`` of 1,
    or 1 lies no farther from the float64 metric than twice the plain
    metric's distance from it.

    The state, against the plain iterations after as many iterations as
    the kernel used: the used count equal; the pose within ``pose_tol`` a
    component, the energy within :data:`ENERGY_TOL` relative and the
    termination metric within ``METRIC_TOL[level]`` of the larger of the
    float64 metric and 1, each or no farther from the float64 value than
    twice the plain value's distance from it.

    Returns (agrees, a line for each video that parts or fails)."""
    g, want = _flat(got), _flat(traj.level())
    ref = _flat(traj.after(got.iters.to(traj.wp.device)))
    ref64 = _flat(traj64.after(got.iters.to(traj64.wp.device)))
    metric, metric64 = (t.wp.detach().double().cpu().reshape(
        t.wp.shape[0], -1) for t in (traj, traj64))
    pose_ok = _near(g.pose, ref.pose, ref64.pose, pose_tol)
    energy_ok = _near(g.energy, ref.energy, ref64.energy,
                      ENERGY_TOL * ref.energy.abs())
    wp_ok = _near(g.wp_last, ref.wp_last, ref64.wp_last,
                  METRIC_TOL[level] * ref64.wp_last.abs().clamp(min=1.0))
    valid_ok = g.valid == ref.valid
    ok, lines = True, []
    for v in range(g.iters.shape[0]):
        k, p = int(g.iters[v]), int(want.iters[v])
        parted = k != p or int(g.done[v]) != int(want.done[v])
        j = min(k, p) - 1
        at, at64 = ((float(m[j, v]) if j >= 0 else math.nan)
                    for m in (metric, metric64))
        stop_ok = not parted or (abs(k - p) <= 1 and (
            abs(at - 1.0) <= METRIC_TOL[level]
            or abs(at64 - 1.0) <= 2.0 * abs(at - at64)))
        held = bool(pose_ok[v] & energy_ok[v] & wp_ok[v] & valid_ok[v])
        ok &= stop_ok and held
        if parted or not held:
            lines.append(
                f"video {v}: iterations {k} (plain {p}), frozen "
                f"{int(g.done[v])} (plain {int(want.done[v])})"
                + (f", plain metric {at:.4g} (float64 {at64:.4g}) where "
                   f"they part" if parted else "")
                + f"; metric {float(g.wp_last[v]):.4g} (plain "
                f"{float(ref.wp_last[v]):.4g}, float64 "
                f"{float(ref64.wp_last[v]):.4g}), pose "
                f"{float((g.pose[v] - ref.pose[v]).abs().max()):.3g} from "
                f"the plain one; held: pose {bool(pose_ok[v])}, energy "
                f"{bool(energy_ok[v])}, metric {bool(wp_ok[v])}, used count "
                f"{bool(valid_ok[v])}")
    return ok, lines
