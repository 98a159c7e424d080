"""The tracker's Gauss-Newton iterations as two hand-written CUDA kernels
(K1).

Replaces the XLA program that the JAX package compiles for one GN
iteration: ``egomotion_with_local_loop_closures_tpu/track/alignment.py``
``_gn_quantities`` (alignment.py:89) with the 6x6 solve, the pose update
and the freeze mask of its ``gn_level``.  The CUDA source is
``csrc/gn_kernel.cu``.  On this card an iteration's bytes take under a
microsecond at 270x480 and far less on the coarser levels, while its
finish (the solve, compose and exp of one video) is a serial chain of a
few microseconds and every launch costs a few more: K1 is bound by
latency, and the design cuts launches and serial chains:

- ``gn_level_cluster``: a whole level in one launch, one thread-block
  cluster a video; the iterations loop inside the launch, the blocks meet
  at the cluster's barrier once an iteration, and each block sums all
  blocks' sums through distributed shared memory in rank order and
  finishes alike;
- ``gn_step``: one launch an iteration (the levels too large to run
  fast in one cluster): a thread a pixel, and the block that takes its video's last
  ticket (an integer counter in :class:`Workspace`) sums the blocks'
  partials in a fixed order and finishes.  Its other modes: a
  linearization alone (:func:`linearize`, :func:`gn_quantities`: the
  pixel-sharded step, ``parallel/sharded.py``, at a row offset) and a
  finish alone on given partials (:func:`finish`).

:func:`gn_level` takes ``gn_level_cluster`` for a template of at most
:data:`CLUSTER_MAX_PIXELS` pixels and ``gn_step`` above;
:func:`run_level` runs either at any level.  Each finish forms the next
iteration's transform ``exp(pose)``, so no block but a level's first
iteration's starts with a serial ``exp_se3`` (gn_step hands it on in
:class:`Workspace`).  Each wrapper counts its launches in
:data:`launches`; a call made while a CUDA graph captures launches
nothing, so ``runtime/graphs.py`` counts those calls apart with
:func:`counting_into` and adds the graph's K1 nodes at each replay.
:func:`gn_level` has both kernels count its live iterations on the card,
into the level's row of ``utils/profiling``'s ``k1_live`` table (one
integer atomic a live video an iteration; no launch and no graph node).

For tensors on the CPU each function runs the plain PyTorch version
(``track/alignment.py``: ``_gn_quantities``, ``solve_spd``,
``lie.compose`` and the freeze mask).  For CUDA tensors it launches the
kernels or raises; it never falls back.  Nothing here reads the card's
values back to the host or copies host data to the card, so a CUDA graph
can capture every call: the intrinsics, weights and constants are kernel
arguments, a level's first iteration starts the freeze state in the
kernel, and the workspace of a (device, V) is made on its first call,
outside any capture (the step graphs' eager warm-up).
"""

from __future__ import annotations

import contextlib
import ctypes
import math
import re
from pathlib import Path
from typing import Dict, Iterator, NamedTuple, Optional, Tuple

import torch

from egomotion_with_local_loop_closures_tpu_torch import ops
from egomotion_with_local_loop_closures_tpu_torch.config import ELLCConfig
from egomotion_with_local_loop_closures_tpu_torch.track import alignment
from egomotion_with_local_loop_closures_tpu_torch.utils import profiling

SOURCE: Path = ops.CSRC / "gn_kernel.cu"
THREADS = 256           # gn_step's block: one template pixel a thread
SUMS = 29               # H's lower triangle (21), g (6), energy, used count
# (i, j) of H's lower triangle, row-major: the order of the partials
TRIL = [(i, j) for i in range(6) for j in range(i + 1)]
# The largest template, in pixels, whose level gn_level runs as one
# gn_level_cluster launch; a larger one runs gn_step, a launch an
# iteration.  At 270x480 the levels hold 129,600, 32,400, 8,040 and 1,980
# pixels: levels 2-3 take the cluster.  At level 1 each of a cluster's
# 4,096 threads walks ~8 pixels in turn, and gn_step's 127 blocks were
# the faster at one video (whole-level graphs on an H100, PERF.md,
# Findings: tools/time_k1_levels.py and tools/tune_gn_kernel.py).
CLUSTER_MAX_PIXELS = 10_000
KERNELS = ("gn_level_cluster", "gn_step")
# float32 operations a template pixel an iteration, counted by hand from
# csrc/gn_kernel.cu (each add, sub, mul, div, sqrt, abs, floor, ceil, min,
# max and float compare one): backprojection 6, R P + t 18, UNZERO 2,
# projection 6, bilinear corners 14, three blends 36, u, v, 1/d and the
# residual 4, the variance and Huber weight 27, the steepest-descent rows
# 37, the 29 products 41 and the block's sum 29
OPS_PER_PIXEL = 220
# a finish's serial operations a video (Cholesky and substitutions 184,
# exp_se3 of the step and of the new pose 240, the product 63, log_se3
# 140, the termination metric 12); summing its partials adds one a partial
FINISH_OPS = 640
# gn_step's modes (csrc/gn_kernel.cu)
_ITERATE, _LINEARIZE, _FINISH = 0, 1, 2

# Launches on the CUDA path since the last reset_launches(), per kernel.
launches: Dict[str, int] = dict.fromkeys(KERNELS, 0)
# Launches of the eager warm-ups before CUDA graph captures, kept apart
# from launches (runtime/graphs.py), since the last reset_launches().
warmup_launches: Dict[str, int] = dict.fromkeys(KERNELS, 0)
# where the wrappers count their calls: launches, or counting_into's dict
_counts: Dict[str, int] = launches

_lib: Optional[ctypes.CDLL] = None


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0
        warmup_launches[k] = 0


def add_launches(counts: Dict[str, int]) -> None:
    """Count launches that no wrapper call makes: the K1 nodes of a CUDA
    graph, added at each of its replays (``runtime/graphs.py``)."""
    for k, n in counts.items():
        launches[k] += n


@contextlib.contextmanager
def counting_into(counts: Dict[str, int]) -> Iterator[Dict[str, int]]:
    """Count the wrappers' launches in ``counts`` instead of
    :data:`launches` while the block runs (a CUDA graph's warm-up and
    capture, ``runtime/graphs.py``)."""
    global _counts
    prev, _counts = _counts, counts
    try:
        yield counts
    finally:
        _counts = prev


def wrapper_of(kernel_name: str) -> Optional[str]:
    """The counter of the CUDA function of this (mangled) name:
    ``gn_level_cluster`` or ``gn_step``; None for any other function."""
    m = re.search(r"\d+(gn_level_cluster|gn_step)E", kernel_name)
    return None if m is None else m.group(1)


def build() -> Path:
    """Compile ``csrc/gn_kernel.cu`` unless a library of this exact source
    and flag set is already built; returns the library's path."""
    return ops.build(SOURCE, "ellc_gn")


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declares the C signatures of ``ellc_gn_step`` and
    ``ellc_gn_level_cluster`` on a loaded library."""
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.ellc_gn_step.argtypes = [p] * 17 + [i] * 9 + [f] * 12 + [p]
    lib.ellc_gn_step.restype = i
    lib.ellc_gn_level_cluster.argtypes = [p] * 14 + [i] * 5 + [f] * 12 + [p]
    lib.ellc_gn_level_cluster.restype = i
    return lib


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        _lib = bind(ctypes.CDLL(str(build())))
    return _lib


class GNState(NamedTuple):
    """A level's GN state, one entry per video (leading axes of the pose):
    the pose and, from the last live iteration, the termination metric,
    the applied updates, the energy and used-pixel count, and whether the
    video is frozen (int32 0/1)."""
    pose: torch.Tensor
    wp_last: torch.Tensor
    iters: torch.Tensor
    energy: torch.Tensor
    valid: torch.Tensor
    done: torch.Tensor


class Workspace(NamedTuple):
    """What gn_step's launches keep between them on one device for V
    videos: the tickets (V,) int32, 0 between launches, and ``T`` (V, 12),
    the transform exp_se3(pose) that one iteration's finish hands to the
    next."""
    tickets: torch.Tensor
    T: torch.Tensor


_workspaces: Dict[Tuple[torch.device, int], Workspace] = {}


def make_workspace(V: int, device) -> Workspace:
    """Zeroed tickets and a transform buffer (a level's first iteration
    forms its transform)."""
    return Workspace(torch.zeros(V, dtype=torch.int32, device=device),
                     torch.zeros((V, 12), dtype=torch.float32, device=device))


def workspace(device: torch.device, V: int) -> Workspace:
    """The workspace of ``device`` (a CUDA device) for V videos, made on
    its first call, which must not be under a CUDA graph capture."""
    ws = _workspaces.get((device, V))
    if ws is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                f"K1's workspace for {V} videos on {device} is made outside "
                f"a CUDA graph capture: run the call once eagerly first")
        ws = _workspaces[(device, V)] = make_workspace(V, device)
    return ws


def empty_state(pose0: torch.Tensor) -> GNState:
    """Uninitialised state tensors, for a kernel that starts the level."""
    lead = pose0.shape[:-1]
    f32 = dict(dtype=torch.float32, device=pose0.device)
    i32 = dict(dtype=torch.int32, device=pose0.device)
    return GNState(torch.empty_like(pose0), torch.empty(lead, **f32),
                   torch.empty(lead, **i32), torch.empty(lead, **f32),
                   torch.empty(lead, **f32), torch.empty(lead, **i32))


def pack(Hmat: torch.Tensor, g: torch.Tensor, energy: torch.Tensor,
         valid: torch.Tensor) -> torch.Tensor:
    """The 29 sums of one system, (..., 29): H's lower triangle, g, the
    energy and the used count."""
    i, j = zip(*TRIL)
    return torch.cat([Hmat[..., list(i), list(j)], g, energy[..., None],
                      valid[..., None]], dim=-1)


def sums(partials: torch.Tensor
         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """(H (..., 6, 6) symmetric, g (..., 6), energy, used count) from
    partials (..., blocks, 29), the blocks summed in one fixed order."""
    s = torch.sum(partials, dim=-2)
    Hmat = torch.zeros(s.shape[:-1] + (6, 6), dtype=s.dtype, device=s.device)
    i, j = zip(*TRIL)
    Hmat[..., list(i), list(j)] = s[..., :21]
    Hmat[..., list(j), list(i)] = s[..., :21]
    return Hmat, s[..., 21:27], s[..., 27], s[..., 28]


def _check(tensors: Dict[str, torch.Tensor], dtypes: Dict[str, torch.dtype]):
    dev = next(iter(tensors.values())).device
    if dev.type != "cuda":
        raise ValueError(f"K1 runs on CUDA tensors or CPU tensors, not {dev}")
    for name, t in tensors.items():
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, expected {dev}")
        if t.dtype != dtypes.get(name, torch.float32):
            raise TypeError(f"{name} has dtype {t.dtype}, expected "
                            f"{dtypes.get(name, torch.float32)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} is not contiguous")


def _ptr(t: Optional[torch.Tensor]) -> Optional[ctypes.c_void_p]:
    return None if t is None else ctypes.c_void_p(t.data_ptr())


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")


def _shapes(kf: alignment.KeyframeLevel, cur: alignment.CurrentLevel,
            pose: torch.Tensor) -> Tuple[int, int, int, int]:
    """(V, template rows, columns, current rows), checking that every
    plane has the pose's leading axes (none, or one video axis)."""
    if pose.shape[-1:] != (6,) or pose.dim() > 2:
        raise ValueError(f"pose must be (6,) or (V, 6), not "
                         f"{tuple(pose.shape)}")
    lead = tuple(pose.shape[:-1])
    h, w = kf.image.shape[-2:]
    ch = cur.image.shape[-2]
    for name, t in (*zip(("kf.image", "kf.depth", "kf.var"), kf),
                    *zip(("cur.image", "cur.gradx", "cur.grady"), cur)):
        want = lead + ((h, w) if name.startswith("kf") else (ch, w))
        if tuple(t.shape) != want:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                             f"{want}")
    return (lead[0] if lead else 1), h, w, ch


def blocks(h: int, w: int) -> int:
    """gn_step's blocks a video for an h x w template: one per 256
    pixels."""
    return -(-h * w // THREADS)


def kernel_for(h: int, w: int) -> str:
    """The kernel :func:`gn_level` runs an h x w template's level with."""
    return "gn_level_cluster" if h * w <= CLUSTER_MAX_PIXELS else "gn_step"


def align_launches(cfg: ELLCConfig,
                   max_iters: Optional[Tuple[int, ...]] = None
                   ) -> Dict[str, int]:
    """K1's launches in one ``alignment.align`` on the card with these
    iteration counts (``cfg.max_iters`` by default): one gn_level_cluster
    launch a level that takes it, one gn_step launch an iteration of a
    level that does not, none for a level of no iterations."""
    counts = dict.fromkeys(KERNELS, 0)
    for level, n in enumerate(cfg.max_iters if max_iters is None
                              else max_iters):
        kernel = kernel_for(*cfg.level_shape(level))
        if n:
            counts[kernel] += 1 if kernel == "gn_level_cluster" else int(n)
    return counts


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def _launch_step(lib: ctypes.CDLL, mode: int, first: bool,
                 pose_in: torch.Tensor, st: GNState,
                 partials: torch.Tensor, cfg: ELLCConfig, stream: int,
                 kf: Optional[alignment.KeyframeLevel] = None,
                 cur: Optional[alignment.CurrentLevel] = None,
                 intr: Tuple[float, float, float, float] = (0, 0, 0, 0),
                 y_offset: int = 0, ws: Optional[Workspace] = None,
                 live: Optional[torch.Tensor] = None, it: int = 0) -> None:
    """One launch of ``ellc_gn_step`` on ``stream``: ``mode`` _ITERATE
    (planes, ``ws`` and a whole state), _LINEARIZE (planes; of the state
    only ``done`` may be given, the rest None) or _FINISH (no planes; the
    given partials).  ``live``: the level's int64 row of live counts,
    where the launch, iteration ``it`` of its level, counts its live
    videos (None: none)."""
    V = math.prod(pose_in.shape[:-1])
    if kf is None:
        planes, h, w, ch = (None,) * 6, 0, 0, 0
    else:
        planes = (*kf, *cur)
        _, h, w, ch = _shapes(kf, cur, pose_in)
    tickets, T = (None, None) if ws is None else ws
    err = lib.ellc_gn_step(
        *[_ptr(t) for t in (*planes, pose_in, *st, T, partials, tickets,
                            live)],
        V, h, w, ch, int(y_offset), partials.shape[-2], mode, int(first),
        int(it), *intr, cfg.camera_pixel_noise_2, cfg.huber_d / 2.0,
        *cfg.termination_weights, ctypes.c_void_p(stream))
    _raise_on(err, "gn_step")


def _launch_cluster(lib: ctypes.CDLL, kf: alignment.KeyframeLevel,
                    cur: alignment.CurrentLevel, pose0: torch.Tensor,
                    st: GNState, intr: Tuple[float, float, float, float],
                    cfg: ELLCConfig, num_iters: int, stream: int,
                    live: Optional[torch.Tensor] = None) -> None:
    """One launch of ``ellc_gn_level_cluster`` on ``stream``: the level's
    ``num_iters`` iterations from ``pose0``, written to ``st``, and their
    live videos counted into ``live`` (None: not counted)."""
    V, h, w, ch = _shapes(kf, cur, pose0)
    err = lib.ellc_gn_level_cluster(
        *[_ptr(t) for t in (*kf, *cur, pose0, *st, live)],
        V, h, w, ch, int(num_iters), *intr, cfg.camera_pixel_noise_2,
        cfg.huber_d / 2.0, *cfg.termination_weights, ctypes.c_void_p(stream))
    _raise_on(err, "gn_level_cluster")


def level_launches(lib: ctypes.CDLL, ws: Workspace,
                   kf: alignment.KeyframeLevel, cur: alignment.CurrentLevel,
                   pose0: torch.Tensor,
                   intr: Tuple[float, float, float, float], cfg: ELLCConfig,
                   num_iters: int, kernel: str, stream: int,
                   live: Optional[torch.Tensor] = None) -> GNState:
    """A level's ``num_iters`` (>= 1) iterations from ``pose0`` as
    ``kernel`` launches of ``lib`` on ``stream`` (one of gn_level_cluster,
    or one of gn_step an iteration), on contiguous planes; returns the new
    state.  ``live``: a contiguous int64 row of at least ``num_iters``
    entries, where entry i counts the videos live at iteration i's start
    (None: not counted)."""
    st = empty_state(pose0)
    if kernel == "gn_level_cluster":
        _launch_cluster(lib, kf, cur, pose0, st, intr, cfg, num_iters,
                        stream, live)
        return st
    h, w = kf.image.shape[-2:]
    partials = torch.empty(pose0.shape[:-1] + (blocks(h, w), SUMS),
                           dtype=torch.float32, device=pose0.device)
    for it in range(num_iters):
        _launch_step(lib, _ITERATE, it == 0, pose0 if it == 0 else st.pose,
                     st, partials, cfg, stream, kf, cur, intr, ws=ws,
                     live=live, it=it)
    return st


def linearize(kf: alignment.KeyframeLevel, cur: alignment.CurrentLevel,
              pose: torch.Tensor, intr: Tuple[float, float, float, float],
              cfg: ELLCConfig, y_offset: int = 0,
              done: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One linearization at ``pose`` ((6,) or (V, 6), the level fields
    (H, W) or (V, H, W)): partials (..., blocks, 29), one gn_step launch.
    On the CPU the plain ``_gn_quantities``'s sums as one block.  ``done``
    (int32, the pose's leading axes): videos whose blocks the kernel skips
    (their partials are left unwritten), as :func:`finish` ignores
    them."""
    if pose.device.type == "cpu":
        return pack(*alignment._gn_quantities(kf, cur, pose, intr, cfg,
                                              y_offset))[..., None, :]
    named = dict(zip(("kf_image", "kf_depth", "kf_var"), kf))
    named.update(zip(("cur_image", "cur_gradx", "cur_grady"), cur))
    named["pose"] = pose
    if done is not None:
        named["done"] = done
    _check(named, {"done": torch.int32})
    _, h, w, _ = _shapes(kf, cur, pose)
    partials = torch.empty(pose.shape[:-1] + (blocks(h, w), SUMS),
                           dtype=torch.float32, device=pose.device)
    with torch.cuda.device(pose.device):
        _launch_step(_library(), _LINEARIZE, done is None, pose,
                     GNState(*(None,) * 5, done), partials, cfg, _stream(),
                     kf, cur, intr, y_offset)
    _counts["gn_step"] += 1
    return partials


def _update(Hmat, g, e, n, pose, st: Optional[GNState], term_w
            ) -> GNState:
    """The plain body (``alignment._gn_update``) on a :class:`GNState`;
    ``st`` None starts the level's freeze state, as ``gn_level`` does."""
    lead = pose.shape[:-1]
    if st is None:
        zero = torch.zeros(lead, dtype=pose.dtype, device=pose.device)
        zi = torch.zeros(lead, dtype=torch.int32, device=pose.device)
        st = GNState(pose, torch.full_like(zero, float("inf")), zi, zero,
                     zero, zi)
    pose, done, wp_last, iters, energy, valid = alignment._gn_update(
        Hmat, g, e, n, pose, st.done != 0, st.wp_last, st.iters, st.energy,
        st.valid, term_w)
    return GNState(pose, wp_last, iters, energy, valid,
                   done.to(torch.int32))


def finish(partials: torch.Tensor, pose_in: torch.Tensor, st: GNState,
           cfg: ELLCConfig, first: bool) -> GNState:
    """Sum ``partials`` (..., blocks, 29), solve, update and freeze: one GN
    iteration after its linearization (gn_step's finish alone, one block a
    video).  ``first``: the level's first iteration, whose pose is
    ``pose_in`` and which starts the freeze state (``st`` is then only
    written); else ``pose_in`` is ``st.pose``.  On the card the kernel
    writes ``st``'s tensors in place and returns ``st``; on the CPU the
    plain body returns new tensors."""
    if pose_in.device.type == "cpu":
        term_w = alignment._termination_weights(cfg.termination_weights,
                                                torch.float32, pose_in.device)
        return _update(*sums(partials), pose_in, None if first else st,
                       term_w)
    lead = tuple(pose_in.shape[:-1])
    if (tuple(partials.shape[:-2]) != lead or partials.shape[-1] != SUMS
            or any(tuple(t.shape) != lead for t in st[1:])
            or st.pose.shape != pose_in.shape):
        raise ValueError(f"partials {tuple(partials.shape)} and state "
                         f"{[tuple(t.shape) for t in st]} do not fit the "
                         f"pose {tuple(pose_in.shape)}")
    _check(dict(partials=partials, pose_in=pose_in, **st._asdict()),
           {"iters": torch.int32, "done": torch.int32})
    with torch.cuda.device(pose_in.device):
        _launch_step(_library(), _FINISH, first, pose_in, st, partials, cfg,
                     _stream())
    _counts["gn_step"] += 1
    return st


def gn_quantities(kf: alignment.KeyframeLevel, cur: alignment.CurrentLevel,
                  pose: torch.Tensor, intr: Tuple[float, float, float, float],
                  cfg: ELLCConfig, y_offset: int = 0
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                             torch.Tensor]:
    """One linearization's (H, g, energy, used count): the plain
    ``_gn_quantities`` on the CPU, gn_step's linearization and a
    fixed-order sum of its partials on the card."""
    if pose.device.type == "cpu":
        return alignment._gn_quantities(kf, cur, pose, intr, cfg, y_offset)
    kf = alignment.KeyframeLevel(*(t.contiguous() for t in kf))
    cur = alignment.CurrentLevel(*(t.contiguous() for t in cur))
    return sums(linearize(kf, cur, pose.contiguous(), intr, cfg, y_offset))


def iterate(kf: alignment.KeyframeLevel, cur: alignment.CurrentLevel,
            pose0: torch.Tensor, intr: Tuple[float, float, float, float],
            cfg: ELLCConfig, num_iters: int, lin=linearize, fin=finish
            ) -> GNState:
    """A level's ``num_iters`` (>= 1) iterations, each one ``lin`` and one
    ``fin`` call (a linearization and a finish alone); the first starts
    the freeze state from ``pose0``, the others skip the frozen videos'
    linearization."""
    st = empty_state(pose0)
    for it in range(num_iters):
        first = it == 0
        pose = pose0 if first else st.pose
        partials = lin(kf, cur, pose, intr, cfg,
                       done=None if first else st.done)
        st = fin(partials, pose, st, cfg, first)
    return st


def run_level(kf: alignment.KeyframeLevel, cur: alignment.CurrentLevel,
              pose0: torch.Tensor, intr: Tuple[float, float, float, float],
              cfg: ELLCConfig, num_iters: int, kernel: str,
              live: Optional[torch.Tensor] = None) -> GNState:
    """A level's ``num_iters`` (>= 1) iterations from ``pose0`` with
    ``kernel`` (``gn_level_cluster`` or ``gn_step``) at any level, the
    live iterations counted into ``live`` (a row of ``k1_live``'s table,
    or None); on the CPU the plain :func:`iterate`."""
    if pose0.device.type == "cpu":
        return iterate(kf, cur, pose0, intr, cfg, num_iters)
    if kernel not in KERNELS:
        raise ValueError(f"kernel must be one of {KERNELS}, not {kernel!r}")
    kf = alignment.KeyframeLevel(*(t.contiguous() for t in kf))
    cur = alignment.CurrentLevel(*(t.contiguous() for t in cur))
    pose0 = pose0.contiguous()
    named = dict(zip(("kf_image", "kf_depth", "kf_var"), kf))
    named.update(zip(("cur_image", "cur_gradx", "cur_grady"), cur))
    named["pose0"] = pose0
    if live is not None:
        if live.dim() != 1 or live.shape[0] < num_iters:
            raise ValueError(f"live must be a row of at least {num_iters} "
                             f"counts, not {tuple(live.shape)}")
        named["live"] = live
    _check(named, {"live": torch.int64})
    V = math.prod(pose0.shape[:-1])
    with torch.cuda.device(pose0.device):
        st = level_launches(_library(), workspace(pose0.device, V), kf, cur,
                            pose0, intr, cfg, num_iters, kernel, _stream(),
                            live)
    _counts[kernel] += 1 if kernel == "gn_level_cluster" else num_iters
    return st


def gn_level(kf: alignment.KeyframeLevel, cur: alignment.CurrentLevel,
             pose0: torch.Tensor, level: int, cfg: ELLCConfig,
             num_iters: int):
    """``alignment.gn_level`` on the card: one gn_level_cluster launch for
    a template of at most :data:`CLUSTER_MAX_PIXELS` pixels, else
    ``num_iters`` gn_step launches, the live iterations counted into the
    level's row of ``profiling.k1_live``.  Returns (pose, weighted_pose,
    iters_used, (energy, valid_count)), as the plain version does."""
    if pose0.device.type == "cpu":
        return alignment.gn_level(kf, cur, pose0, level, cfg, num_iters)
    if num_iters == 0:
        lead = pose0.shape[:-1]
        zero = torch.zeros(lead, dtype=pose0.dtype, device=pose0.device)
        return (pose0, torch.full_like(zero, float("inf")),
                torch.zeros(lead, dtype=torch.int32, device=pose0.device),
                (zero, zero.clone()))
    h, w = kf.image.shape[-2:]
    live = profiling.k1_live(pose0.device, cfg.num_levels,
                             max(num_iters, *cfg.max_iters))[level]
    st = run_level(kf, cur, pose0, cfg.level_intrinsics(level), cfg,
                   num_iters, kernel_for(h, w), live)
    return st.pose, st.wp_last, st.iters, (st.energy, st.valid)
