"""One Gauss-Newton iteration of the tracker as two hand-written CUDA
kernels (K1).

Replaces the XLA program that the JAX package compiles for one GN
iteration: ``egomotion_with_local_loop_closures_tpu/track/alignment.py``
``_gn_quantities`` (alignment.py:89) with the 6x6 solve, the pose update
and the freeze mask of its ``gn_level``.  The CUDA source is
``csrc/gn_kernel.cu``; what bounds it and how it is laid out is written
at the top of that file.

- :func:`linearize` (K1a, ``gn_linearize``): warps, samples and weighs
  every template pixel and sums the 29 terms of the 6x6 system (H's lower
  triangle, g, the energy, the used count) per block of 256 pixels, into
  ``partials`` (V, blocks, 29);
- :func:`finish` (K1b, ``gn_finish``): sums a video's partials, solves,
  composes the step onto the pose and applies the freeze mask, in place
  on a :class:`GNState`.

:func:`gn_level` runs a level's iterations as one launch of each per
iteration, and :func:`gn_quantities` one linearization's sums (the
pixel-sharded step, ``parallel/sharded.py``).  Each wrapper counts its
launches in :data:`launches`; a call made while a CUDA graph captures
launches nothing, so ``runtime/graphs.py`` counts those calls apart with
:func:`counting_into` and adds the graph's K1 nodes at each replay.

For tensors on the CPU each function runs the plain PyTorch version
(``track/alignment.py``: ``_gn_quantities``, ``solve_spd``,
``lie.compose`` and the freeze mask).  For CUDA tensors it launches the
kernels or raises; it never falls back.  Nothing here reads the card's
values back to the host or copies host data to the card, so a CUDA graph
can capture every call: the intrinsics, weights and constants are kernel
arguments, and a level's first iteration starts the freeze state in the
kernel (``first``).
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

SOURCE: Path = ops.CSRC / "gn_kernel.cu"
THREADS = 256           # K1a's block: one template pixel a thread
SUMS = 29               # H's lower triangle (21), g (6), energy, used count
# (i, j) of H's lower triangle, row-major: the order of the partials
TRIL = [(i, j) for i in range(6) for j in range(i + 1)]

# Launches on the CUDA path since the last reset_launches(), per wrapper.
launches: Dict[str, int] = {"gn_linearize": 0, "gn_finish": 0}
# Launches of the eager warm-ups before CUDA graph captures, kept apart
# from launches (runtime/graphs.py), since the last reset_launches().
warmup_launches: Dict[str, int] = {"gn_linearize": 0, "gn_finish": 0}
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
    ``gn_linearize`` or ``gn_finish``; None for any other function."""
    m = re.search(r"\d+gn_(linearize|finish)E", kernel_name)
    return None if m is None else f"gn_{m.group(1)}"


def build() -> Path:
    """Compile ``csrc/gn_kernel.cu`` unless a library of this exact source
    and flag set is already built; returns the library's path."""
    return ops.build(SOURCE, "ellc_gn")


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declares the C signatures of ``ellc_gn_linearize`` and
    ``ellc_gn_finish`` on a loaded library."""
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.ellc_gn_linearize.argtypes = [p] * 9 + [i] * 5 + [f] * 6 + [p]
    lib.ellc_gn_linearize.restype = i
    lib.ellc_gn_finish.argtypes = [p] * 8 + [i] * 3 + [f] * 6 + [p]
    lib.ellc_gn_finish.restype = i
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


def empty_state(pose0: torch.Tensor) -> GNState:
    """Uninitialised state tensors for :func:`finish` with ``first``."""
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
    """K1a's blocks for an h x w template: one per 256 pixels."""
    return -(-h * w // THREADS)


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def _launch_linearize(lib: ctypes.CDLL, kf: alignment.KeyframeLevel,
                      cur: alignment.CurrentLevel, pose: torch.Tensor,
                      intr: Tuple[float, float, float, float],
                      cfg: ELLCConfig, y_offset: int,
                      done: Optional[torch.Tensor], stream: int
                      ) -> torch.Tensor:
    """One launch of ``ellc_gn_linearize`` on ``stream``; returns the
    partials (..., blocks, 29)."""
    V, h, w, ch = _shapes(kf, cur, pose)
    partials = torch.empty(pose.shape[:-1] + (blocks(h, w), SUMS),
                           dtype=torch.float32, device=pose.device)
    fx, fy, cx, cy = intr
    err = lib.ellc_gn_linearize(
        *[_ptr(t) for t in (*kf, *cur, pose, done, partials)],
        V, h, w, ch, int(y_offset), fx, fy, cx, cy,
        cfg.camera_pixel_noise_2, cfg.huber_d / 2.0, ctypes.c_void_p(stream))
    _raise_on(err, "gn_linearize")
    return partials


def _launch_finish(lib: ctypes.CDLL, partials: torch.Tensor,
                   pose_in: torch.Tensor, st: GNState, cfg: ELLCConfig,
                   first: bool, stream: int) -> GNState:
    """One launch of ``ellc_gn_finish`` on ``stream``, writing ``st``."""
    lead = tuple(pose_in.shape[:-1])
    if (tuple(partials.shape[:-2]) != lead or partials.shape[-1] != SUMS
            or any(tuple(t.shape) != lead for t in st[1:])
            or st.pose.shape != pose_in.shape):
        raise ValueError(f"partials {tuple(partials.shape)} and state "
                         f"{[tuple(t.shape) for t in st]} do not fit the "
                         f"pose {tuple(pose_in.shape)}")
    err = lib.ellc_gn_finish(
        *[_ptr(t) for t in (partials, pose_in, *st)],
        math.prod(lead), partials.shape[-2], int(first),
        *cfg.termination_weights, ctypes.c_void_p(stream))
    _raise_on(err, "gn_finish")
    return st


def linearize(kf: alignment.KeyframeLevel, cur: alignment.CurrentLevel,
              pose: torch.Tensor, intr: Tuple[float, float, float, float],
              cfg: ELLCConfig, y_offset: int = 0,
              done: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One linearization at ``pose`` ((6,) or (V, 6), the level fields
    (H, W) or (V, H, W)): partials (..., blocks, 29).  On the CPU the plain
    ``_gn_quantities``'s sums as one block.  ``done`` (int32, the pose's
    leading axes): videos whose blocks K1a skips (their partials are left
    unwritten), as :func:`finish` ignores them."""
    if pose.device.type == "cpu":
        return pack(*alignment._gn_quantities(kf, cur, pose, intr, cfg,
                                              y_offset))[..., None, :]
    named = dict(zip(("kf_image", "kf_depth", "kf_var"), kf))
    named.update(zip(("cur_image", "cur_gradx", "cur_grady"), cur))
    named["pose"] = pose
    if done is not None:
        named["done"] = done
    _check(named, {"done": torch.int32})
    with torch.cuda.device(pose.device):
        partials = _launch_linearize(_library(), kf, cur, pose, intr, cfg,
                                     y_offset, done, _stream())
    _counts["gn_linearize"] += 1
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
    iteration after its linearization.  ``first``: the level's first
    iteration, whose pose is ``pose_in`` and which starts the freeze
    state (``st`` is then only written); else ``pose_in`` is ``st.pose``.
    On the card the kernel writes ``st``'s tensors in place and returns
    ``st``; on the CPU the plain body returns new tensors."""
    if pose_in.device.type == "cpu":
        term_w = alignment._termination_weights(cfg.termination_weights,
                                                torch.float32, pose_in.device)
        return _update(*sums(partials), pose_in, None if first else st,
                       term_w)
    _check(dict(partials=partials, pose_in=pose_in, **st._asdict()),
           {"iters": torch.int32, "done": torch.int32})
    with torch.cuda.device(pose_in.device):
        _launch_finish(_library(), partials, pose_in, st, cfg, first,
                       _stream())
    _counts["gn_finish"] += 1
    return st


def gn_quantities(kf: alignment.KeyframeLevel, cur: alignment.CurrentLevel,
                  pose: torch.Tensor, intr: Tuple[float, float, float, float],
                  cfg: ELLCConfig, y_offset: int = 0
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                             torch.Tensor]:
    """One linearization's (H, g, energy, used count): the plain
    ``_gn_quantities`` on the CPU, K1a and a fixed-order sum of its
    partials on the card."""
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
    ``fin`` call (K1a and K1b); the first starts the freeze state from
    ``pose0``, the others skip the frozen videos' linearization."""
    st = empty_state(pose0)
    for it in range(num_iters):
        first = it == 0
        pose = pose0 if first else st.pose
        partials = lin(kf, cur, pose, intr, cfg,
                       done=None if first else st.done)
        st = fin(partials, pose, st, cfg, first)
    return st


def gn_level(kf: alignment.KeyframeLevel, cur: alignment.CurrentLevel,
             pose0: torch.Tensor, level: int, cfg: ELLCConfig,
             num_iters: int):
    """``alignment.gn_level`` on the card: ``num_iters`` launches of K1a
    and K1b.  Returns (pose, weighted_pose, iters_used, (energy,
    valid_count)), as the plain version does."""
    if pose0.device.type == "cpu":
        return alignment.gn_level(kf, cur, pose0, level, cfg, num_iters)
    if num_iters == 0:
        lead = pose0.shape[:-1]
        zero = torch.zeros(lead, dtype=pose0.dtype, device=pose0.device)
        return (pose0, torch.full_like(zero, float("inf")),
                torch.zeros(lead, dtype=torch.int32, device=pose0.device),
                (zero, zero.clone()))
    st = iterate(alignment.KeyframeLevel(*(t.contiguous() for t in kf)),
                 alignment.CurrentLevel(*(t.contiguous() for t in cur)),
                 pose0.contiguous(), cfg.level_intrinsics(level), cfg,
                 num_iters)
    return st.pose, st.wp_last, st.iters, (st.energy, st.valid)
