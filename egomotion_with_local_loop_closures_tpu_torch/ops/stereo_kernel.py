"""One frame's epipolar line stereo and EKF observation as one hand-written
CUDA kernel (K2).

Replaces the XLA program that the JAX package compiles for
``egomotion_with_local_loop_closures_tpu/depth/stereo.py::observe``
(stereo.py:674, the dense path) with its epipolar direction, segment,
descriptor, walk, subpixel step, triangulation, variance model and EKF
rules.  The CUDA source is ``csrc/stereo_kernel.cu``; what bounds it and
how it is laid out is written at the top of that file.

:func:`observe` takes what ``depth/stereo.py::observe`` takes and returns
its :class:`~egomotion_with_local_loop_closures_tpu_torch.depth.stereo.
ObserveResult`, one launch for all V videos of a batch.  Its launches are
counted in :data:`launches`; a call made while a CUDA graph captures
launches nothing, so ``runtime/graphs.py`` counts those calls apart with
:func:`counting_into` and adds the graph's K2 nodes at each replay.

For tensors on the CPU it runs the plain PyTorch version
(``depth/stereo.py::plain_observe``).  For CUDA tensors it launches the
kernel or raises; it never falls back.  Nothing here reads the card's
values back to the host or copies host data to the card: the
configuration goes in as a kernel argument (:class:`Params`), so a CUDA
graph can capture every call.
"""

from __future__ import annotations

import contextlib
import ctypes
import re
from pathlib import Path
from typing import Dict, Iterator, Optional

import torch

from egomotion_with_local_loop_closures_tpu_torch import ops
from egomotion_with_local_loop_closures_tpu_torch.config import ELLCConfig
from egomotion_with_local_loop_closures_tpu_torch.depth import stereo
from egomotion_with_local_loop_closures_tpu_torch.depth.state import (
    FIELDS, DepthMapState)

SOURCE: Path = ops.CSRC / "stereo_kernel.cu"
MAX_STEPS = 64          # the kernel's most steps a walk (kMaxSteps)

# Launches on the CUDA path since the last reset_launches().
launches: Dict[str, int] = {"stereo_observe": 0}
# Launches of the eager warm-ups before CUDA graph captures, kept apart
# from launches (runtime/graphs.py), since the last reset_launches().
warmup_launches: Dict[str, int] = {"stereo_observe": 0}
# where the wrapper counts its calls: launches, or counting_into's dict
_counts: Dict[str, int] = launches

_lib: Optional[ctypes.CDLL] = None


class Params(ctypes.Structure):
    """``StereoParams`` of ``csrc/stereo_kernel.cu``, field for field."""
    _fields_ = [(name, ctypes.c_float) for name in (
        "fx", "fy", "cx", "cy",
        "min_abs_grad_decrease", "min_abs_grad_create",
        "min_epl_length_squared", "min_epl_grad_squared",
        "min_epl_angle_squared",
        "gradient_sample_dist", "stereo_epl_var_fac", "inv_min_depth",
        "max_epl_length_crop", "min_epl_length_crop",
        "sample_point_to_border",
        "max_error_stereo", "four_max_error_stereo",
        "min_distance_error_stereo",
        "division_eps", "four_camera_pixel_noise", "cx_over_fx",
        "cy_over_fy",
        "max_var", "validity_counter_dec", "fail_var_inc_fac",
        "succ_var_inc_fac",
        "validity_counter_inc", "validity_counter_max",
        "validity_counter_max_variable", "validity_counter_initial_observe",
        "diff_fac_observe")] + [(name, ctypes.c_int) for name in (
            "border", "min_blacklist", "steps")]


def params(cfg: ELLCConfig) -> Params:
    """The kernel's constants from ``cfg``: each as the plain twin's
    float32 ops see it (a product or quotient of two config values is
    taken in Python, then rounded once, as there)."""
    derived = dict(
        inv_min_depth=1.0 / cfg.min_depth,
        four_max_error_stereo=4.0 * cfg.max_error_stereo,
        four_camera_pixel_noise=4.0 * cfg.camera_pixel_noise,
        cx_over_fx=cfg.cx / cfg.fx,
        cy_over_fy=cfg.cy / cfg.fy, steps=cfg.stereo_max_steps)
    return Params(**{name: derived[name] if name in derived
                     else getattr(cfg, name) for name, _ in Params._fields_})


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0
        warmup_launches[k] = 0


def add_launches(counts: Dict[str, int]) -> None:
    """Count launches that no wrapper call makes: the K2 nodes of a CUDA
    graph, added at each of its replays (``runtime/graphs.py``)."""
    for k, n in counts.items():
        launches[k] += n


@contextlib.contextmanager
def counting_into(counts: Dict[str, int]) -> Iterator[Dict[str, int]]:
    """Count the wrapper's launches in ``counts`` instead of
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
    ``stereo_observe``; None for any other function."""
    return ("stereo_observe" if re.search(r"\d+stereo_observeE", kernel_name)
            else None)


def build() -> Path:
    """Compile ``csrc/stereo_kernel.cu`` unless a library of this exact
    source, headers and flag set is already built; returns its path."""
    return ops.build(SOURCE, "ellc_stereo")


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declares the C signature of ``ellc_stereo_observe`` on a loaded
    library."""
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.ellc_stereo_observe.argtypes = [p] * 22 + [i] * 3 + [Params, p]
    lib.ellc_stereo_observe.restype = i
    return lib


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        _lib = bind(ctypes.CDLL(str(build())))
    return _lib


def _check(tensors: Dict[str, torch.Tensor], shape, dtypes) -> None:
    dev = tensors["pose"].device
    if dev.type != "cuda":
        raise ValueError(f"K2 runs on CUDA tensors or CPU tensors, not {dev}")
    for name, t in tensors.items():
        want = shape[:-2] + (6,) if name == "pose" else shape
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, expected {dev}")
        if t.dtype != dtypes.get(name, torch.float32):
            raise TypeError(f"{name} has dtype {t.dtype}, expected "
                            f"{dtypes.get(name, torch.float32)}")
        if tuple(t.shape) != want:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                             f"{want}")


def _launch(lib: ctypes.CDLL, state: DepthMapState, kf_image, kf_gradx,
            kf_grady, kf_maxgrad, cur_image, pose, cfg: ELLCConfig,
            stream: int) -> stereo.ObserveResult:
    """One launch of ``ellc_stereo_observe`` on ``stream`` over contiguous
    tensors of one device: the new state and the counts."""
    shape = tuple(kf_image.shape)
    if len(shape) not in (2, 3) or pose.shape != shape[:-2] + (6,):
        raise ValueError(f"images (H, W) or (V, H, W) with poses (6,) or "
                         f"(V, 6), not {shape} and {tuple(pose.shape)}")
    if not 1 <= cfg.stereo_max_steps <= MAX_STEPS:
        raise ValueError(f"stereo_max_steps {cfg.stereo_max_steps} is "
                         f"outside the kernel's 1..{MAX_STEPS}")
    H, W = shape[-2:]
    V = shape[0] if len(shape) == 3 else 1
    out = DepthMapState(**{n: torch.empty_like(getattr(state, n))
                           for n in FIELDS})
    counts = torch.zeros((2,) + shape[:-2], dtype=torch.int32,
                         device=pose.device)
    planes = [getattr(state, n) for n in FIELDS]
    planes += [kf_image, kf_gradx, kf_grady, kf_maxgrad, cur_image, pose]
    planes += [getattr(out, n) for n in FIELDS] + [counts[0], counts[1]]
    err = lib.ellc_stereo_observe(
        *[ctypes.c_void_p(t.data_ptr()) for t in planes], V, H, W,
        params(cfg), ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"stereo_observe launch failed: cudaError {err}")
    return stereo.ObserveResult(state=out, num_created=counts[0],
                                num_updated=counts[1])


def observe(state: DepthMapState, kf_image: torch.Tensor,
            kf_gradx: torch.Tensor, kf_grady: torch.Tensor,
            kf_maxgrad: torch.Tensor, cur_image: torch.Tensor,
            pose_cur_wrt_kf: torch.Tensor,
            cfg: ELLCConfig) -> stereo.ObserveResult:
    """``depth/stereo.py::observe`` as one K2 launch for all videos (images
    and state planes (H, W) or (V, H, W), poses (6,) or (V, 6)); the
    counts are int32, one per video.  On the CPU the plain version: this
    is the one place that routes ``depth/stereo.py::observe``."""
    if pose_cur_wrt_kf.device.type == "cpu":
        return stereo.plain_observe(state, kf_image, kf_gradx, kf_grady,
                                    kf_maxgrad, cur_image, pose_cur_wrt_kf,
                                    cfg)
    named = {n: getattr(state, n) for n in FIELDS}
    named.update(kf_image=kf_image, kf_gradx=kf_gradx, kf_grady=kf_grady,
                 kf_maxgrad=kf_maxgrad, cur_image=cur_image,
                 pose=pose_cur_wrt_kf)
    named = {k: t.contiguous() for k, t in named.items()}
    _check(named, tuple(kf_image.shape),
           {"blacklisted": torch.int32, "valid": torch.bool})
    with torch.cuda.device(pose_cur_wrt_kf.device):
        res = _launch(_library(), DepthMapState(**{n: named[n]
                                                   for n in FIELDS}),
                      *(named[k] for k in ("kf_image", "kf_gradx",
                                           "kf_grady", "kf_maxgrad",
                                           "cur_image", "pose")),
                      cfg, torch.cuda.current_stream().cuda_stream)
    _counts["stereo_observe"] += 1
    return res
