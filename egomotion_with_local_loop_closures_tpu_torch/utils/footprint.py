"""Device-memory footprint of the batched-video pipeline.

Port of ``egomotion_with_local_loop_closures_tpu/utils/footprint.py``:
account for what one batched interval (``parallel/sharded.py``) needs on
the device, and refuse a video batch that cannot fit with a clean
"requires X, have Y" error instead of a run that dies out of memory.

PyTorch has no ahead-of-time memory analysis of a program, so on a CUDA
device :func:`interval_footprint` measures.  It runs a sequence's first
two batched intervals, of ``keyframe_interval`` - 1 and
``keyframe_interval`` seeded frames, at V = 1 and at V = 2 (after a
short unmeasured run that makes the allocations a process keeps, such as
the cuBLAS workspaces), each after ``torch.cuda.reset_peak_memory_stats``,
reads ``torch.cuda.max_memory_allocated`` above what was allocated before
the probe, and extrapolates linearly in V.  Each probe captures its
V's CUDA graphs of the two intervals afresh (``runtime/graphs.py``): a
run holds both, each with its own static inputs and outputs, so the
peak holds them and their memory pool, and the probe releases them
after.  A run holds one such pool for its video axis, whatever graphs it
captures into it, and keeps it after the run; what the live pools hold
unused is not counted as free (:func:`device_bytes_limit`).  The
pipeline's tensors have
shapes fixed by the configuration, so its memory does not depend on the
frames.  The two probes are made once per configuration and device.  On
the CPU it falls back as the JAX package does on a backend without memory
analysis: arguments and outputs from the shapes, temp 0, no limit.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from egomotion_with_local_loop_closures_tpu_torch.config import ELLCConfig
from egomotion_with_local_loop_closures_tpu_torch.parallel import sharded
from egomotion_with_local_loop_closures_tpu_torch.runtime import (
    checkpoint, graphs)

# float32 values of one FrameOutput: two poses and five scalars
_OUTPUT_FLOATS = 6 + 6 + 5

# (cfg, device) -> measured peak bytes of one batched interval at V = 1, 2
_probes: Dict[Tuple[ELLCConfig, str], Tuple[int, int]] = {}


def tree_bytes(tree) -> int:
    """Total bytes of the tensors (or numpy arrays) of a state: any nesting
    of dataclasses, tuples, lists and dicts."""
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, np.ndarray):
        return tree.nbytes
    if dataclasses.is_dataclass(tree):
        return sum(tree_bytes(getattr(tree, f.name))
                   for f in dataclasses.fields(tree))
    if isinstance(tree, dict):
        return sum(tree_bytes(v) for v in tree.values())
    if isinstance(tree, (tuple, list)):
        return sum(tree_bytes(v) for v in tree)
    return 0


def device_bytes_limit(device=None) -> Optional[int]:
    """Bytes this process can still allocate on a CUDA device: the
    device's free memory (``torch.cuda.mem_get_info``) plus what PyTorch's
    caching allocator holds unused, less what the live CUDA graphs' pools
    hold unused, which only their captures can take.  None on the CPU."""
    device = torch.device("cuda" if device is None else device)
    if device.type != "cuda":
        return None
    free, _ = torch.cuda.mem_get_info(device)
    return (free + torch.cuda.memory_reserved(device)
            - torch.cuda.memory_allocated(device)
            - graphs.idle_pool_bytes(device))


@dataclasses.dataclass
class IntervalFootprint:
    """Memory requirement of batched ``process_interval`` calls at V
    videos (a run's K-1-frame and K-frame interval graphs): measured and
    extrapolated on a CUDA device, from the shapes of one interval alone
    on the CPU."""
    videos: int
    argument_bytes: int        # pipeline states + image batch
    output_bytes: int          # new states + per-frame outputs
    temp_bytes: int            # the rest of the measured peak
    state_bytes: int           # persistent per-V pipeline state alone
    device_limit: Optional[int]

    @property
    def peak_bytes(self) -> int:
        return self.argument_bytes + self.output_bytes + self.temp_bytes

    @property
    def fits(self) -> Optional[bool]:
        if self.device_limit is None:
            return None
        return self.peak_bytes <= self.device_limit

    def describe(self) -> str:
        gb = 1024 ** 3
        lim = (f"{self.device_limit / gb:.2f} GiB"
               if self.device_limit else "unknown")
        return (f"V={self.videos}: args {self.argument_bytes / gb:.3f} + "
                f"out {self.output_bytes / gb:.3f} + "
                f"temp {self.temp_bytes / gb:.3f} = "
                f"{self.peak_bytes / gb:.3f} GiB peak "
                f"(state {self.state_bytes / gb:.3f} GiB); "
                f"device limit {lim}")


def _probe(videos: int, sizes: Tuple[int, ...], cfg: ELLCConfig,
           device: torch.device) -> int:
    """Peak bytes allocated above the current level while ``videos``
    seeded videos are initialized and advanced by intervals of ``sizes``
    frames."""
    rng = np.random.default_rng(videos)
    images = rng.integers(0, 256, size=(videos, 1 + sum(sizes)) + cfg.shape
                          ).astype(np.float32)
    gens = [torch.Generator().manual_seed(v) for v in range(videos)]
    # a run that captures its graphs: their static inputs and pool count
    graphs.release((videos,))
    torch.cuda.synchronize(device)
    base = torch.cuda.memory_allocated(device)
    torch.cuda.reset_peak_memory_stats(device)
    states = sharded.batched_init(images[:, 0], cfg, device, gens)
    start = 1
    for n in sizes:
        states, outs = sharded.batched_process_interval(
            states, images[:, start:start + n], cfg)
        start += n
    torch.cuda.synchronize(device)
    peak = torch.cuda.max_memory_allocated(device) - base
    del states, outs
    graphs.release((videos,))
    return peak


def _measured_peaks(cfg: ELLCConfig, device) -> Tuple[int, int]:
    """The measured peak bytes of a sequence's first two batched intervals
    (K-1 and K frames) at V = 1 and V = 2 on ``device`` (probed once per
    configuration and device)."""
    device = torch.device(device)
    key = (cfg, str(device))
    if key not in _probes:
        _probe(1, (2,), cfg, device)        # allocations the process keeps
        K = cfg.keyframe_interval
        _probes[key] = (_probe(1, (K - 1, K), cfg, device),
                        _probe(2, (K - 1, K), cfg, device))
    return _probes[key]


def interval_footprint(videos: int, cfg: ELLCConfig, device="cuda"
                       ) -> IntervalFootprint:
    """The footprint of batched intervals of ``videos`` videos: on a CUDA
    device the measured peak of a sequence's first two intervals at V = 1
    and 2 extrapolated linearly in V (the first call on a configuration
    runs the probes: a few seconds at 480x270), on the CPU the shapes'
    bytes of one interval."""
    device = torch.device(device)
    K = cfg.keyframe_interval
    state_b = videos * tree_bytes(checkpoint.template_pipeline_state(cfg))
    image_b = videos * K * cfg.rows * cfg.cols * 4
    arg_b = state_b + image_b
    if device.type == "cuda":
        p1, p2 = _measured_peaks(cfg, device)
        out_b = state_b + videos * K * _OUTPUT_FLOATS * 4
        tmp_b = max(0, p1 + (videos - 1) * (p2 - p1) - arg_b - out_b)
    else:
        out_b = arg_b
        tmp_b = 0
    return IntervalFootprint(
        videos=videos, argument_bytes=arg_b, output_bytes=out_b,
        temp_bytes=tmp_b, state_bytes=state_b,
        device_limit=device_bytes_limit(device))


def check_fits(videos: int, cfg: ELLCConfig, device="cuda"
               ) -> IntervalFootprint:
    """Raise a clean, actionable error when the V-video interval cannot
    fit on the device, instead of a run that dies out of memory."""
    fp = interval_footprint(videos, cfg, device)
    if fp.fits is False:
        raise MemoryError(
            f"batched pipeline does not fit on this device: "
            f"{fp.describe()}. Reduce the video batch (V) or split the "
            f"videos over several cards.")
    return fp
