"""The multi-video batched pipeline: V video streams advanced together on
one card.

Port of ``batched_init`` and ``batched_process_interval`` from
``egomotion_with_local_loop_closures_tpu/parallel/sharded.py``, the JAX
package's throughput axis.  There they are ``jax.vmap`` of
``pipeline.init_pipeline`` and ``pipeline.process_interval`` with the
video axis sharded over a device mesh.  Here every tensor of the state
carries an explicit leading video axis V, and the pipeline's own modules
take it: one batched interval makes the same calls, and the same kernel
launches, as one video's interval, each on V videos' data.  K3 (the depth
regularization, ``ops/reg_kernel.py``) runs once per call for all V
videos, on its grid's z axis.  There is no loop over videos, no host read
and no communication between videos: video ``v`` of a batched run is what
``pipeline`` gives for that video alone, up to the summation order of the
card's batched reductions.

The JAX package's ``keys`` become one CPU ``torch.Generator`` per video
(ignored under ``bootstrap_rng == "glibc"``, as in the single-video path)
and its ``mesh`` becomes one explicit device, the card unless the caller
asks for the CPU.  The pixel-sharded Gauss-Newton step
(``sharded_gn_quantities``/``sharded_gn_step``) exists only across several
chips and is not ported.

Whether V videos fit on the card is checked by ``utils/footprint.py``.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from egomotion_with_local_loop_closures_tpu_torch.config import ELLCConfig
from egomotion_with_local_loop_closures_tpu_torch.runtime import pipeline


def _map(fn, *trees):
    """``fn`` over the tensors of one or more states of the same
    structure (dataclasses and tuples of tensors), keeping the
    structure."""
    first = trees[0]
    if isinstance(first, torch.Tensor):
        return fn(*trees)
    if isinstance(first, tuple):
        return tuple(_map(fn, *leaves) for leaves in zip(*trees))
    return type(first)(**{
        f.name: _map(fn, *(getattr(t, f.name) for t in trees))
        for f in dataclasses.fields(first)})


def stack_states(states: Sequence[pipeline.PipelineState]
                 ) -> pipeline.PipelineState:
    """Single-video states -> one state with a leading video axis."""
    return _map(lambda *ts: torch.stack(ts), *states)


def unstack_states(state: pipeline.PipelineState
                   ) -> List[pipeline.PipelineState]:
    """A stacked state -> one single-video state per video."""
    return [_map(lambda t: t[v], state)
            for v in range(state.prev_wrt_kf.shape[0])]


def _frames(images, device) -> torch.Tensor:
    if isinstance(images, torch.Tensor):
        return images.to(device=device, dtype=torch.float32)
    return torch.as_tensor(np.asarray(images, dtype=np.float32),
                           device=device)


def batched_init(images, cfg: ELLCConfig, device="cuda",
                 generators: Optional[Sequence[torch.Generator]] = None
                 ) -> pipeline.PipelineState:
    """Initialize V pipelines from their first frames ``images`` (V, H, W):
    video ``v`` of the result is ``pipeline.init_pipeline(images[v], cfg,
    device, generators[v])``.  ``generators``: one CPU generator per
    video, or None (see ``depth.state.initialize_random``)."""
    images = _frames(images, torch.device(device))
    if images.dim() != 3:
        raise ValueError(f"images must be (V, H, W), not "
                         f"{tuple(images.shape)}")
    if generators is not None and len(generators) != images.shape[0]:
        raise ValueError(f"{len(generators)} generators for "
                         f"{images.shape[0]} videos")
    return pipeline.init_pipeline(images, cfg, device, generators)


def batched_process_interval(states: pipeline.PipelineState, images,
                             cfg: ELLCConfig
                             ) -> Tuple[pipeline.PipelineState,
                                        pipeline.FrameOutput]:
    """Advance every video by one keyframe interval.

    ``states``: a stacked state (leading video axis V); ``images``:
    (V, K, H, W), or (V, K-1, H, W) for a sequence's first interval.
    Returns the new states and the per-frame outputs, every field
    (V, K, ...).  The old keyframes' snapshots are dropped, as the JAX
    package drops them; with the loop window on, each keyframe's GN weight
    images are still accumulated into the state."""
    V = states.prev_wrt_kf.shape[0]
    images = _frames(images, states.device)
    if images.dim() != 4 or images.shape[0] != V:
        raise ValueError(f"images must be ({V}, K, H, W), not "
                         f"{tuple(images.shape)}")
    frames = images.transpose(0, 1).contiguous().unbind(0)
    states, outs, _ = pipeline.process_interval(states, frames, cfg)
    return states, outs
