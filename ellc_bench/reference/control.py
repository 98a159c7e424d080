"""The control of the comparison: the plain reference put in the program's
place and computed one precision lower than the configuration states,
bfloat16 for its float32.  The init and every frame step read their frames
and state, and leave their state and outputs, rounded to bfloat16 (the
arithmetic stays float32): what a program that kept its frames, pyramids,
depth maps and poses in bfloat16 would give.  The comparison has to find it not correct."""

from __future__ import annotations

import contextlib
from typing import Iterator

import torch

from ellc_bench.reference import pipeline


def round_bf16(tree):
    """Every float32 tensor of a tree (dataclasses, tuples, None) rounded
    to bfloat16 and back."""
    leaves, spec = pipeline.tree_flatten(tree)
    return pipeline.tree_unflatten(spec, [
        t.to(torch.bfloat16).to(torch.float32) if t.dtype == torch.float32
        else t for t in leaves])


@contextlib.contextmanager
def bfloat16_steps() -> Iterator[None]:
    """Within the block, the reference's init and frame steps round as
    above."""
    orig = (pipeline._track_refine_step, pipeline._keyframe_step)
    init = pipeline.batched_init

    def rounded_init(images, cfg, device):
        images = pipeline._image(images, torch.device(device))
        return round_bf16(init(round_bf16(images), cfg, device))

    def wrap(fn):
        def step(state, image, cfg, replay=False, init_rotation=None):
            image = pipeline._image(image, state.device)
            return round_bf16(fn(round_bf16(state), round_bf16(image), cfg,
                                 replay, init_rotation))
        return step

    pipeline._track_refine_step, pipeline._keyframe_step = map(wrap, orig)
    pipeline.batched_init = rounded_init
    try:
        yield
    finally:
        pipeline._track_refine_step, pipeline._keyframe_step = orig
        pipeline.batched_init = init
