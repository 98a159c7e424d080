"""What the drivers share: the configurations of both sides, the seeds of
the inputs, and the hand-over of a program state to the plain reference
for the step-by-step comparison."""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Iterator

import numpy as np
import torch


def port_config(overrides: dict):
    """The port's ``ELLCConfig`` with a configuration file's overrides."""
    from egomotion_with_local_loop_closures_tpu_torch.config import (
        ELLCConfig)
    return ELLCConfig().replace(**{
        k: tuple(v) if isinstance(v, list) else v
        for k, v in overrides.items()})


def reference_config(cfg):
    """The reference's ``ELLCConfig`` with the same fields."""
    from ellc_bench.reference.config import ELLCConfig
    return ELLCConfig(**dataclasses.asdict(cfg))


def seeds_of(seed: int, count: int) -> np.ndarray:
    """``count`` (scene, trajectory) seed pairs drawn from ``seed``."""
    rng = np.random.default_rng(seed & (2 ** 64 - 1))
    return rng.integers(0, 2 ** 31 - 1, size=(count, 2))


def sample_rng(seed: int) -> np.random.Generator:
    """The generator of the comparison's samples, apart from the inputs'."""
    return np.random.default_rng((seed ^ 0x5EED) & (2 ** 64 - 1))


def map_tree(fn, tree):
    """``fn`` over the tensors of a tree of dataclasses and tuples."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if tree is None:
        return None
    if isinstance(tree, tuple):
        children = [map_tree(fn, c) for c in tree]
        return type(tree)(*children) if hasattr(tree, "_fields") \
            else tuple(children)
    return type(tree)(**{f.name: map_tree(fn, getattr(tree, f.name))
                         for f in dataclasses.fields(tree)})


def to_reference(tree):
    """A program state (or keyframe snapshot, or keyframe levels) as the
    reference's types over the same tensors: the two share class names,
    field names and order."""
    from ellc_bench.reference import pipeline as ref
    from ellc_bench.reference.depth import state as ref_state
    from ellc_bench.reference.track import alignment as ref_align
    types = {"PipelineState": ref.PipelineState, "Keyframe": ref.Keyframe,
             "KeyframeSnapshot": ref.KeyframeSnapshot,
             "DepthMapState": ref_state.DepthMapState,
             "KeyframeLevel": ref_align.KeyframeLevel}
    if isinstance(tree, torch.Tensor) or tree is None:
        return tree
    if isinstance(tree, tuple):
        children = [to_reference(c) for c in tree]
        if hasattr(tree, "_fields"):
            return types[type(tree).__name__](*children)
        return tuple(children)
    return types[type(tree).__name__](**{
        f.name: to_reference(getattr(tree, f.name))
        for f in dataclasses.fields(tree)})


@contextlib.contextmanager
def plain_float32() -> Iterator[None]:
    """TF32 off for matrix products and convolutions within the block."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def add(spans: dict, name: str, value: float) -> None:
    """Appends ``value`` to the span list ``name``."""
    spans.setdefault(name, []).append(value)


def render_traffic(traffic: dict, seed: int, count: int, cfg, device):
    """``count`` clips of the mix (``traffic``'s scene kind, trajectory and
    texture parameters, ``clip_frames`` frames each), each with its own
    scene and trajectory seed: their frames (count, N, H, W) rendered on
    ``device`` and their ground-truth poses (count, N, 6) on the CPU.

    With ``pool_seed`` in the mix, the clips are a fixed pool drawn from
    it, in an order drawn from ``seed``: every seed then gives the same
    work in another order, so that runs of different seeds differ by their
    noise alone.  Without it, every clip is drawn from ``seed``."""
    from ellc_bench.frames import render
    N = int(traffic["clip_frames"])
    frames = torch.empty((count, N, cfg.rows, cfg.cols), dtype=torch.float32,
                         device=device)
    kw = {k: traffic[k] for k in ("rot_step", "trans_step", "rot_amp",
                                  "trans_amp", "texture") if k in traffic}
    if "pool_seed" in traffic:
        pairs = seeds_of(int(traffic["pool_seed"]), count)[
            np.random.default_rng(seed & (2 ** 64 - 1)).permutation(count)]
    else:
        pairs = seeds_of(seed, count)
    scenes, gt = render.build_scenes_and_poses(traffic["scene"], pairs, N,
                                               **kw)
    for v, scene in enumerate(scenes):
        frames[v] = render.render_frames(scene, gt[v], cfg.rows, cfg.cols,
                                         (cfg.fx, cfg.fy, cfg.cx, cfg.cy),
                                         device)
    return frames, gt
