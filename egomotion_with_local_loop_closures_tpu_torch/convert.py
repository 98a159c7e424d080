"""Moves pipeline states between the JAX package and the port.

A JAX ``PipelineState``, ``DepthMapState`` or ``KeyframeSnapshot`` is
first flattened to nested dicts of numpy arrays keyed by the JAX field
names (:func:`as_tree` flattens any NamedTuple that way, without
importing jax); :func:`to_port` builds the port's object from such a
tree, and :func:`to_numpy` turns a port state back into one.  With it, a
test can start both implementations from the same state at any frame, or
feed one keyframe snapshot to both loop closers.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from egomotion_with_local_loop_closures_tpu_torch.depth.state import (
    DepthMapState)
from egomotion_with_local_loop_closures_tpu_torch.runtime.pipeline import (
    Keyframe, KeyframeSnapshot, PipelineState)
from egomotion_with_local_loop_closures_tpu_torch.track.alignment import (
    KeyframeLevel)


def as_tree(obj):
    """NamedTuple -> dict, tuple/list -> list, array -> numpy array."""
    if hasattr(obj, "_asdict"):
        return {k: as_tree(v) for k, v in obj._asdict().items()}
    if isinstance(obj, (tuple, list)):
        return [as_tree(v) for v in obj]
    return np.asarray(obj)


def _tensor(a, device) -> torch.Tensor:
    return torch.as_tensor(np.array(a), device=device)


def _depth_state(tree, device) -> DepthMapState:
    return DepthMapState(**{f.name: _tensor(tree[f.name], device)
                            for f in dataclasses.fields(DepthMapState)})


def _snapshot(tree, device) -> KeyframeSnapshot:
    return KeyframeSnapshot(
        image=_tensor(tree["image"], device),
        kf_levels=tuple(KeyframeLevel(*(_tensor(lv[k], device)
                                        for k in ("image", "depth", "var")))
                        for lv in tree["kf_levels"]),
        weight_levels=tuple(_tensor(a, device)
                            for a in tree["weight_levels"]),
        world_pose=_tensor(tree["world_pose"], device),
        rescale=_tensor(tree["rescale"], device),
        seeds=_tensor(tree["seeds"], device))


def to_port(tree, device):
    """A flattened JAX ``PipelineState``, ``DepthMapState`` or
    ``KeyframeSnapshot`` -> the port's."""
    device = torch.device(device)
    if "kf_levels" in tree:
        return _snapshot(tree, device)
    if "kf" not in tree:
        return _depth_state(tree, device)
    kf = tree["kf"]
    levels = {k: tuple(_tensor(a, device) for a in kf[k])
              for k in ("images", "depths", "vars_", "weight_acc")}
    return PipelineState(
        kf=Keyframe(**levels,
                    gradx=_tensor(kf["gradx"], device),
                    grady=_tensor(kf["grady"], device),
                    maxgrad=_tensor(kf["maxgrad"], device),
                    world_pose=_tensor(kf["world_pose"], device),
                    rescale=_tensor(kf["rescale"], device),
                    weight_count=_tensor(kf["weight_count"], device)),
        depth=_depth_state(tree["depth"], device),
        prev_wrt_kf=_tensor(tree["prev_wrt_kf"], device),
        global_scale=_tensor(tree["global_scale"], device))


def to_numpy(state):
    """A port ``PipelineState`` or ``DepthMapState`` -> nested dicts of
    numpy arrays keyed by the JAX field names (the loop-closure fields
    ``weight_acc``/``weight_count`` only when the loop window filled
    them)."""
    def np_(t):
        return t.detach().cpu().numpy()
    if isinstance(state, DepthMapState):
        return {f.name: np_(getattr(state, f.name))
                for f in dataclasses.fields(DepthMapState)}
    kf = state.kf
    kf_tree = {"images": [np_(a) for a in kf.images],
               "depths": [np_(a) for a in kf.depths],
               "vars_": [np_(a) for a in kf.vars_],
               "gradx": np_(kf.gradx), "grady": np_(kf.grady),
               "maxgrad": np_(kf.maxgrad),
               "world_pose": np_(kf.world_pose),
               "rescale": np_(kf.rescale)}
    if kf.weight_acc:
        kf_tree.update(weight_acc=[np_(a) for a in kf.weight_acc],
                       weight_count=np_(kf.weight_count))
    return {
        "kf": kf_tree,
        "depth": to_numpy(state.depth),
        "prev_wrt_kf": np_(state.prev_wrt_kf),
        "global_scale": np_(state.global_scale),
    }
