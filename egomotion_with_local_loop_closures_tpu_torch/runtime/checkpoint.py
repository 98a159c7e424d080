"""Checkpoint / resume of the pipeline state.

Port of ``egomotion_with_local_loop_closures_tpu/runtime/checkpoint.py``.
The reference checkpoints at batch granularity through the filesystem
(``FLAG_SAVE_MATS`` text mats, ``src/Frame.cpp:698-905``) and resumes by
relaunching the binary at a new start id (``src/ToggleFlags.h:135-196``,
``src/main.cpp:156-166``); the restart clears the in-memory loop window,
and a resumed run here starts with an empty window too.

- :func:`save` / :func:`load`: a ``PipelineState`` <-> one ``.npz`` file
  (+ ``.json`` metadata).  Every tensor is stored under its field path
  (``kf.images.0``, ``depth.valid``, ``global_scale``), and :func:`load`
  checks the names, shapes and dtypes against what ``init_pipeline``
  makes for the configuration, so a mismatch fails by name.
- :class:`CheckpointManager`: ``step_<N>`` snapshots in one directory,
  the newest ``keep`` kept, an atomically replaced ``latest`` pointer.
- :func:`save_mat_text` / :func:`load_mat_text`: the reference's
  ``saveMatAsText`` / ``makeMatFromText`` format, byte for byte what the
  JAX package writes.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, Optional

import numpy as np
import torch

from egomotion_with_local_loop_closures_tpu_torch.config import ELLCConfig
from egomotion_with_local_loop_closures_tpu_torch.depth.state import (
    DepthMapState)
from egomotion_with_local_loop_closures_tpu_torch.runtime import pipeline


# ------------------------------------------------------------ state files

def flatten(tree, prefix: str = "") -> Dict[str, torch.Tensor]:
    """Dataclasses and tuples of tensors -> {field path: tensor}."""
    if dataclasses.is_dataclass(tree):
        out = {}
        for f in dataclasses.fields(tree):
            out.update(flatten(getattr(tree, f.name), f"{prefix}{f.name}."))
        return out
    if isinstance(tree, tuple):
        out = {}
        for i, v in enumerate(tree):
            out.update(flatten(v, f"{prefix}{i}."))
        return out
    return {prefix[:-1]: tree}


def _unflatten(template, leaves: Dict[str, torch.Tensor], prefix: str = ""):
    """``template``'s structure with every tensor taken from ``leaves``."""
    if dataclasses.is_dataclass(template):
        return dataclasses.replace(template, **{
            f.name: _unflatten(getattr(template, f.name), leaves,
                               f"{prefix}{f.name}.")
            for f in dataclasses.fields(template)})
    if isinstance(template, tuple):
        return tuple(_unflatten(v, leaves, f"{prefix}{i}.")
                     for i, v in enumerate(template))
    return leaves[prefix[:-1]]


def template_pipeline_state(cfg: ELLCConfig) -> pipeline.PipelineState:
    """A ``PipelineState`` of tensors on the meta device with the fields,
    shapes and dtypes that ``init_pipeline`` makes for ``cfg``."""
    def e(shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device="meta")
    levels = tuple(e(cfg.level_shape(l)) for l in range(cfg.num_levels))
    plane = cfg.shape
    kf = pipeline.Keyframe(
        images=levels, depths=levels, vars_=levels, gradx=e(plane),
        grady=e(plane), maxgrad=e(plane), world_pose=e(6), rescale=e(()),
        weight_acc=levels if pipeline._needs_window(cfg) else (),
        weight_count=e(()))
    depth = DepthMapState(
        idepth=e(plane), var=e(plane), idepth_smoothed=e(plane),
        var_smoothed=e(plane), validity=e(plane),
        blacklisted=e(plane, torch.int32), valid=e(plane, torch.bool))
    return pipeline.PipelineState(kf=kf, depth=depth, prev_wrt_kf=e(6),
                                  global_scale=e(()))


def save(path: str, state: pipeline.PipelineState,
         meta: Optional[Dict[str, Any]] = None) -> None:
    """Write ``state`` to ``<path>.npz`` (atomically) and ``meta`` to
    ``<path>.json``."""
    arrays = {k: v.detach().cpu().numpy() for k, v in flatten(state).items()}
    tmp = path + ".tmp.npz"
    np.savez(tmp, **arrays)
    os.replace(tmp, path + ".npz")
    if meta is not None:
        with open(path + ".json", "w") as f:
            json.dump(meta, f)


def load(path: str, cfg: ELLCConfig, device) -> pipeline.PipelineState:
    """Read a state written by :func:`save` onto ``device``; raises
    ValueError naming every field that is missing, unexpected, or of
    another shape or dtype than ``cfg`` gives."""
    want = flatten(template_pipeline_state(cfg))
    with np.load(path + ".npz") as z:
        got = {k: z[k] for k in z.files}
    errors = [f"missing {k}" for k in want if k not in got]
    errors += [f"unexpected {k}" for k in got if k not in want]
    for k, t in want.items():
        if k in got:
            a = torch.from_numpy(got[k])
            if tuple(a.shape) != tuple(t.shape) or a.dtype != t.dtype:
                errors.append(f"{k} is {a.dtype} {tuple(a.shape)}, expected "
                              f"{t.dtype} {tuple(t.shape)}")
    if errors:
        raise ValueError(f"{path}.npz does not hold this configuration's "
                         f"state: {'; '.join(errors)}")
    leaves = {k: torch.as_tensor(got[k], device=device) for k in want}
    return _unflatten(template_pipeline_state(cfg), leaves)


def load_meta(path: str) -> Dict[str, Any]:
    with open(path + ".json") as f:
        return json.load(f)


# ------------------------------------------------------- rolling snapshots

class CheckpointManager:
    """Snapshots ``directory/step_<N>``, the newest ``keep`` kept, with an
    atomically replaced ``latest`` pointer file."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)

    def _step_path(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step:09d}")

    def save(self, step: int, state: pipeline.PipelineState,
             meta: Optional[Dict[str, Any]] = None) -> str:
        meta = dict(meta or {})
        meta["step"] = step
        path = self._step_path(step)
        save(path, state, meta)
        tmp = os.path.join(self.directory, ".latest.tmp")
        with open(tmp, "w") as f:
            f.write(str(step))
        os.replace(tmp, os.path.join(self.directory, "latest"))
        self._gc()
        return path

    def all_steps(self):
        return sorted(int(n[len("step_"):-len(".npz")])
                      for n in os.listdir(self.directory)
                      if n.startswith("step_") and n.endswith(".npz"))

    def latest_step(self) -> Optional[int]:
        p = os.path.join(self.directory, "latest")
        if not os.path.exists(p):
            steps = self.all_steps()
            return steps[-1] if steps else None
        with open(p) as f:
            return int(f.read().strip())

    def restore(self, cfg: ELLCConfig, device, step: Optional[int] = None):
        """(state on ``device``, meta) of ``step``, by default the newest."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        path = self._step_path(step)
        return load(path, cfg, device), load_meta(path)

    def _gc(self) -> None:
        for s in self.all_steps()[:-self.keep] if self.keep > 0 else []:
            for ext in (".npz", ".json"):
                try:
                    os.remove(self._step_path(s) + ext)
                except FileNotFoundError:
                    pass


# ------------------------------------------------ reference text snapshots

def save_mat_text(mat: np.ndarray, frame_id: int, name: str,
                  directory: str) -> str:
    """saveMatAsText (Frame.cpp:698-734): one row per line, values
    space-separated with a trailing space, file ``<id>_<name>.txt``."""
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, f"{frame_id}_{name}.txt")
    a = np.asarray(mat, dtype=np.float32)
    with open(path, "w") as f:
        for row in a:
            f.write(" ".join(f"{v:g}" for v in row) + " \n")
    return path


def load_mat_text(frame_id: int, name: str, directory: str,
                  shape=None) -> np.ndarray:
    """makeMatFromText (Frame.cpp:737-795): read the whitespace grid back;
    ``shape`` optionally checks the dimensions, like the pre-allocated
    cv::Mat the reference fills."""
    path = os.path.join(directory, f"{frame_id}_{name}.txt")
    rows = []
    with open(path) as f:
        for line in f:
            vals = line.split()
            if vals:
                rows.append([float(v) for v in vals])
    a = np.asarray(rows, dtype=np.float32)
    if shape is not None and tuple(a.shape) != tuple(shape):
        raise ValueError(f"{path}: shape {a.shape} != expected {shape}")
    return a
