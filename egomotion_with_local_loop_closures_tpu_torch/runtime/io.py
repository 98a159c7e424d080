"""Pose-file IO in the reference's text formats, plus the video and
image-directory frame sources.

A copy of ``PoseWriter``, ``read_pose_file``, ``video_frames`` and
``image_dir_frames`` from
``egomotion_with_local_loop_closures_tpu/runtime/io.py`` (numpy only; the
JAX package's ``runtime/__init__.py`` imports jax, so the port cannot
import the original).  The output is byte-identical to the original's.

Formats (reference README.md:83-88, main.cpp:361-384):

- ``poses_orig.txt``: ``frameId kfId wx wy wz vx vy vz rescale seeds%``
  with the world pose (w.r.t. frame 1).
- ``matchframes.txt``: same prefix but the pose w.r.t. the keyframe, plus
  three trailing zeros.
"""

from __future__ import annotations

import os
from typing import Iterator, List, Optional, Sequence

import numpy as np


class PoseWriter:
    """Streams pose lines in the reference format."""

    def __init__(self, path: str, kind: str = "orig"):
        self.path = path
        self.kind = kind
        parent = os.path.dirname(path)
        if parent:
            os.makedirs(parent, exist_ok=True)
        self._f = open(path, "w")

    def write(self, frame_id: int, kf_id: int, pose: Sequence[float],
              rescale: float, seeds: float,
              extras: Optional[Sequence[float]] = None) -> None:
        p = [float(v) for v in pose]
        line = (f"{frame_id} {kf_id} "
                + " ".join(f"{v:.9g}" for v in p)
                + f" {float(rescale):.9g} {float(seeds):.9g}")
        if self.kind == "match":
            ex = extras if extras is not None else (0.0, 0.0, 0.0)
            line += " " + " ".join(f"{float(v):.9g}" for v in ex)
        self._f.write(line + "\n")
        self._f.flush()

    def close(self) -> None:
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()


def read_pose_file(path: str) -> np.ndarray:
    """Read any of the pose/match formats into an (N, C) float array."""
    rows: List[List[float]] = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                rows.append([float(v) for v in line.split()])
    return np.asarray(rows, dtype=np.float64)


def video_frames(path: str, gray: bool = True, resize_factor: float = 0.25,
                 skip: int = 0, max_frames: Optional[int] = None
                 ) -> Iterator[np.ndarray]:
    """Decode a video file with OpenCV (imported on first use) the way the
    reference prepares a frame: resize by ``resize_factor`` (1920x1080 ->
    480x270, src/ExternVariable.h:50-51, Frame.cpp:60-66) and BGR -> gray
    (Frame.cpp:83).  ``skip`` grabs and discards frames first, as
    main.cpp:156-166 does to reach a batch's start.

    Yields float32 (H, W) arrays in [0, 255]."""
    import cv2

    cap = cv2.VideoCapture(path)
    if not cap.isOpened():
        raise FileNotFoundError(f"cannot open video: {path}")
    try:
        for _ in range(skip):
            if not cap.grab():
                return
        n = 0
        while max_frames is None or n < max_frames:
            ok, frame = cap.read()
            if not ok:
                return
            if resize_factor != 1.0:
                frame = cv2.resize(frame, None, fx=resize_factor,
                                   fy=resize_factor,
                                   interpolation=cv2.INTER_LINEAR)
            if gray and frame.ndim == 3:
                frame = cv2.cvtColor(frame, cv2.COLOR_BGR2GRAY)
            yield np.asarray(frame, dtype=np.float32)
            n += 1
    finally:
        cap.release()


def image_dir_frames(path: str, gray: bool = True
                     ) -> Iterator[np.ndarray]:
    """Iterate frames from a directory of images sorted by filename, as
    float32 (H, W) arrays.  PIL is imported on first use."""
    from PIL import Image

    names = sorted(n for n in os.listdir(path)
                   if n.lower().endswith((".jpg", ".jpeg", ".png", ".pgm",
                                          ".ppm", ".bmp")))
    for n in names:
        img = Image.open(os.path.join(path, n))
        if gray:
            img = img.convert("L")
        yield np.asarray(img, dtype=np.float32)
