"""The bytes and float32 operations of the port's kernels, copied from the
counts that ``chip_smoke.py`` and ``tools/time_k1_levels.py`` use:

- K1 (``gn_level_cluster`` and ``gn_step``, one align): a launch that reads
  a level's planes reads them once, the keyframe's image, depth and
  variance and the current image and its two gradients, 4 B each a pixel;
  a level in one cluster launch reads them once, a level of one launch an
  iteration once a live iteration; per video the pose, the update and 11
  scalars; ``K1_OPS_PIXEL`` operations a template pixel a live iteration;
- K2 (``stereo_observe``, one call): 70 B a pixel (the state's five float
  planes, int32 and bool read and written, the keyframe's image, gradients
  and max gradient and the current image), 32 B a video (the pose and two
  counts); ``K2_OPS_PIXEL`` operations for every pixel's gates, a lower
  bound of the operations, which depend on the data.
"""

from __future__ import annotations

from typing import Sequence, Tuple

# K1: levels of at most this many template pixels run one cluster launch
# (ops/gn_kernel.py CLUSTER_MAX_PIXELS); 220 float32 operations a template
# pixel a live iteration (gn_kernel.OPS_PER_PIXEL)
K1_CLUSTER_MAX_PIXELS = 10_000
K1_OPS_PIXEL = 220
K1_BYTES_VIDEO_LEVEL = (6 + 6 + 11) * 4

K2_BYTES_PIXEL, K2_BYTES_VIDEO = 25 + 20 + 25, 24 + 8
K2_OPS_PIXEL = 32


def level_shapes(rows: int, cols: int, levels: int) -> Tuple[Tuple[int, int], ...]:
    """The pyramid's (rows, cols) at each level (floor division)."""
    return tuple((rows >> l, cols >> l) for l in range(levels))


def align_work(rows: int, cols: int, levels: int, videos: int = 1,
               live_iters: Sequence[int] = None) -> Tuple[int, int]:
    """(bytes, float32 operations) of one align of ``videos`` videos.
    ``live_iters``: the live iterations at each level (finest first); None
    counts one at every level, the least an align can do, so that each
    level's planes count once."""
    shapes = level_shapes(rows, cols, levels)
    if live_iters is None:
        live_iters = [1] * levels
    nbytes = ops = 0
    for (h, w), it in zip(shapes, live_iters):
        reads = 1 if h * w <= K1_CLUSTER_MAX_PIXELS else max(it, 1)
        nbytes += videos * (reads * (3 * h * w + 3 * h * w) * 4
                            + K1_BYTES_VIDEO_LEVEL)
        ops += videos * it * h * w * K1_OPS_PIXEL
    return nbytes, ops


def stereo_work(rows: int, cols: int, videos: int = 1) -> Tuple[int, int]:
    """(bytes, float32 operations) of one K2 call over ``videos`` videos."""
    n_px = rows * cols * videos
    return (K2_BYTES_PIXEL * n_px + K2_BYTES_VIDEO * videos,
            K2_OPS_PIXEL * n_px)
