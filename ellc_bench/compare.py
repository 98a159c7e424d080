"""The numbers that decide ``correct``: gaps between what the timed path
produced and what the plain reference (``ellc_bench/reference``) computes
from the same frames.  Every gap is taken for each video (the leading
axis) apart, a larger gap is worse, and a gap that is not finite reads as
infinite.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def _tensor(x) -> torch.Tensor:
    return (x if isinstance(x, torch.Tensor)
            else torch.from_numpy(np.asarray(x))).double()


def _per_video(gap: torch.Tensor) -> np.ndarray:
    """The widest of each video's gaps, infinite where one is not
    finite."""
    gap = gap.reshape(gap.shape[0], -1)
    gap = torch.where(torch.isfinite(gap), gap, torch.inf)
    if gap.shape[1] == 0:
        return np.zeros(gap.shape[0])
    return gap.amax(1).cpu().numpy()


def _pair(got, want) -> Tuple[torch.Tensor, torch.Tensor]:
    got, want = _tensor(got), _tensor(want)
    if got.shape != want.shape:
        raise ValueError(f"shapes differ: {tuple(got.shape)} and "
                         f"{tuple(want.shape)}")
    return got, want.to(got.device)


def value_gaps(got, want) -> np.ndarray:
    """Each video's widest absolute gap between two arrays (V, ...): twist
    components of poses (rad or scene units), image values, seeds."""
    got, want = _pair(got, want)
    return _per_video((got - want).abs())


def ratio_gaps(got, want) -> np.ndarray:
    """Each video's widest relative gap |got / want - 1|."""
    got, want = _pair(got, want)
    return _per_video((got - want).abs() / want.abs().clamp_min(1e-12))


def masked_gaps(got, want, got_valid, want_valid
                ) -> Tuple[np.ndarray, np.ndarray]:
    """Two gaps between each video's maps (V, ...) that hold a value only
    where their masks are set: the mean |gap| over the cells set in both,
    relative to the reference's mean |value| there; and the share of
    cells set in one map and not in the other."""
    got, want = _pair(got, want)
    got_valid, want_valid = got_valid.to(got.device), want_valid.to(
        got.device)
    both = got_valid & want_valid
    dims = tuple(range(1, got.dim()))
    diff = torch.where(both, (got - want).abs(), 0.0).sum(dims)
    scale = torch.where(both, want.abs(), 0.0).sum(dims)
    rel = diff / scale.clamp_min(1e-12)
    flip = (got_valid != want_valid).double().mean(dims)
    return _per_video(rel[:, None]), _per_video(flip[:, None])


def changed_share(got, want) -> np.ndarray:
    """Each video's share of cells whose values differ at all (counters,
    flags)."""
    got, want = _pair(got, want)
    return _per_video((got != want).double().mean(
        tuple(range(1, got.dim())))[:, None])


def worst_video(entries) -> float:
    """The largest of one stage's entries, one a video."""
    x = np.asarray(entries, np.float64).reshape(-1)
    return float(x.max()) if x.size else 0.0


def worst_video_median(entries) -> float:
    """Each video's median over its stages (the upper of the two middle
    entries), the largest over the videos: ``entries`` (stages, videos).
    A fault in one video's every stage shows whole, and one stage of one
    video that a chaotic step throws far does not."""
    x = np.sort(np.asarray(entries, np.float64), axis=0)
    if x.size == 0:
        return 0.0
    return float(x[x.shape[0] // 2].max())
