"""Intensity histograms + KL-divergence comparison for loop detection.

Port of ``egomotion_with_local_loop_closures_tpu/loop/histogram.py``
(``globalOptimize::calculateImageHistogram`` / ``compareImageHistogram``,
``src/GlobalOptimize.cpp:40-122``): a 256-bin histogram over [0, 256)
normalized to sum 1, compared with OpenCV's ``CV_COMP_KL_DIV`` semantics
(bins where p == 0 contribute 0; q is clamped to 1e-10).
"""

from __future__ import annotations

import torch


def image_histogram(image: torch.Tensor, bins: int = 256) -> torch.Tensor:
    """Normalized intensity histogram of a [0, 255] float image.  The bins
    are integer counts of the truncated, clipped intensities, so the
    result does not depend on the order in which the card adds them.  An
    integer scatter-add counts them: ``torch.bincount`` would read the
    input's range back to the host to size its output."""
    idx = torch.clamp(image.to(torch.int32), 0, bins - 1).reshape(-1).long()
    h = torch.zeros(bins, dtype=torch.int64, device=image.device).index_add_(
        0, idx, torch.ones_like(idx)).to(torch.float32)
    return h / torch.clamp_min(h.sum(), 1.0)


def kl_divergence(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """OpenCV CV_COMP_KL_DIV: sum_i p_i log(p_i / max(q_i, 1e-10)),
    skipping bins with p_i == 0.  Takes leading batch dimensions."""
    q_safe = torch.clamp_min(q, 1e-10)
    pos = p > 0
    terms = torch.where(pos, p * torch.log(torch.where(pos, p, 1.0) / q_safe),
                        0.0)
    return torch.sum(terms, dim=-1)


def kl_divergence_batched(ps: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """KL(p_i || q) for a stack of p histograms (N, B) against one q."""
    return kl_divergence(ps, q[None, :])
