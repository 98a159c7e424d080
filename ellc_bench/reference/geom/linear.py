"""Small symmetric positive-definite solves (the 6x6 GN system).

Port of ``egomotion_with_local_loop_closures_tpu/geom/linear.py``.  The
JAX package unrolls the Cholesky factorization because a generic solve
is slow on a TPU.  Here ``torch.linalg.cholesky_ex`` factors and two
``torch.linalg.solve_triangular`` calls substitute, for one system or a
batch (V videos, B loop-window candidates) alike.  None of them
synchronizes with the host, so a CUDA graph can capture them
(``runtime/graphs.py``); a batched ``torch.cholesky_solve`` on CUDA
cannot be captured, since PyTorch routes it to MAGMA, which synchronizes
its queue with the host (``tools/probe_batched_solve.py``).  On CUDA,
cuSOLVER factors one matrix (potrf) and a batch (potrfBatched) with
different arithmetic, so one system is solved as a batch of two copies
of it: a video of a batched run then rounds its solve as its
single-video run does.  The contract is kept: the result is NaN where A
is not positive definite, so callers can gate on finiteness (the
zero-update guard of ``track/alignment.py::gn_level``).
"""

from __future__ import annotations

import torch


def solve_spd(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve A x = b for small SPD A (..., n, n); NaN where A is not
    positive definite."""
    n = A.shape[-1]
    if A.shape[:-2].numel() == 1:
        two = solve_spd(A.reshape(1, n, n).expand(2, n, n),
                        b.reshape(1, n).expand(2, n))
        return two[0].reshape(b.shape)
    L, info = torch.linalg.cholesky_ex(A)
    y = torch.linalg.solve_triangular(L, b.unsqueeze(-1), upper=False)
    x = torch.linalg.solve_triangular(L.mT, y, upper=True).squeeze(-1)
    return torch.where((info == 0)[..., None], x, float("nan"))
