"""Small symmetric positive-definite solves (the 6x6 GN system).

Port of ``egomotion_with_local_loop_closures_tpu/geom/linear.py``.  The
JAX package unrolls the Cholesky factorization because a generic solve
is slow on a TPU.  Here ``torch.linalg.cholesky_ex`` factors without
synchronizing with the host, and the contract is kept: the result is NaN
where A is not positive definite, so callers can gate on finiteness
(the zero-update guard of ``track/alignment.py::gn_level``).
"""

from __future__ import annotations

import torch


def solve_spd(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve A x = b for small SPD A (..., n, n); NaN where A is not
    positive definite."""
    L, info = torch.linalg.cholesky_ex(A)
    x = torch.cholesky_solve(b.unsqueeze(-1), L).squeeze(-1)
    return torch.where((info == 0)[..., None], x, float("nan"))
