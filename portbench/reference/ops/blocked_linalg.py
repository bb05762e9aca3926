"""Triangular inverse.

(JAX counterpart: gmmvi_tpu/ops/blocked_linalg.py, the ``tril_inverse``
contract only; its matmul-only inverse and blocked Cholesky work around the
TPU's XLA lowering and have no counterpart here.)
"""
from __future__ import annotations

import torch


def tril_inverse(l: torch.Tensor) -> torch.Tensor:
    """Explicit inverse of a (batched) lower-triangular matrix.  A singular
    or NaN factor gives non-finite entries, never an exception.  The result
    is row-major (the solver's own is column-major), the layout the density
    kernels take."""
    eye = torch.eye(l.shape[-1], dtype=l.dtype, device=l.device)
    return torch.linalg.solve_triangular(l, eye.expand(l.shape),
                                         upper=False).contiguous()
