"""Numerically-stable masked reductions.

(JAX counterpart: gmmvi_tpu/ops/stable.py)
"""
from __future__ import annotations

import math

import torch

NEG_INF = -math.inf
F32_MIN = torch.finfo(torch.float32).min
F32_MAX = torch.finfo(torch.float32).max


def _all_dims(a: torch.Tensor, dim):
    return tuple(range(a.ndim)) if dim is None else dim


def _identity(x: torch.Tensor) -> torch.Tensor:
    return x


def _amax(a: torch.Tensor, dims) -> torch.Tensor:
    """``torch.amax`` over ``dims`` (kept) that gives -inf over an empty
    slice (a mesh rank may hold no rows of ``dims``)."""
    dims = (dims,) if isinstance(dims, int) else tuple(dims)
    dims = tuple(d % a.ndim for d in dims)
    if any(a.shape[d] == 0 for d in dims):
        shape = [1 if i in dims else n for i, n in enumerate(a.shape)]
        return torch.full(shape, NEG_INF, dtype=a.dtype, device=a.device)
    return torch.amax(a, dim=dims, keepdim=True)


def masked_logsumexp(a: torch.Tensor, mask=None, dim=None,
                     keepdim: bool = False, combine_max=_identity,
                     combine_sum=_identity) -> torch.Tensor:
    """logsumexp over ``dim`` treating entries with ``mask == False`` as
    -inf; an entirely masked slice gives -inf.  ``combine_max`` and
    ``combine_sum`` join the partial max and the partial sum of
    exponentials (kept dims) with those of the other blocks of ``dim``
    (``parallel.reduce.data_max`` and ``data_sum`` over a mesh's ranks)."""
    if mask is not None:
        a = torch.where(mask, a, NEG_INF)
    dims = _all_dims(a, dim)
    amax = combine_max(_amax(a, dims))
    amax_safe = torch.where(torch.isfinite(amax), amax, 0.0)
    expd = torch.exp(a - amax_safe)
    if mask is not None:
        expd = torch.where(mask, expd, 0.0)
    s = combine_sum(torch.sum(expd, dim=dims, keepdim=True))
    out = torch.log(torch.clamp(s, min=0.0)) + amax_safe
    out = torch.where(s > 0, out, NEG_INF)
    if not keepdim:
        out = out.squeeze(dims) if dim is not None else out.reshape(())
    return out


def signed_weighted_logsumexp(log_w: torch.Tensor, values: torch.Tensor,
                              dim: int = 0, mask=None,
                              combine_max=_identity, combine_sum=_identity
                              ) -> torch.Tensor:
    """``sum_i exp(log_w_i) * values_i`` computed stably in log space;
    entries where ``mask`` is False (or ``values == 0``) contribute
    nothing.  ``combine_max`` and ``combine_sum`` as in
    :func:`masked_logsumexp`."""
    log_abs = torch.log(torch.abs(values))
    combined = log_w + log_abs
    valid = torch.isfinite(combined)
    if mask is not None:
        valid = valid & mask
    combined = torch.where(valid, combined, NEG_INF)
    cmax = combine_max(_amax(combined, dim))
    cmax_safe = torch.where(torch.isfinite(cmax), cmax, 0.0)
    signs = torch.sign(values)
    total = combine_sum(torch.sum(
        torch.where(valid, signs * torch.exp(combined - cmax_safe), 0.0),
        dim=dim, keepdim=True))
    out = torch.sign(total) * torch.exp(torch.log(torch.abs(total))
                                        + cmax_safe)
    return out.squeeze(dim)


def masked_softmax(logits: torch.Tensor, mask=None, dim: int = -1
                   ) -> torch.Tensor:
    """Softmax with masked entries receiving probability zero."""
    lse = masked_logsumexp(logits, mask=mask, dim=dim, keepdim=True)
    p = torch.exp(logits - torch.where(torch.isfinite(lse), lse, 0.0))
    if mask is not None:
        p = torch.where(mask, p, 0.0)
    return p
