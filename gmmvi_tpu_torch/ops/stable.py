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


def masked_logsumexp(a: torch.Tensor, mask=None, dim=None,
                     keepdim: bool = False) -> torch.Tensor:
    """logsumexp over ``dim`` treating entries with ``mask == False`` as
    -inf; an entirely masked slice gives -inf."""
    if mask is not None:
        a = torch.where(mask, a, NEG_INF)
    dims = _all_dims(a, dim)
    amax = torch.amax(a, dim=dims, keepdim=True)
    amax_safe = torch.where(torch.isfinite(amax), amax, 0.0)
    expd = torch.exp(a - amax_safe)
    if mask is not None:
        expd = torch.where(mask, expd, 0.0)
    s = torch.sum(expd, dim=dims, keepdim=True)
    out = torch.log(torch.clamp(s, min=0.0)) + amax_safe
    out = torch.where(s > 0, out, NEG_INF)
    if not keepdim:
        out = out.squeeze(dims) if dim is not None else out.reshape(())
    return out


def signed_weighted_logsumexp(log_w: torch.Tensor, values: torch.Tensor,
                              dim: int = 0, mask=None) -> torch.Tensor:
    """``sum_i exp(log_w_i) * values_i`` computed stably in log space;
    entries where ``mask`` is False (or ``values == 0``) contribute
    nothing."""
    log_abs = torch.log(torch.abs(values))
    combined = log_w + log_abs
    valid = torch.isfinite(combined)
    if mask is not None:
        valid = valid & mask
    combined = torch.where(valid, combined, NEG_INF)
    cmax = torch.amax(combined, dim=dim, keepdim=True)
    cmax_safe = torch.where(torch.isfinite(cmax), cmax, 0.0)
    signs = torch.sign(values)
    total = torch.sum(
        torch.where(valid, signs * torch.exp(combined - cmax_safe), 0.0),
        dim=dim, keepdim=True)
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
