"""Whitened importance-weighted ridge regression of a quadratic surrogate.

(JAX counterpart: gmmvi_tpu/ops/quadratic.py)

Fit ``R(x) = x^T Q x + x^T r + r0`` by weighted least squares on quadratic
features of the samples whitened by the sampling Gaussian, with an
unregularized bias: the normal equations ``(X^T W X + reg) theta = X^T W y``
are solved by Cholesky and the coefficients unwhitened.  These are the small
solves around the MORE Gram kernel (B8, ``ops/more.py``); they stay plain
PyTorch.  :func:`solve_quadratic_normal_eqs` also takes a leading batch of
components.  :func:`fit_linear` is the reference's linear fit (``LinFunc``).
A diagonal sampling Gaussian (``sample_inv_chol`` ``[..., D]``,
the reciprocals of its standard deviations, with ``diagonal=True``) whitens
and unwhitens elementwise; the fit is the full quadratic all the same, as
in the JAX package.
"""
from __future__ import annotations

from typing import Tuple

import torch


def triu_indices(dim: int, device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Row-major upper-triangle indices (i <= j), as ``jnp.triu_indices``."""
    iu = torch.triu_indices(dim, dim, device=device)
    return iu[0], iu[1]


def fit_linear(regularizer, inputs: torch.Tensor, outputs: torch.Tensor,
               weights: torch.Tensor = None,
               mask: torch.Tensor = None) -> torch.Tensor:
    """Weighted ridge regression of a linear model with a bias: ``[D + 1]``
    coefficients, the bias last and not regularized (the reference's
    ``LinFunc``), solved in the inputs' float type."""
    n, d = inputs.shape
    feats = torch.cat([inputs, torch.ones((n, 1), dtype=inputs.dtype,
                                          device=inputs.device)], dim=1)
    if weights is None:
        weights = torch.ones(n, dtype=inputs.dtype, device=inputs.device)
    if mask is not None:
        weights = torch.where(mask, weights, 0.0)
    wf = weights[:, None] * feats
    reg = regularizer * torch.eye(d + 1, dtype=inputs.dtype,
                                  device=inputs.device)
    reg[d, d] = 0.0
    return torch.linalg.solve(wf.mT @ feats + reg, wf.mT @ outputs)


def num_features(dim: int) -> int:
    return 1 + dim + dim * (dim + 1) // 2


def quadratic_features(x: torch.Tensor) -> torch.Tensor:
    """Features ``[x_i x_j (i <= j, row by row), x, 1]``, ``[N, F]``."""
    n, d = x.shape
    iu, ju = triu_indices(d, x.device)
    outer = (x[:, :, None] * x[:, None, :]).reshape(n, d * d)
    quad = outer[:, iu * d + ju]
    return torch.cat([quad, x, torch.ones((n, 1), dtype=x.dtype,
                                          device=x.device)], dim=1)


def whiten(inputs: torch.Tensor, sample_mean: torch.Tensor,
           sample_inv_chol: torch.Tensor) -> torch.Tensor:
    """``z = L^{-1}(x - mu)`` for samples ``[N, D]``; elementwise for a
    diagonal ``sample_inv_chol`` ``[D]``."""
    if sample_inv_chol.ndim == 1:
        return (inputs - sample_mean) * sample_inv_chol[None, :]
    return torch.einsum("ij,nj->ni", sample_inv_chol, inputs - sample_mean)


def weighted_normal_eqs(z: torch.Tensor, outputs: torch.Tensor,
                        weights: torch.Tensor):
    """``(X^T W X [F, F], X^T W y [F])`` over the quadratic features of
    ``z``."""
    feats = quadratic_features(z)
    wf = weights[:, None] * feats
    return wf.mT @ feats, wf.mT @ outputs


def _cholesky_or_nan(a: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor; NaN where ``a`` is not positive definite (as
    ``jnp.linalg.cholesky`` gives)."""
    chol, info = torch.linalg.cholesky_ex(a)
    return torch.where((info != 0)[..., None, None], torch.nan, chol)


def solve_quadratic_normal_eqs(gram: torch.Tensor, rhs: torch.Tensor,
                               regularizer, sample_mean: torch.Tensor,
                               sample_inv_chol: torch.Tensor,
                               diagonal: bool = False):
    """Solve and unwhiten, given the weighted normal equations over the
    whitened quadratic features: ``gram [..., F, F]``, ``rhs [..., F]``,
    ``regularizer`` a scalar or ``[...]``.  Returns ``(quad_term [..., D,
    D], lin_term [..., D], const_term [...])`` in the original coordinates,
    with ``quad_term = -(qt + qt^T)`` for the fitted upper triangle qt."""
    f = gram.shape[-1]
    d = sample_mean.shape[-1]
    eye = torch.eye(f, dtype=gram.dtype, device=gram.device)
    eye[f - 1, f - 1] = 0.0                  # bias unregularized
    reg = torch.as_tensor(regularizer, dtype=gram.dtype, device=gram.device)
    chol = _cholesky_or_nan(gram + reg[..., None, None] * eye)
    params = torch.cholesky_solve(rhs[..., None], chol)[..., 0]

    iu, ju = triu_indices(d, gram.device)
    qt = torch.zeros(params.shape[:-1] + (d, d), dtype=gram.dtype,
                     device=gram.device)
    qt[..., iu, ju] = params[..., : f - (d + 1)]
    quad_term = -qt - qt.mT
    lin_term = params[..., f - (d + 1): f - 1]
    const_term = params[..., f - 1]

    a = sample_inv_chol
    if diagonal:
        quad_w = a[..., :, None] * quad_term * a[..., None, :]
        t1 = a * lin_term
    else:
        quad_w = torch.einsum("...ji,...jk,...kl->...il", a, quad_term, a)
        t1 = torch.einsum("...ji,...j->...i", a, lin_term)
    t2 = torch.einsum("...ij,...j->...i", quad_w, sample_mean)
    lin_w = t1 + t2
    const_w = const_term + torch.sum(sample_mean * (-0.5 * t2 - t1), dim=-1)
    return quad_w, lin_w, const_w


def fit_quadratic(regularizer, inputs: torch.Tensor, outputs: torch.Tensor,
                  weights: torch.Tensor, sample_mean: torch.Tensor,
                  sample_inv_chol: torch.Tensor, mask=None,
                  diagonal: bool = False):
    """One component's fit from samples ``[N, D]``, outputs and weights
    ``[N]``; entries where ``mask`` is False are ignored.  Returns
    ``(quad_term, lin_term, const_term)`` as
    :func:`solve_quadratic_normal_eqs`."""
    if mask is not None:
        weights = torch.where(mask, weights, 0.0)
    gram, rhs = weighted_normal_eqs(
        whiten(inputs, sample_mean, sample_inv_chol), outputs, weights)
    return solve_quadratic_normal_eqs(gram, rhs, regularizer, sample_mean,
                                      sample_inv_chol, diagonal)
