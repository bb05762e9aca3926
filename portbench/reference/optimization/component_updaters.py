"""Natural-gradient component updates: direct (codename letter I), iBLR
(Y) and the KL trust-region update (T).

(JAX counterpart: gmmvi_tpu/optimization/component_updaters.py,
``direct_update``, ``iblr_update``, the full-covariance bracket path
``_trust_region_update_pallas`` and, for diagonal models, the vmapped
``_tr_update_one`` with ``_tr_kl_diag``)

The direct and iBLR updates take one step in precision space at the
component's stepsize and rebuild the factors from one Cholesky of the
flipped precision; a component whose new precision is not positive
definite keeps its parameters.  In the trust-region update every
component's stepsize eta is found by the reference's log-space
bisection.  For D <= 64 the whole search is one call of
:func:`portbench.reference.ops.trust_region.tr_search` (kernel B3 on the card,
one block per component running its own bracket to its end, no host
sync).  Above 64 the search runs as a host loop
(:func:`~portbench.reference.ops.trust_region.bracket_search`) in lockstep
over the padded component axis, one "all done" flag read per trip, each
trip one evaluation of the JAX package's whitened KL in plain torch (the
JAX package keeps that one in XLA: ``_tr_whitened_precompute`` and
``_tr_kl_whitened_trip``, selected where its kernel's envelope ends).  The
accepted update is rebuilt at the found eta from one Cholesky of the
flipped precision.  Failures are success masks: a failed component keeps
its parameters.  A diagonal model's updates are elementwise, and its
search runs the same host loop around the elementwise KL
(:func:`_tr_kl_diag`).

The other searches of ``tpu.trust_region_search`` are the JAX package's
vmapped XLA routes, in plain torch batched over the slots: ``newton``
(full covariances at every D; :func:`~portbench.reference.ops.trust_region.
newton_search` around the whitened KL and its slope in log eta,
:func:`_tr_kl_whitened_grad`, cold-started at the asymptotic root),
``grid`` (two batched passes of ``grid_size`` log-spaced etas around the
direct KL, or the diagonal one; the smallest feasible eta) and
``bracket-eigen`` (the bracket around the KL in the eigenbasis of the
whitened curvature, elementwise per trip, and its own rebuild).  A
diagonal model takes the bracket for ``newton`` and ``bracket-eigen``, as
in the JAX package.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from portbench.reference.models.gmm import GmmState, replace_components
from portbench.reference.models.meta import MetaState
from portbench.reference.ops.blocked_linalg import tril_inverse
from portbench.reference.ops.stable import F32_MAX
from portbench.reference.ops.trust_region import MAX_D as TR_KERNEL_MAX_D
from portbench.reference.ops.trust_region import (bracket_search, grid_search,
                                              newton_search,
                                              prepare_tr_kl_inputs, tr_search)

SEARCHES = ("bracket", "newton", "grid", "bracket-eigen")


class ComponentUpdateResult(NamedTuple):
    model: GmmState
    meta: MetaState


def _finish_update(model, meta, new_means, new_chols, successes, etas=None,
                   new_inv_chols=None) -> ComponentUpdateResult:
    """l2-regularizer adaptation (halve on success, floored at the initial
    value; x10 capped at 1e-6 on failure), update counters, parameters."""
    mask = model.mask
    new_l2 = torch.where(
        successes,
        torch.clamp(0.5 * meta.l2_regularizers, min=meta.initial_regularizer),
        torch.clamp(10.0 * meta.l2_regularizers, max=1e-6))
    meta = meta.replace(
        l2_regularizers=torch.where(mask, new_l2, meta.l2_regularizers),
        num_received_updates=meta.num_received_updates + mask.to(
            torch.float32))
    if etas is not None:
        meta = meta.replace(last_etas=torch.where(mask, etas,
                                                  meta.last_etas))
    model = replace_components(model, new_means, new_chols,
                               new_inv_chols=new_inv_chols)
    return ComponentUpdateResult(model, meta)


def _cholesky_or_nan(a: torch.Tensor) -> torch.Tensor:
    """Batched lower Cholesky factor; NaN where ``a`` is not positive
    definite (the rejection signal the updaters test for)."""
    l, info = torch.linalg.cholesky_ex(a)
    return torch.where((info != 0)[..., None, None], torch.nan, l)


def _chol_pair_from_prec(new_prec: torch.Tensor):
    """Lower Cholesky factor of ``inv(new_prec)`` and its inverse from one
    Cholesky: with ``Lt = chol(flip(P))``, ``chol(P^-1) = flip(Lt^-T)`` and
    its inverse is ``flip(Lt^T)``.  NaN in both where ``new_prec`` is not
    positive definite.  ``P`` is symmetrized first, as
    ``jnp.linalg.cholesky`` does (exact on a symmetric ``P``; the Hessian of
    the standard-IW Stein estimate is not symmetric)."""
    lt = _cholesky_or_nan(0.5 * (new_prec + new_prec.mT).flip(-2, -1))
    new_chol = tril_inverse(lt).mT.flip(-2, -1)
    new_inv_chol = lt.mT.flip(-2, -1)
    return new_chol, new_inv_chol


def _old_canonical(model: GmmState):
    """Precisions ``L^-T L^-1`` and linear terms ``Lam mu`` of the
    components, from the cached inverse factors (elementwise for a
    diagonal model)."""
    if model.diagonal:
        old_prec = torch.square(model.inv_chols)
        return old_prec, old_prec * model.means
    old_prec = torch.einsum("kji,kjl->kil", model.inv_chols, model.inv_chols)
    return old_prec, torch.einsum("kij,kj->ki", old_prec, model.means)


def _select_update(model: GmmState, success, new_means, new_chols,
                   new_inv_chols):
    """The new parameters where ``success`` and active, else the old."""
    sel = success & model.mask
    return (torch.where(sel[:, None], new_means, model.means),
            torch.where(sel[:, None, None], new_chols, model.chols),
            torch.where(sel[:, None, None], new_inv_chols, model.inv_chols))


def direct_update(model: GmmState, meta: MetaState,
                  hessians_neg: torch.Tensor, grads_neg: torch.Tensor,
                  stepsizes: torch.Tensor, temperature: float = 1.0
                  ) -> ComponentUpdateResult:
    """A natural-gradient step in precision space, ``P' = P + s H`` and
    ``P' mu' = P mu + s (H mu - g)``; the mean is solved with the new
    factors, ``mu' = L' L'^T (P' mu')``.  A component fails where the new
    factor or mean has a NaN."""
    old_prec, old_lin = _old_canonical(model)
    s = stepsizes
    if model.diagonal:
        delta_lin = hessians_neg * model.means - grads_neg
        new_prec = old_prec + s[:, None] * hessians_neg
        new_lin = old_lin + s[:, None] * delta_lin
        new_chol = torch.sqrt(1.0 / new_prec)
        return _finish_diag(model, meta, torch.isnan(new_chol).any(dim=-1),
                            new_lin / new_prec, new_chol)
    delta_lin = torch.einsum("kij,kj->ki", hessians_neg, model.means) \
        - grads_neg
    new_prec = old_prec + s[:, None, None] * hessians_neg
    new_lin = old_lin + s[:, None] * delta_lin
    new_chol, new_inv_chol = _chol_pair_from_prec(new_prec)
    new_mean = torch.einsum("kij,kj->ki", new_chol,
                            torch.einsum("kji,kj->ki", new_chol, new_lin))
    success = ~(torch.isnan(new_chol).any(dim=(-2, -1))
                | torch.isnan(new_mean).any(dim=-1))
    means, chols, inv_chols = _select_update(model, success, new_mean,
                                             new_chol, new_inv_chol)
    return _finish_update(model, meta, means, chols, success,
                          new_inv_chols=inv_chols)


def iblr_update(model: GmmState, meta: MetaState,
                hessians_neg: torch.Tensor, grads_neg: torch.Tensor,
                stepsizes: torch.Tensor, temperature: float = 1.0
                ) -> ComponentUpdateResult:
    """The improved Bayesian learning rule: ``P' = P + s (H + s/2 H Sigma
    H)`` (the curvature correction keeps ``P'`` positive definite) and
    ``mu' = mu - s Sigma g``, with no mean step on a component's first
    update.  A component fails where the new factor has a NaN."""
    old_prec, _ = _old_canonical(model)
    s = stepsizes
    first = meta.num_received_updates == 0
    if model.diagonal:
        cov = torch.square(model.chols)
        correction = 0.5 * s[:, None] * hessians_neg * cov * hessians_neg
        new_prec = old_prec + s[:, None] * (hessians_neg + correction)
        mean_step = s[:, None] * cov * (-grads_neg)
        new_mean = torch.where(first[:, None], model.means,
                               model.means + mean_step)
        new_chol = torch.sqrt(1.0 / new_prec)
        return _finish_diag(model, meta, torch.isnan(new_chol).any(dim=-1),
                            new_mean, new_chol)
    cov = model.chols @ model.chols.mT
    correction = 0.5 * s[:, None, None] * (hessians_neg @ cov
                                           @ hessians_neg)
    new_prec = old_prec + s[:, None, None] * (hessians_neg + correction)
    mean_step = s[:, None] * torch.einsum("kij,kj->ki", cov, -grads_neg)
    new_mean = torch.where(first[:, None], model.means,
                           model.means + mean_step)
    new_chol, new_inv_chol = _chol_pair_from_prec(new_prec)
    success = ~torch.isnan(new_chol).any(dim=(-2, -1))
    means, chols, inv_chols = _select_update(model, success, new_mean,
                                             new_chol, new_inv_chol)
    return _finish_update(model, meta, means, chols, success,
                          new_inv_chols=inv_chols)


def _finish_diag(model: GmmState, meta: MetaState, failed: torch.Tensor,
                 new_mean: torch.Tensor, new_chol: torch.Tensor
                 ) -> ComponentUpdateResult:
    """A diagonal direct or iBLR step's end: the new mean and factor where
    it succeeded (``failed`` False) and the slot is active, the inverse
    factors made anew from the kept ones, as in the JAX package."""
    success = ~failed
    sel = (success & model.mask)[:, None]
    return _finish_update(model, meta,
                          torch.where(sel, new_mean, model.means),
                          torch.where(sel, new_chol, model.chols), success)


def _tr_final_full(eta, old_lin, old_prec, old_inv_chol, reward_lin,
                   reward_quad, kl_const, old_mean):
    """KL and updated parameters at the accepted ``eta`` [K]; returns
    ``(kl, new_mean, new_chol, new_inv_chol)`` with the old mean and
    identity factors where the new precision is not positive definite."""
    d = old_mean.shape[-1]
    e2, e3 = eta[:, None], eta[:, None, None]
    new_lin = (e2 * old_lin + reward_lin) / e2
    new_prec = (e3 * old_prec + reward_quad) / e3
    new_chol, new_inv_chol = _chol_pair_from_prec(new_prec)
    bad = torch.isnan(new_chol).any(dim=(-2, -1))
    eye = torch.eye(d, dtype=new_chol.dtype, device=new_chol.device)
    chol_safe = torch.where(bad[:, None, None], eye, new_chol)
    inv_safe = torch.where(bad[:, None, None], eye, new_inv_chol)
    new_mean = torch.einsum("kij,kj->ki", chol_safe,
                            torch.einsum("kji,kj->ki", chol_safe, new_lin))
    new_logdet = 2.0 * torch.sum(
        torch.log(torch.diagonal(chol_safe, dim1=-2, dim2=-1)), -1)
    trace_term = torch.sum(torch.square(old_inv_chol @ chol_safe),
                           dim=(-2, -1))
    od = torch.einsum("kij,kj->ki", old_inv_chol, old_mean - new_mean)
    kl = 0.5 * (kl_const - new_logdet + trace_term + torch.sum(od * od, -1))
    kl = torch.where(bad, F32_MAX, kl)
    new_mean = torch.where(bad[:, None], old_mean, new_mean)
    return kl, new_mean, chol_safe, inv_safe


def _tr_whitened_precompute(means, chols, inv_chols, reward_lin,
                            reward_quad):
    """Once per step: the whitened curvature ``M = L^T R L``, ``c = L^{-1}
    mu_old`` and ``b1 = L^T r_lin`` with ``Sigma_old = L L^T``.  The
    interpolated precision then factors as ``L^{-T} (I + M/eta) L^{-1}``, so
    a trip needs the Cholesky of ``S = I + M/eta`` and one triangular
    inverse, and the KL is the direct one in exact arithmetic (not in
    float32: near the bound the two forms can pick different etas, so the
    port takes the JAX package's)."""
    m_w = chols.mT @ reward_quad @ chols
    c = torch.einsum("kij,kj->ki", inv_chols, means)
    b1 = torch.einsum("kji,kj->ki", chols, reward_lin)
    return m_w, c, b1


def _tr_kl_whitened(etas, m_w, c, b1) -> torch.Tensor:
    """KL [K] at etas [K] in the whitened form::

        KL = 0.5 [logdet S + tr(S^{-1}) - D + ||c - z||^2],
        S = I + M/eta,  z = S^{-1}(c + b1/eta),

    F32_MAX where S is not positive definite.  S is symmetrized first, as
    ``jnp.linalg.cholesky`` does; z comes from the explicit inverse factor
    (the JAX package's choice above D = 64)."""
    d = c.shape[-1]
    eye = torch.eye(d, dtype=m_w.dtype, device=m_w.device)
    s = m_w / etas[:, None, None] + eye
    lc, info = torch.linalg.cholesky_ex(0.5 * (s + s.mT))
    bad = info != 0
    lc = torch.where(bad[:, None, None], eye, lc)
    logdet_s = 2.0 * torch.sum(torch.log(torch.diagonal(lc, dim1=-2,
                                                        dim2=-1)), -1)
    inv_lc = tril_inverse(lc)
    trace = torch.sum(inv_lc * inv_lc, dim=(-2, -1))
    rhs = c + b1 / etas[:, None]
    z = torch.einsum("kji,kj->ki", inv_lc,
                     torch.einsum("kij,kj->ki", inv_lc, rhs))
    q = c - z
    kl = 0.5 * (logdet_s + trace - d + torch.sum(q * q, -1))
    return torch.where(bad, F32_MAX, kl)


def _tr_kl_whitened_grad(etas, m_w, c, b1):
    """KL [K] and dKL/d(log eta) [K] from one factorization (the Newton
    trip): with ``S = I + M/eta``, ``q = c - S^{-1}(c + b1/eta)``,
    ``dKL/dt = 0.5 (2 tr S^{-1} - D - ||S^{-1}||_F^2) - q^T S^{-1} q``.
    F32_MAX and 0 where S is not positive definite."""
    d = c.shape[-1]
    eye = torch.eye(d, dtype=m_w.dtype, device=m_w.device)
    s = m_w / etas[:, None, None] + eye
    lc, info = torch.linalg.cholesky_ex(0.5 * (s + s.mT))
    bad = info != 0
    lc = torch.where(bad[:, None, None], eye, lc)
    logdet_s = 2.0 * torch.sum(torch.log(torch.diagonal(lc, dim1=-2,
                                                        dim2=-1)), -1)
    w = tril_inverse(lc)
    sinv = w.mT @ w
    t1 = torch.diagonal(sinv, dim1=-2, dim2=-1).sum(-1)
    t2 = torch.sum(sinv * sinv, dim=(-2, -1))
    z = torch.einsum("kij,kj->ki", sinv, c + b1 / etas[:, None])
    q = c - z
    kl = 0.5 * (logdet_s + t1 - d + torch.sum(q * q, -1))
    dkl = 0.5 * (2.0 * t1 - d - t2) - torch.einsum("ki,kij,kj->k", q, sinv,
                                                   q)
    return torch.where(bad, F32_MAX, kl), torch.where(bad, 0.0, dkl)


def _newton_start(m_w, c, b1, stepsizes, last_etas):
    """The Newton search's first log eta: the warm start ``log |last eta|``,
    or cold ``0.5 (log C - log eps)`` with ``KL ~ C / eta^2``, ``C = 0.25
    ||M||_F^2 + 0.5 ||M c - b1||^2``."""
    c_asym = 0.25 * torch.sum(m_w * m_w, dim=(-2, -1)) + 0.5 * torch.sum(
        torch.square(torch.einsum("kij,kj->ki", m_w, c) - b1), -1)
    t_guess = 0.5 * (torch.log(c_asym + 1e-30) - torch.log(stepsizes))
    return torch.where(last_etas < 0, t_guess,
                       torch.log(torch.abs(last_etas) + 1e-30))


def _tr_kl_direct(eta, old_lin, old_prec, old_inv_chol, reward_lin,
                  reward_quad, kl_const, old_mean) -> torch.Tensor:
    """KL [K] at etas [K] in the direct form (the JAX package's
    ``_tr_kl_full_trip``: the interpolated precision's Cholesky, its
    explicit inverse for the mean and the trace); F32_MAX where that
    precision is not positive definite."""
    d = old_mean.shape[-1]
    e2, e3 = eta[:, None], eta[:, None, None]
    new_lin = (e2 * old_lin + reward_lin) / e2
    new_prec = (e3 * old_prec + reward_quad) / e3
    chol_p, info = torch.linalg.cholesky_ex(0.5 * (new_prec + new_prec.mT))
    bad = info != 0
    eye = torch.eye(d, dtype=chol_p.dtype, device=chol_p.device)
    chol_p = torch.where(bad[:, None, None], eye, chol_p)
    new_logdet = -2.0 * torch.sum(torch.log(torch.diagonal(
        chol_p, dim1=-2, dim2=-1)), -1)
    w = tril_inverse(chol_p)
    new_mean = torch.einsum("kji,kj->ki", w,
                            torch.einsum("kij,kj->ki", w, new_lin))
    half = w @ old_inv_chol.mT
    od = torch.einsum("kij,kj->ki", old_inv_chol, old_mean - new_mean)
    kl = 0.5 * (kl_const - new_logdet + torch.sum(half * half, dim=(-2, -1))
                + torch.sum(od * od, -1))
    return torch.where(bad, F32_MAX, kl)


def _tr_kl_eigen(eta, lam, c, b):
    """KL [K] at etas [K] in the eigenbasis of the whitened curvature,
    elementwise: ``0.5 [sum log1p(lam/eta) - sum lam/(eta + lam) + sum
    ((lam c - b)/(eta + lam))^2]``; F32_MAX where some ``eta + lam <= 0``
    (the interpolated precision is not positive definite)."""
    e = eta[:, None]
    denom = e + lam
    bad = ~torch.all(denom > 0.0, dim=-1)
    safe = torch.where(bad[:, None], 1.0, denom)
    lam_safe = torch.where(bad[:, None], 0.0, lam)
    kl = 0.5 * (torch.sum(torch.log1p(lam_safe / e), -1)
                - torch.sum(lam_safe / safe, -1)
                + torch.sum(torch.square((lam_safe * c - b) / safe), -1))
    return torch.where(bad, F32_MAX, kl)


def _trust_region_update_eigen(model: GmmState, meta: MetaState,
                               reward_lin, reward_quad, stepsizes,
                               temperature, lower0, upper0
                               ) -> ComponentUpdateResult:
    """``bracket-eigen`` (the JAX package's spectral branch of
    ``_tr_update_one``): ``L^T R L = U diag(lam) U^T`` once per step, the
    bracket around :func:`_tr_kl_eigen`, then the rebuild at the accepted
    eta: ``mu' = L U m~`` with ``m~ = (eta c + b)/(eta + lam)``, ``Sigma' =
    (L U) diag(eta/(eta + lam)) (L U)^T``, its Cholesky and triangular
    inverse.  A component fails where the search did not converge, the KL
    is F32_MAX, some ``eta + lam <= 0`` or the new Cholesky has a NaN."""
    means, chols, inv_chols = model.means, model.chols, model.inv_chols
    d = model.num_dimensions
    rw = chols.mT @ reward_quad @ chols
    lam, u = torch.linalg.eigh(0.5 * (rw + rw.mT))
    zm = torch.linalg.solve_triangular(chols, means[:, :, None],
                                       upper=False)[:, :, 0]
    c = torch.einsum("kji,kj->ki", u, zm)
    b = torch.einsum("kji,kj->ki", u,
                     torch.einsum("kji,kj->ki", chols, reward_lin))
    exp_lower, exp_upper, _ = bracket_search(
        lambda etas: _tr_kl_eigen(etas, lam, c, b), stepsizes, lower0,
        upper0, active=model.mask)
    eta = torch.clamp(exp_lower, min=temperature)
    kl = _tr_kl_eigen(eta, lam, c, b)
    denom = eta[:, None] + lam
    pd_ok = torch.all(denom > 0.0, dim=-1)
    safe = torch.where(pd_ok[:, None], denom, 1.0)
    m_tilde = (eta[:, None] * c + b) / safe
    new_mean = torch.einsum("kij,kj->ki", chols,
                            torch.einsum("kij,kj->ki", u, m_tilde))
    half = (chols @ u) * torch.sqrt(torch.clamp(eta[:, None] / safe,
                                                min=0.0))[:, None, :]
    new_chol = _cholesky_or_nan(half @ half.mT)
    success = ((exp_lower == exp_upper) & (kl < F32_MAX) & pd_ok
               & ~torch.isnan(new_chol).any(dim=(-2, -1)))
    new_chol = torch.where(success[:, None, None], new_chol, chols)
    eye = torch.eye(d, dtype=chols.dtype, device=chols.device)
    new_inv_chol = torch.linalg.solve_triangular(
        new_chol, eye.expand_as(new_chol), upper=False).contiguous()
    means, chols, inv_chols = _select_update(
        model, success, torch.where(success[:, None], new_mean, means),
        new_chol, new_inv_chol)
    return _finish_update(model, meta, means, chols, success,
                          etas=torch.where(success, eta, -1.0),
                          new_inv_chols=inv_chols)


def _tr_kl_diag(eta, old_lin, old_prec, old_inv_chol, reward_lin,
                reward_quad, old_mean):
    """KL of the diagonal interpolation at etas [K] (the reference's
    stabler elementwise form): ``(kl [K], new_mean, inv_chol_p)`` with
    ``inv_chol_p = 1 / sqrt(new_prec)``; NaN where a new precision is
    negative, which the bisection reads as "too large"."""
    d = old_mean.shape[-1]
    e = eta[:, None]
    new_lin = (e * old_lin + reward_lin) / e
    new_prec = (e * old_prec + reward_quad) / e
    new_mean = new_lin / new_prec
    inv_chol_p = 1.0 / torch.sqrt(new_prec)
    diff = old_mean - new_mean
    kl = 0.5 * (torch.clamp(torch.sum(torch.log(new_prec / old_prec)
                                      + old_prec / new_prec, -1) - d, min=0.0)
                + torch.sum(torch.square(old_inv_chol * diff), -1))
    return kl, new_mean, inv_chol_p


def _trust_region_update_diag(model: GmmState, meta: MetaState,
                              hessians_neg, grads_neg, stepsizes,
                              temperature, lower0, upper0, grid_size=None
                              ) -> ComponentUpdateResult:
    """The trust-region step of a diagonal model: the reference's bracket
    search around :func:`_tr_kl_diag` in lockstep over the slots (one flag
    read per trip), or with ``grid_size`` the grid search, then the
    parameters at the accepted eta."""
    means, inv_chols = model.means, model.inv_chols
    reward_lin = hessians_neg * means - grads_neg
    old_prec, old_lin = _old_canonical(model)

    def kl_at(etas):
        return _tr_kl_diag(etas, old_lin, old_prec, inv_chols, reward_lin,
                           hessians_neg, means)

    if grid_size is not None:
        eta0, success = grid_search(lambda etas: kl_at(etas)[0], stepsizes,
                                    lower0, upper0, grid_size)
        eta = torch.clamp(eta0, min=temperature)
    else:
        exp_lower, exp_upper, _ = bracket_search(
            lambda etas: kl_at(etas)[0], stepsizes, lower0, upper0,
            active=model.mask)
        eta = torch.clamp(exp_lower, min=temperature)
        success = exp_lower == exp_upper
    kl, new_means, inv_chol_p = kl_at(eta)
    new_chols = torch.sqrt(torch.square(inv_chol_p))
    success = success & (kl < F32_MAX) & ~torch.isnan(new_chols).any(dim=-1)
    sel = (success & model.mask)[:, None]
    return _finish_update(
        model, meta, torch.where(sel, new_means, means),
        torch.where(sel, new_chols, model.chols), success,
        etas=torch.where(success, eta, -1.0),
        new_inv_chols=torch.where(sel, 1.0 / new_chols, inv_chols))


def trust_region_update(model: GmmState, meta: MetaState,
                        hessians_neg: torch.Tensor, grads_neg: torch.Tensor,
                        stepsizes: torch.Tensor, temperature: float = 1.0,
                        search: str = "bracket", grid_size: int = 32
                        ) -> ComponentUpdateResult:
    """KL-constrained natural-gradient step for every component; the
    stepsize is the trust-region bound epsilon.  ``search`` is one of
    :data:`SEARCHES` (``tpu.trust_region_search``), ``grid_size`` the grid
    search's points per pass."""
    if search not in SEARCHES:
        raise ValueError(f"unknown trust-region search {search!r}")
    # the warm-started bracket in log space
    last = meta.last_etas
    no_warm = last < 0
    log_last = torch.log(torch.abs(last) + 1e-30)
    lower0 = torch.where(no_warm, -20.0, torch.clamp(log_last - 3.0,
                                                     min=0.0))
    upper0 = torch.where(no_warm, 80.0, log_last + 3.0)
    if model.diagonal:
        return _trust_region_update_diag(
            model, meta, hessians_neg, grads_neg, stepsizes, temperature,
            lower0, upper0, grid_size if search == "grid" else None)
    means, chols, inv_chols = model.means, model.chols, model.inv_chols
    reward_lin = torch.einsum("kij,kj->ki", hessians_neg, means) - grads_neg
    # the search and the rebuild see the symmetric part of the quadratic
    # term, as jnp.linalg.cholesky does (exact where it is symmetric; the
    # standard-IW Stein Hessian is not)
    reward_quad = 0.5 * (hessians_neg + hessians_neg.mT)
    if search == "bracket-eigen":
        return _trust_region_update_eigen(model, meta, reward_lin,
                                          reward_quad, stepsizes,
                                          temperature, lower0, upper0)
    inp = prepare_tr_kl_inputs(means, chols, inv_chols, reward_lin,
                               reward_quad)
    if search == "grid":
        eta0, success = grid_search(
            lambda etas: _tr_kl_direct(etas, inp.lin, inp.prec, inv_chols,
                                       reward_lin, reward_quad, inp.kl_const,
                                       means),
            stepsizes, lower0, upper0, grid_size)
        eta = torch.clamp(eta0, min=temperature)
    else:
        if search == "bracket" and \
                model.num_dimensions <= TR_KERNEL_MAX_D:
            exp_lower, exp_upper, _ = tr_search(inp, stepsizes, lower0,
                                                upper0, model.mask)
        else:
            m_w, c, b1 = _tr_whitened_precompute(means, chols, inv_chols,
                                                 reward_lin, reward_quad)
            if search == "newton":
                exp_lower, exp_upper, _ = newton_search(
                    lambda etas: _tr_kl_whitened_grad(etas, m_w, c, b1),
                    stepsizes, lower0, upper0,
                    _newton_start(m_w, c, b1, stepsizes, last),
                    active=model.mask)
            else:
                exp_lower, exp_upper, _ = bracket_search(
                    lambda etas: _tr_kl_whitened(etas, m_w, c, b1),
                    stepsizes, lower0, upper0, active=model.mask)
        eta = torch.clamp(exp_lower, min=temperature)
        success = exp_lower == exp_upper

    kl, new_means, new_chols, new_inv_chols = _tr_final_full(
        eta, inp.lin, inp.prec, inv_chols, reward_lin, reward_quad,
        inp.kl_const, means)
    success = success & (kl < F32_MAX)

    new_means, new_chols, new_inv_chols = _select_update(
        model, success, new_means, new_chols, new_inv_chols)
    etas = torch.where(success, eta, -1.0)
    return _finish_update(model, meta, new_means, new_chols, success,
                          etas=etas, new_inv_chols=new_inv_chols)


UPDATERS = {
    "direct": direct_update,
    "iBLR": iblr_update,
    "trust-region": trust_region_update,
}
