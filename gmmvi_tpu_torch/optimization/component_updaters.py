"""Natural-gradient component updates: the KL trust-region update.

(JAX counterpart: gmmvi_tpu/optimization/component_updaters.py, the
full-covariance bracket path ``_trust_region_update_pallas``)

Every component's stepsize eta is found by the reference's log-space
bisection, run in lockstep over the padded component axis.  Each trip
evaluates KL(new_k(eta_k) || old_k) for all components in one call: for
D <= 64 of :func:`gmmvi_tpu_torch.ops.trust_region.tr_kl` (kernel B3 on the
card), above it of the JAX package's whitened form in plain torch (the JAX
package keeps that one in XLA: ``_tr_whitened_precompute`` and
``_tr_kl_whitened_trip``, selected where its kernel's envelope ends).  The
loop itself runs on the host and reads one "all done" flag per trip, which
is one device-to-host sync per trip.  The accepted update is rebuilt at the
found eta from one Cholesky of the flipped precision.  Failures are success
masks: a failed component keeps its parameters.  The direct and iBLR
updaters and the other searches are not ported yet.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from gmmvi_tpu_torch.models.gmm import GmmState, replace_components
from gmmvi_tpu_torch.models.meta import MetaState
from gmmvi_tpu_torch.ops.blocked_linalg import tril_inverse
from gmmvi_tpu_torch.ops.stable import F32_MAX
from gmmvi_tpu_torch.ops.trust_region import MAX_D as TR_KERNEL_MAX_D
from gmmvi_tpu_torch.ops.trust_region import prepare_tr_kl_inputs, tr_kl

MAX_TRIPS = 1000


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
    positive definite."""
    lt = _cholesky_or_nan(new_prec.flip(-2, -1))
    new_chol = tril_inverse(lt).mT.flip(-2, -1)
    new_inv_chol = lt.mT.flip(-2, -1)
    return new_chol, new_inv_chol


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


def _bracketing_search_batched(kl_eval: Callable, kl_bound, lower0, upper0,
                               active: Optional[torch.Tensor] = None):
    """The reference's log-space bisection for the largest stepsize within
    the KL bound, for all components in lockstep: per trip, one ``kl_eval``
    of etas [K] -> KLs [K], then masked bracket updates.  A component stops
    when the bracket (in eta space) is narrower than 0.1 or |KL - bound| <
    0.1 bound; the loop stops when all have, at most 1000 trips.  Returns
    ``(exp(lower), exp(upper), trips)``."""
    k = lower0.shape[0]
    dev = lower0.device
    lower, upper = lower0, upper0
    upper_ok = torch.zeros((k,), dtype=torch.bool, device=dev)
    done = (torch.zeros((k,), dtype=torch.bool, device=dev)
            if active is None else torch.logical_not(active))
    trips = 0
    while trips < MAX_TRIPS and not bool(done.all()):
        act = torch.logical_not(done)
        eta = 0.5 * (lower + upper)
        kl = kl_eval(torch.exp(eta))
        diff = torch.minimum(torch.exp(upper) - torch.exp(eta),
                             torch.exp(eta) - torch.exp(lower))
        stop_width = diff < 1e-1
        good = torch.abs(kl_bound - kl) < 1e-1 * kl_bound
        go_low = kl_bound > kl
        new_lower = torch.where(
            stop_width, lower,
            torch.where(good, eta, torch.where(go_low, lower, eta)))
        new_upper = torch.where(
            stop_width, upper,
            torch.where(good, eta, torch.where(go_low, eta, upper)))
        new_upper_ok = torch.where(
            ~stop_width & ~good, upper_ok | go_low, upper_ok)
        lower = torch.where(act, new_lower, lower)
        upper = torch.where(act, new_upper, upper)
        upper_ok = torch.where(act, new_upper_ok, upper_ok)
        done = torch.where(act, stop_width | good, done)
        trips += 1
    lower = torch.where(upper_ok, upper, lower)
    return torch.exp(lower), torch.exp(upper), trips


def trust_region_update(model: GmmState, meta: MetaState,
                        hessians_neg: torch.Tensor, grads_neg: torch.Tensor,
                        stepsizes: torch.Tensor, temperature: float = 1.0,
                        search: str = "bracket") -> ComponentUpdateResult:
    """KL-constrained natural-gradient step for every component; the
    stepsize is the trust-region bound epsilon."""
    if search != "bracket":
        raise NotImplementedError(
            f"trust-region search '{search}' is not ported yet (the port "
            "has 'bracket')")
    if model.diagonal:
        raise NotImplementedError(
            "diagonal covariances are not ported yet (full covariances only)")
    means, chols, inv_chols = model.means, model.chols, model.inv_chols
    reward_quad = hessians_neg
    reward_lin = torch.einsum("kij,kj->ki", reward_quad, means) - grads_neg
    inp = prepare_tr_kl_inputs(means, chols, inv_chols, reward_lin,
                               reward_quad)
    if model.num_dimensions <= TR_KERNEL_MAX_D:
        def kl_eval(etas):
            return tr_kl(etas, inp)
    else:
        m_w, c, b1 = _tr_whitened_precompute(means, chols, inv_chols,
                                             reward_lin, reward_quad)

        def kl_eval(etas):
            return _tr_kl_whitened(etas, m_w, c, b1)

    last = meta.last_etas
    no_warm = last < 0
    log_last = torch.log(torch.abs(last) + 1e-30)
    lower0 = torch.where(no_warm, -20.0, torch.clamp(log_last - 3.0,
                                                     min=0.0))
    upper0 = torch.where(no_warm, 80.0, log_last + 3.0)
    exp_lower, exp_upper, _ = _bracketing_search_batched(
        kl_eval, stepsizes, lower0, upper0, active=model.mask)
    eta = torch.clamp(exp_lower, min=temperature)
    success = exp_lower == exp_upper

    kl, new_means, new_chols, new_inv_chols = _tr_final_full(
        eta, inp.lin, inp.prec, inv_chols, reward_lin, reward_quad,
        inp.kl_const, means)
    success = success & (kl < F32_MAX)

    sel = success & model.mask
    new_means = torch.where(sel[:, None], new_means, means)
    new_chols = torch.where(sel[:, None, None], new_chols, chols)
    new_inv_chols = torch.where(sel[:, None, None], new_inv_chols, inv_chols)
    etas = torch.where(success, eta, -1.0)
    return _finish_update(model, meta, new_means, new_chols, success,
                          etas=etas, new_inv_chols=new_inv_chols)


UPDATERS = {"trust-region": trust_region_update}
