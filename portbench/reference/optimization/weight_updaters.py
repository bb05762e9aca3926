"""Mixture-weight updates: the direct update and the KL trust-region update.

(JAX counterpart: gmmvi_tpu/optimization/weight_updaters.py,
``expected_log_ratios``, ``direct_weight_update`` and
``trust_region_weight_update``)

The expected log ratios are taken under the updated components (kernel B2
on the card).  The weight search is the reference's log-space bisection
over the tempered-softmax stepsize, at most 50 trips; its loop runs on the
host and reads one "done" flag per trip.  With standard importance
weights the expected log ratios are the reference's stable expectation, a
signed log-sum-exp over the samples.
"""
from __future__ import annotations

from typing import Tuple

import torch

from portbench.reference.models import meta as meta_ops
from portbench.reference.models.gmm import (GmmState,
                                        log_densities_also_individual,
                                        normalize_log_weights)
from portbench.reference.models.meta import MetaState
from portbench.reference.ops.stable import (NEG_INF, masked_logsumexp,
                                            signed_weighted_logsumexp)

LOG_WEIGHT_FLOOR = -69.07  # weights floored at 1e-30
MAX_TRIPS = 50


def expected_log_ratios(model: GmmState, meta: MetaState,
                        samples: torch.Tensor, sample_mask: torch.Tensor,
                        background: torch.Tensor,
                        target_lnpdfs: torch.Tensor, temperature: float,
                        use_self_normalized_importance_weights: bool
                        ) -> Tuple[torch.Tensor, MetaState]:
    """Per-component estimate of E_{q(x|o)}[log p(x) - T log q(x)]; stores
    the rewards T log w_o + E[log ratio] in the reward history.  On a mesh
    the samples are this rank's rows and the sums over them are reduced
    over ``data``; the weight searches then run replicated."""
    model_densities, comp_log_densities = log_densities_also_individual(
        model, samples)
    log_ratios = target_lnpdfs - temperature * model_densities
    log_iw = comp_log_densities - background[None, :]
    mask = sample_mask[None, :].expand(log_iw.shape)
    if use_self_normalized_importance_weights:
        log_w = log_iw - masked_logsumexp(log_iw, mask=mask,
                                                      dim=1, keepdim=True)
        w = torch.where(mask, torch.exp(log_w), 0.0)
        w = w / torch.clamp(w.sum(dim=1, keepdim=True),
                            min=1e-38)
        elr = w @ log_ratios
    else:
        n = torch.clamp(
            sample_mask.sum(dtype=log_ratios.dtype), min=1.0)
        elr = (1.0 / n) * signed_weighted_logsumexp(
            log_iw, log_ratios[None, :], dim=1, mask=mask)
    rewards = temperature * model.log_weights + elr
    rewards = torch.where(model.mask, rewards, meta.reward_history[:, -1])
    return elr, meta_ops.store_rewards(meta, rewards)


def _apply_new_log_weights(model: GmmState, meta: MetaState,
                           new_log_weights: torch.Tensor):
    """Replace the weights and append them to the weight history; nothing
    changes when only one component is active."""
    more_than_one = model.num_active > 1
    updated = model.replace(
        log_weights=normalize_log_weights(new_log_weights, model.mask))
    stored = meta_ops.store_weights(meta, updated.weights)
    model = model.replace(log_weights=torch.where(
        more_than_one, updated.log_weights, model.log_weights))
    meta = meta.replace(weight_history=torch.where(
        more_than_one, stored.weight_history, meta.weight_history))
    return model, meta


def direct_weight_update(model: GmmState, meta: MetaState,
                         elr: torch.Tensor, stepsize, temperature: float):
    """``log w' = log w + (stepsize / T) E[log ratio]``, normalized and
    floored at 1e-30; nothing changes when only one component is active."""
    unnormalized = model.log_weights + (stepsize / temperature) * elr
    lw = unnormalized - masked_logsumexp(unnormalized, mask=model.mask, dim=0)
    lw = torch.clamp(lw, min=LOG_WEIGHT_FLOOR)
    return _apply_new_log_weights(model, meta, lw)


def _tr_weight_kl(eta, log_weights, mask, rewards, temperature):
    """Closed-form tempered-softmax update and its KL to the current
    weights."""
    unnormalized = ((eta + 1.0) / (temperature + eta) * log_weights
                    + 1.0 / (temperature + eta) * rewards)
    lw = unnormalized - masked_logsumexp(unnormalized, mask=mask, dim=0)
    lw = torch.clamp(lw, min=LOG_WEIGHT_FLOOR)
    lw = lw - masked_logsumexp(lw, mask=mask, dim=0)
    lw = torch.where(mask, lw, NEG_INF)
    kl = torch.sum(torch.where(mask, torch.exp(lw) * (lw - log_weights),
                               0.0))
    return kl, lw


def trust_region_weight_update(model: GmmState, meta: MetaState,
                               elr: torch.Tensor, kl_bound,
                               temperature: float):
    """Largest tempered-softmax step whose KL to the current weights stays
    within ``kl_bound``: a log-space bracket over eta in [e^-45, e^45].
    Keeps the old weights when no feasible eta is found."""
    mask = model.mask
    log_weights = torch.where(mask, model.log_weights, NEG_INF)
    rewards = torch.where(mask, elr, NEG_INF)

    def kl_at(eta):
        return _tr_weight_kl(eta, log_weights, mask, rewards, temperature)

    f32 = dict(dtype=torch.float32, device=log_weights.device)
    lower = torch.tensor(-45.0, **f32)
    upper = torch.tensor(45.0, **f32)
    log_eta = 0.5 * (lower + upper)
    lw = log_weights
    upper_ok = torch.tensor(False, device=log_weights.device)
    for _ in range(MAX_TRIPS):
        new_eta = torch.exp(log_eta)
        width_stop = torch.abs(torch.exp(upper) - torch.exp(lower)) < 1e-1
        new_kl, new_lw = kl_at(new_eta)
        good = torch.abs(kl_bound - new_kl) < 1e-1 * kl_bound
        adv = torch.logical_not(width_stop)
        lw = torch.where(adv, new_lw, lw)
        go_up = kl_bound > new_kl
        lower_n = torch.where(adv & ~good & ~go_up, log_eta, lower)
        upper_n = torch.where(adv & ~good & go_up, log_eta, upper)
        lower_n = torch.where(adv & good, upper_n, lower_n)
        upper_ok = torch.where(adv & ~good, upper_ok | go_up, upper_ok)
        lower, upper = lower_n, upper_n
        log_eta = 0.5 * (upper + lower)
        if bool(width_stop | (adv & good)):
            break

    converged = lower == upper
    _, lw_u = kl_at(torch.exp(upper))
    new_lw = torch.where(converged, lw,
                         torch.where(upper_ok, lw_u, log_weights))
    return _apply_new_log_weights(model, meta, new_lw)


WEIGHT_UPDATERS = {
    "direct": direct_weight_update,
    "trust-region": trust_region_weight_update,
}
