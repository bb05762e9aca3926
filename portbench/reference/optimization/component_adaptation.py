"""Adapting the number of components: the VIPS add and delete heuristics.

(JAX counterpart: gmmvi_tpu/optimization/component_adaptation.py)

Shapes never change: an add writes the next free slot, a delete compacts
model and meta-state with one permutation.  Whether a delete or an add is
due at all follows from the iteration number, a host integer; whether one
takes effect depends on device values (a bad component, room for another),
and the result is selected with ``torch.where`` so no device value is read
on the host.  The random draws of an add (the candidates' permutation or
uniforms and the entropy mixing coefficient) come in as tensors, and so do
the step's prior samples with their target log densities, when configured.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from portbench.reference.device import resolve_device
from portbench.reference.models import gmm as gmm_ops
from portbench.reference.models import meta as meta_ops
from portbench.reference.models.gmm import LOG_2PI, GmmState
from portbench.reference.models.meta import MetaState
from portbench.reference.ops.stable import F32_MIN


@dataclass
class AdaptationState:
    num_calls_to_add_heuristic: torch.Tensor  # 0-d int32

    def replace(self, **kw) -> "AdaptationState":
        return dataclasses.replace(self, **kw)


def create_adaptation_state(device="cuda") -> AdaptationState:
    return AdaptationState(num_calls_to_add_heuristic=torch.zeros(
        (), dtype=torch.int32, device=resolve_device(device)))


class VipsConfig(NamedTuple):
    """Static hyperparameters; ``prior_entropy`` is the entropy of the
    diagonal candidate prior, None when no prior was configured."""

    del_iters: int
    add_iters: int
    max_components: int
    thresholds_for_add_heuristic: Tuple[float, ...]
    min_weight_for_del_heuristic: float
    num_database_samples: int
    num_prior_samples: int
    prior_entropy: Optional[float] = None


def _select(cond: torch.Tensor, a, b):
    """Field-wise ``torch.where(cond, a, b)`` over two states of one
    dataclass type (static fields are taken from ``a``)."""
    kw = {}
    for f in dataclasses.fields(a):
        va, vb = getattr(a, f.name), getattr(b, f.name)
        if isinstance(va, torch.Tensor):
            kw[f.name] = torch.where(cond, va, vb)
    return dataclasses.replace(a, **kw)


def smoothing_kernel(del_iters: int, device) -> torch.Tensor:
    """Gaussian kernel over the reward history: sigma = del_iters / 8 on
    [-floor(del_iters/3), floor(del_iters/3)), normalized to sum 1."""
    fd = int(math.floor(del_iters / 3))
    x = torch.arange(-fd, fd, dtype=torch.float32, device=device)
    k = torch.exp(-0.5 * torch.square(x / (del_iters / 8.0)))
    return k / k.sum()


def delete_bad_components(model: GmmState, meta: MetaState, cfg: VipsConfig
                          ) -> Tuple[GmmState, MetaState]:
    """Delete the components that stagnate (smoothed-reward improvement over
    del_iters <= 0.4), have low weight (actual and greedy softmax weight
    below min_weight_for_del_heuristic), and are old enough."""
    kernel = smoothing_kernel(cfg.del_iters, device=model.device)
    ksize = kernel.shape[0]
    di = cfg.del_iters
    rh = meta.reward_history
    current = torch.mean(rh[:, -ksize:] * kernel[None, :], dim=1)
    old = torch.mean(rh[:, -ksize - di:-di] * kernel[None, :], dim=1)
    mask = model.mask
    cmax = torch.max(torch.where(mask, current, -torch.inf))
    old_c = old - cmax
    improvement = ((current - cmax) - old_c) / torch.abs(old_c)

    max_actual = torch.max(meta.weight_history[:, -ksize - di:-1], dim=1)[0]
    win = rh[:, -ksize - di:]
    greedy = torch.exp(win - torch.logsumexp(
        torch.where(mask[:, None], win, -torch.inf), dim=0, keepdim=True))
    max_greedy = torch.max(torch.where(mask[:, None], greedy, 0.0), dim=1)[0]
    max_weights = torch.maximum(max_actual, max_greedy)

    is_bad = ((improvement <= 0.4)
              & (max_weights < cfg.min_weight_for_del_heuristic)
              & (rh[:, -di] != F32_MIN) & mask)
    keep = mask & torch.logical_not(is_bad)
    order = gmm_ops.compaction_order(keep)
    any_bad = is_bad.any()
    return (_select(any_bad, gmm_ops.remove_components(model, keep), model),
            _select(any_bad, meta_ops.remove_components_meta(meta, order),
                    meta))


def diagonal_gaussian_entropy(cov_diag) -> float:
    """Entropy of N(mu, diag(cov_diag)), for the candidate prior."""
    cov_diag = np.asarray(cov_diag)
    d = cov_diag.shape[0]
    return float(0.5 * d * (LOG_2PI + 1.0) + 0.5 * np.sum(np.log(cov_diag)))


def add_new_component(model: GmmState, meta: MetaState,
                      adapt: AdaptationState, db, cfg: VipsConfig,
                      db_draw: torch.Tensor, add_a: torch.Tensor,
                      prior_samples: Optional[torch.Tensor] = None,
                      prior_lnpdfs: Optional[torch.Tensor] = None):
    """Add one component at the most promising candidate.

    ``db_draw`` picks the database's candidates
    (the database's ``get_random_samples``); ``prior_samples`` ``[P, D]`` with
    their target log densities join them and count as function
    evaluations.  ``add_a`` (uniform in [0, 1)) mixes the desired entropy
    between the model's average entropy and the prior's.  A candidate's
    reward is ``target - max(max_model_ld - threshold, model_ld)`` with a
    threshold that cycles through the list; the new covariance is
    isotropic with the desired entropy."""
    samples, lnpdfs, valid = db.get_random_samples(
        db_draw, cfg.num_database_samples)
    if prior_samples is not None:
        samples = torch.cat([samples, prior_samples])
        lnpdfs = torch.cat([lnpdfs, prior_lnpdfs])
        valid = torch.cat([valid, torch.ones(prior_samples.shape[0],
                                             dtype=torch.bool,
                                             device=valid.device)])
        db = db.replace(num_samples_written=db.num_samples_written
                        + prior_samples.shape[0])
    thresholds = torch.tensor(cfg.thresholds_for_add_heuristic,
                              dtype=torch.float32, device=model.device)
    t_idx = torch.remainder(adapt.num_calls_to_add_heuristic,
                            thresholds.shape[0]).long()
    threshold = thresholds[t_idx]
    adapt = adapt.replace(
        num_calls_to_add_heuristic=adapt.num_calls_to_add_heuristic + 1)

    model_ld = gmm_ops.log_density(model, samples)
    avg_h = gmm_ops.average_entropy(model)
    if cfg.prior_entropy is not None:
        des_entropy = avg_h * add_a + cfg.prior_entropy * (1.0 - add_a)
    else:
        des_entropy = avg_h
    max_ld = torch.max(torch.where(valid, model_ld, -torch.inf))
    rewards = lnpdfs - torch.maximum(max_ld - threshold, model_ld)
    rewards = torch.where(valid, rewards, -torch.inf)
    new_mean = samples[torch.argmax(rewards)]

    d = model.num_dimensions
    c = torch.exp(2.0 * (des_entropy - 0.5 * d * (LOG_2PI + 1.0)) / d)
    new_cov = c * (torch.ones(d, dtype=torch.float32, device=model.device)
                   if model.diagonal else
                   torch.eye(d, dtype=torch.float32, device=model.device))

    slot = torch.clamp(model.num_active, max=model.max_components - 1)
    has_room = model.num_active < model.max_components
    init_weight = 1e-29
    new_model = gmm_ops.add_component(model, init_weight, new_mean, new_cov)
    new_meta = meta_ops.add_component_meta(meta, slot, has_room, init_weight,
                                           threshold, des_entropy)
    return new_model, new_meta, adapt, db


def adapt_number_of_components(model: GmmState, meta: MetaState,
                               adapt: AdaptationState, db, cfg: VipsConfig,
                               iteration: int,
                               db_draw: Optional[torch.Tensor],
                               add_a: Optional[torch.Tensor],
                               prior_samples: Optional[torch.Tensor] = None,
                               prior_lnpdfs: Optional[torch.Tensor] = None):
    """Delete check once ``iteration > del_iters``; an add every
    ``add_iters`` iterations while below ``max_components``.  ``db_draw``
    and ``add_a`` are needed only when :func:`add_is_due`; the prior
    samples count as function evaluations only where an add takes
    place."""
    if iteration > cfg.del_iters:
        model, meta = delete_bad_components(model, meta, cfg)
    if add_is_due(cfg, iteration):
        should_add = ((model.num_active < cfg.max_components)
                      & (model.num_active < model.max_components))
        new_model, new_meta, new_adapt, new_db = add_new_component(
            model, meta, adapt, db, cfg, db_draw, add_a, prior_samples,
            prior_lnpdfs)
        model = _select(should_add, new_model, model)
        meta = _select(should_add, new_meta, meta)
        adapt = _select(should_add, new_adapt, adapt)
        db = db.replace(num_samples_written=torch.where(
            should_add, new_db.num_samples_written, db.num_samples_written))
    return model, meta, adapt, db


def add_is_due(cfg: VipsConfig, iteration: int) -> bool:
    """Whether the add heuristic runs at ``iteration`` (the iteration count
    after this step's update), before the device-side room checks."""
    return iteration > 1 and iteration % cfg.add_iters == 0
