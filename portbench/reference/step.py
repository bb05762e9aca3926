"""The reference's whole training step: a plain copy of
``gmmvi_tpu_torch/optimization/gmmvi.py`` for one process and the global
sample ring (no mesh, no sharded or decimating database, no host-target
path, no prior samples, no capacity growth), over this package's plain
modules.

The benchmark warms every cell up with it, so the state that the program's
timed block starts from is made by this frozen code from the published
seed, the same for every version of the program.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from portbench.reference.experiments.setup import init_experiment
from portbench.reference.models import gmm as gmm_ops
from portbench.reference.models.gmm import GmmState
from portbench.reference.models.meta import MetaState
from portbench.reference.optimization import component_adaptation as adapt_ops
from portbench.reference.optimization import component_updaters as upd_ops
from portbench.reference.optimization import ng_estimators as est_ops
from portbench.reference.optimization import sample_db as db_ops
from portbench.reference.optimization import sample_selectors as sel_ops
from portbench.reference.optimization import stepsize_adapters as step_ops
from portbench.reference.optimization import weight_updaters as w_ops
from portbench.reference.optimization.component_adaptation import (
    AdaptationState, VipsConfig)
from portbench.reference.optimization.sample_selectors import SelectorConfig
from portbench.reference.optimization.stepsize_adapters import \
    WeightStepsizeState


@dataclass
class TrainState:
    """The learner state, with the program's ``TrainState`` field paths."""

    model: GmmState
    meta: MetaState
    db: db_ops.SampleDbState
    wstep: WeightStepsizeState
    adapt: AdaptationState
    num_updates: int


@dataclass
class StepDraws:
    eps: torch.Tensor
    rand_slots: Optional[torch.Tensor]
    accept_u: Optional[torch.Tensor]
    db_perm: Optional[torch.Tensor] = None
    add_a: Optional[torch.Tensor] = None
    mapping: Optional[torch.Tensor] = None
    db_u: Optional[torch.Tensor] = None


def _eval_valid_rows(target, samples, valid, estimator_type: str):
    """The target at the valid rows, zeros elsewhere (the reference's
    ``GMMVI._eval_target`` on them)."""
    idx = torch.nonzero(valid).flatten()
    x = samples[idx]
    if estimator_type != "Stein":
        lnp, grads = target.log_density(x), torch.zeros_like(x)
    elif target.use_log_density_and_grad:
        lnp, grads = target.log_density_and_grad(x)
    else:
        lnp, grads = target.log_density_and_autograd(x)
    lnpdfs = torch.zeros(samples.shape[0], dtype=samples.dtype,
                         device=samples.device)
    out = torch.zeros_like(samples)
    lnpdfs[idx] = lnp.to(samples.dtype)
    out[idx] = grads.to(samples.dtype)
    return lnpdfs, out


class ReferenceGMMVI:
    """The step of ``GMMVI`` built from a config dict as
    ``GMMVI.build_from_config`` builds it, for the cases above."""

    def __init__(self, config: dict, device):
        dev = torch.device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        self.device = dev
        target, model, meta = init_experiment(config, device=dev)
        self.target = target
        kmax, d = model.max_components, model.num_dimensions
        tpu_cfg = config.get("tpu", {}) or {}
        sel_c = config["sample_selector_config"]
        n_des = int(sel_c["desired_samples_per_component"])
        reused = int(math.floor(sel_c["ratio_reused_samples_to_desired"]
                                * n_des))
        default_bg = min(4 * kmax, 2048) if reused > 0 else kmax
        self.selector_cfg = SelectorConfig(
            kind=config["sample_selector_type"],
            desired_samples_per_component=n_des,
            reused_samples_per_component=reused,
            max_background_dists=int(tpu_cfg.get("max_background_dists",
                                                 default_bg)))
        self.vips_cfg = None
        if config["num_component_adapter_type"] == "adaptive":
            ac = config["num_component_adapter_config"]
            if int(ac["num_prior_samples"]) > 0:
                raise NotImplementedError("prior samples")
            self.vips_cfg = VipsConfig(
                del_iters=int(ac["del_iters"]),
                add_iters=int(ac["add_iters"]),
                max_components=int(ac["max_components"]),
                thresholds_for_add_heuristic=tuple(
                    float(t) for t in np.atleast_1d(
                        ac["thresholds_for_add_heuristic"])),
                min_weight_for_del_heuristic=float(
                    ac["min_weight_for_del_heuristic"]),
                num_database_samples=int(ac["num_database_samples"]),
                num_prior_samples=0, prior_entropy=None)
        w_total = sel_ops.total_window_size(self.selector_cfg, kmax)
        default_ring = (min(reused + 4, int(tpu_cfg.get(
            "max_dist_ring_iters", 64))) if reused > 0 else 2)
        num_db_cand = (self.vips_cfg.num_database_samples
                       if self.vips_cfg is not None else 0)
        reservoir = int(tpu_cfg.get("reservoir_capacity",
                                    max(1024, min(num_db_cand, 16384))))
        if self.vips_cfg is not None \
                and self.vips_cfg.num_database_samples > reservoir:
            self.vips_cfg = self.vips_cfg._replace(
                num_database_samples=reservoir)
        if str(tpu_cfg.get("db_eviction", "ring")) != "ring" \
                or not config.get("use_sample_database", True):
            raise NotImplementedError("the global ring only")
        db = db_ops.create_sample_db(
            dim=d, max_components=kmax, capacity=w_total,
            dist_ring_iters=int(tpu_cfg.get("dist_ring_iters",
                                            default_ring)),
            reservoir_capacity=reservoir, diagonal=model.diagonal,
            keep_samples=True, device=dev)
        wstep = step_ops.create_weight_stepsize_state(
            config["weight_stepsize_adapter_config"]["initial_stepsize"],
            device=dev)
        self.state = TrainState(
            model=model, meta=meta, db=db, wstep=wstep,
            adapt=adapt_ops.create_adaptation_state(dev), num_updates=0)
        self.generator = torch.Generator(device=dev).manual_seed(
            int(config.get("seed", config.get("start_seed", 0))))
        self.temperature = float(config["temperature"])
        self.estimator_type = config["ng_estimator_type"]
        est_cfg = dict(config.get("ng_estimator_config", {}))
        est_cfg.setdefault("only_use_own_samples", False)
        est_cfg.setdefault("use_self_normalized_importance_weights", True)
        self.estimator_cfg = est_cfg
        self.updater_type = config["ng_based_updater_type"]
        self.component_stepsize = (config["component_stepsize_adapter_type"],
                                   config["component_stepsize_adapter_config"])
        self.weight_updater = (config["weight_updater_type"],
                               config["weight_updater_config"])
        self.weight_stepsize = (config["weight_stepsize_adapter_type"],
                                config["weight_stepsize_adapter_config"])
        self.search = str(tpu_cfg.get("trust_region_search", "bracket"))

    def draw(self, iteration: int) -> StepDraws:
        """``GMMVI.draw`` for the global ring."""
        model, db = self.state.model, self.state.db
        g, dev = self.generator, self.device
        n_des = self.selector_cfg.desired_samples_per_component
        mapping = None
        if self.selector_cfg.is_vips:
            b = model.max_components * n_des
            eps_shape = (model.max_components, n_des, model.num_dimensions)
        else:
            b = n_des
            eps_shape = (n_des, model.num_dimensions)
            mapping = gmm_ops.sample_categorical(model, n_des, g)
        draws = StepDraws(eps=torch.randn(eps_shape, generator=g, device=dev),
                          rand_slots=None, accept_u=None, mapping=mapping)
        if db.has_reservoir:
            draws.rand_slots = torch.randint(
                0, db.reservoir_capacity, (b,), generator=g, device=dev,
                dtype=torch.int32)
            draws.accept_u = torch.rand((b,), generator=g, device=dev)
        cfg = self.vips_cfg
        if cfg is not None and adapt_ops.add_is_due(cfg, iteration + 1):
            n = cfg.num_database_samples
            if db.uses_reservoir:
                draws.db_perm = torch.randperm(
                    db.reservoir_capacity, generator=g, device=dev)[:n]
            else:
                draws.db_u = torch.rand((db.capacity,), generator=g,
                                        device=dev)
            draws.add_a = torch.rand((), generator=g, device=dev)
        return draws

    def _run_updates(self, model, meta, wstep, window, pack):
        new_stepsizes = step_ops.COMPONENT_STEPSIZE_ADAPTERS[
            self.component_stepsize[0]](meta, self.component_stepsize[1])
        meta = meta.replace(stepsizes=torch.where(model.mask, new_stepsizes,
                                                  meta.stepsizes))
        est = est_ops.stein_estimate(
            model, window.samples, window.valid, window.mapping,
            window.background_log_pdfs, window.target_lnpdfs,
            window.target_grads,
            use_self_normalized_importance_weights=self.estimator_cfg[
                "use_self_normalized_importance_weights"],
            only_use_own_samples=self.estimator_cfg["only_use_own_samples"],
            pack=pack, newest_mask=window.newest_mask)
        kw = dict(temperature=self.temperature)
        if self.updater_type == "trust-region":
            kw.update(search=self.search)
        model, meta = upd_ops.UPDATERS[self.updater_type](
            model, meta, est.expected_hessians_neg,
            est.expected_gradients_neg, meta.stepsizes, **kw)
        wstep = step_ops.WEIGHT_STEPSIZE_ADAPTERS[self.weight_stepsize[0]](
            wstep, model, meta, self.weight_stepsize[1])
        elr, meta = w_ops.expected_log_ratios(
            model, meta, window.samples, window.valid,
            window.background_log_pdfs, window.target_lnpdfs,
            self.temperature,
            self.weight_updater[1]["use_self_normalized_importance_weights"])
        model, meta = w_ops.WEIGHT_UPDATERS[self.weight_updater[0]](
            model, meta, elr, wstep.stepsize, self.temperature)
        return model, meta, wstep

    def train_iter(self) -> None:
        state = self.state
        cfg = self.vips_cfg
        if cfg is not None and state.num_updates % max(1, cfg.add_iters) \
                == 0 and state.model.max_components < cfg.max_components \
                and int(state.model.num_active) >= \
                state.model.max_components:
            raise NotImplementedError("the padding would grow")
        draws = self.draw(state.num_updates)
        prop = sel_ops.propose(state.model, state.db, self.selector_cfg,
                               draws.eps, draws.mapping)
        lnpdfs, grads = _eval_valid_rows(self.target, prop.samples,
                                         prop.valid, self.estimator_type)
        iteration = state.num_updates
        db, window, pack = sel_ops.finalize_fused(
            state.model, state.db, self.selector_cfg, iteration, prop,
            lnpdfs, grads, draws.rand_slots, draws.accept_u)
        model, meta, wstep = self._run_updates(state.model, state.meta,
                                               state.wstep, window, pack)
        num_updates = iteration + 1
        adapt = state.adapt
        if cfg is not None:
            model, meta, adapt, db = adapt_ops.adapt_number_of_components(
                model, meta, adapt, db, cfg, num_updates,
                draws.db_perm if db.uses_reservoir else draws.db_u,
                draws.add_a, None, None)
        self.state = TrainState(model=model, meta=meta, db=db, wstep=wstep,
                                adapt=adapt, num_updates=num_updates)
