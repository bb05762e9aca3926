"""The GMMVI optimizer: one training iteration over an explicit state.

(JAX counterpart: gmmvi_tpu/optimization/gmmvi.py)

The learner state is one :class:`TrainState` with the same field paths as
the JAX package's (``model.means``, ``db.write_pos``, ...).  An iteration
runs eagerly: propose fresh samples (with sample reuse, after an ESS pass
over the newest stored samples: kernels B4 and B2 on the card), evaluate the
target, store them and take the current model's density pack (kernel B1;
B4 again for the older generating distributions), estimate the natural
gradient (Stein, or MORE through kernel B8), update components (kernel B3
per bisection trip) and weights (kernel B2), then adapt the number of
components.

Every random draw of a step comes from the instance's ``torch.Generator``
unless the caller passes a :class:`StepDraws` with its own.  The iteration
count is a host integer (``TrainState.num_updates``), so the adaptation
gates need no device read; the bisections read one flag per trip.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from gmmvi_tpu_torch.device import resolve_device
from gmmvi_tpu_torch.experiments.targets.lnpdf import LNPDF
from gmmvi_tpu_torch.models import meta as meta_ops
from gmmvi_tpu_torch.models.gmm import GmmState
from gmmvi_tpu_torch.models.meta import MetaState
from gmmvi_tpu_torch.optimization import component_adaptation as adapt_ops
from gmmvi_tpu_torch.optimization import component_updaters as upd_ops
from gmmvi_tpu_torch.optimization import ng_estimators as est_ops
from gmmvi_tpu_torch.optimization import sample_db as db_ops
from gmmvi_tpu_torch.optimization import sample_selectors as sel_ops
from gmmvi_tpu_torch.optimization import stepsize_adapters as step_ops
from gmmvi_tpu_torch.optimization import weight_updaters as w_ops
from gmmvi_tpu_torch.optimization.component_adaptation import (
    AdaptationState, VipsConfig)
from gmmvi_tpu_torch.optimization.sample_db import SampleDbState
from gmmvi_tpu_torch.optimization.sample_selectors import SelectorConfig
from gmmvi_tpu_torch.optimization.stepsize_adapters import \
    WeightStepsizeState


@dataclass
class TrainState:
    """The complete learner state.  ``num_updates`` is a host integer; the
    JAX package's ``key`` has no counterpart (see :class:`StepDraws`)."""

    model: GmmState
    meta: MetaState
    db: SampleDbState
    wstep: WeightStepsizeState
    adapt: AdaptationState
    num_updates: int


@dataclass
class StepDraws:
    """The random numbers one iteration consumes.

    eps ``[Kmax, n_des, D]`` standard normal (fresh samples); rand_slots
    ``[B]`` integers in [0, C) and accept_u ``[B]`` uniform in [0, 1) (the
    reservoir); db_perm ``[n]`` distinct reservoir slots and add_a a 0-d
    uniform (an add).  The last two are read only when an add is due."""

    eps: torch.Tensor
    rand_slots: torch.Tensor
    accept_u: torch.Tensor
    db_perm: Optional[torch.Tensor] = None
    add_a: Optional[torch.Tensor] = None


class GMMVI:
    """Assembles the training step from a config (module slots as in the
    JAX package) and holds the state between steps."""

    def __init__(self, target_distribution: LNPDF, initial_state: TrainState,
                 temperature: float, selector_cfg: SelectorConfig,
                 estimator_type: str, estimator_cfg: dict,
                 component_stepsize_type: str, component_stepsize_cfg: dict,
                 weight_updater_type: str, weight_updater_cfg: dict,
                 weight_stepsize_type: str, weight_stepsize_cfg: dict,
                 vips_cfg: Optional[VipsConfig], seed: int,
                 device: torch.device):
        self.target_distribution = target_distribution
        self.state = initial_state
        self.temperature = float(temperature)
        self.selector_cfg = selector_cfg
        self.estimator_type = estimator_type
        self.estimator_cfg = dict(estimator_cfg)
        self.component_stepsize_type = component_stepsize_type
        self.component_stepsize_cfg = dict(component_stepsize_cfg)
        self.weight_updater_type = weight_updater_type
        self.weight_updater_cfg = dict(weight_updater_cfg)
        self.weight_stepsize_type = weight_stepsize_type
        self.weight_stepsize_cfg = dict(weight_stepsize_cfg)
        self.vips_cfg = vips_cfg
        self.device = device
        self.generator = torch.Generator(device=device).manual_seed(seed)
        self._steps_to_capacity_check = 1

    # ------------------------------------------------------------------
    # Random draws
    # ------------------------------------------------------------------
    def draw(self, iteration: int) -> StepDraws:
        """Draws for the step that brings the count to ``iteration + 1``,
        from the instance's generator."""
        model, db = self.state.model, self.state.db
        g, dev = self.generator, self.device
        n_des = self.selector_cfg.desired_samples_per_component
        b = model.max_components * n_des
        c = db.reservoir_capacity
        draws = StepDraws(
            eps=torch.randn((model.max_components, n_des,
                             model.num_dimensions), generator=g, device=dev),
            rand_slots=torch.randint(0, c, (b,), generator=g, device=dev,
                                     dtype=torch.int32),
            accept_u=torch.rand((b,), generator=g, device=dev))
        cfg = self.vips_cfg
        if cfg is not None and adapt_ops.add_is_due(cfg, iteration + 1):
            draws.db_perm = torch.randperm(c, generator=g, device=dev)[
                :cfg.num_database_samples]
            draws.add_a = torch.rand((), generator=g, device=dev)
        return draws

    # ------------------------------------------------------------------
    # Phases
    # ------------------------------------------------------------------
    def _eval_target(self, samples: torch.Tensor):
        """(lnpdfs, grads) of the target at ``samples``; the grads are zeros
        when the estimator does not read them (MORE), as in the JAX
        package."""
        if self.estimator_type != "Stein":
            return (self.target_distribution.log_density(samples),
                    torch.zeros_like(samples))
        return self.target_distribution.log_density_and_grad(samples)

    def _propose_phase(self, state: TrainState, draws: StepDraws):
        return sel_ops.propose(state.model, state.db, self.selector_cfg,
                               draws.eps)

    def _update_phase(self, state: TrainState, prop: sel_ops.Proposal,
                      lnpdfs: torch.Tensor, grads: torch.Tensor,
                      draws: StepDraws) -> TrainState:
        iteration = state.num_updates
        db, window, pack = sel_ops.finalize_fused(
            state.model, state.db, self.selector_cfg, iteration, prop,
            lnpdfs, grads, draws.rand_slots, draws.accept_u)
        model, meta, wstep = self._run_updates(state.model, state.meta,
                                               state.wstep, window, pack)
        num_updates = iteration + 1
        adapt = state.adapt
        if self.vips_cfg is not None:
            model, meta, adapt, db = adapt_ops.adapt_number_of_components(
                model, meta, adapt, db, self.vips_cfg, num_updates,
                draws.db_perm, draws.add_a)
        return TrainState(model=model, meta=meta, db=db, wstep=wstep,
                          adapt=adapt, num_updates=num_updates)

    def _run_updates(self, model: GmmState, meta: MetaState,
                     wstep: WeightStepsizeState, window, pack):
        """Component and weight updates on the window, in the reference's
        order; the weight update sees the updated components."""
        # 1. component stepsizes
        new_stepsizes = step_ops.COMPONENT_STEPSIZE_ADAPTERS[
            self.component_stepsize_type](meta, self.component_stepsize_cfg)
        meta = meta.replace(stepsizes=torch.where(model.mask, new_stepsizes,
                                                  meta.stepsizes))
        # 2. natural-gradient estimate
        est_kw = dict(
            use_self_normalized_importance_weights=self.estimator_cfg[
                "use_self_normalized_importance_weights"],
            only_use_own_samples=self.estimator_cfg["only_use_own_samples"],
            pack=pack, newest_mask=window.newest_mask)
        if self.estimator_type == "MORE":
            est = est_ops.more_estimate(
                model, window.samples, window.valid, window.mapping,
                window.background_log_pdfs, window.target_lnpdfs,
                meta.l2_regularizers, **est_kw)
        else:
            est = est_ops.stein_estimate(
                model, window.samples, window.valid, window.mapping,
                window.background_log_pdfs, window.target_lnpdfs,
                window.target_grads, **est_kw)
        # 3. component update
        model, meta = upd_ops.trust_region_update(
            model, meta, est.expected_hessians_neg,
            est.expected_gradients_neg, meta.stepsizes,
            temperature=self.temperature)
        # 4. weight stepsize
        wstep = step_ops.WEIGHT_STEPSIZE_ADAPTERS[self.weight_stepsize_type](
            wstep, model, meta, self.weight_stepsize_cfg)
        # 5. weight update (stores the component rewards)
        elr, meta = w_ops.expected_log_ratios(
            model, meta, window.samples, window.valid,
            window.background_log_pdfs, window.target_lnpdfs,
            self.temperature,
            self.weight_updater_cfg["use_self_normalized_importance_weights"])
        model, meta = w_ops.WEIGHT_UPDATERS[self.weight_updater_type](
            model, meta, elr, wstep.stepsize, self.temperature)
        return model, meta, wstep

    def _full_step(self, state: TrainState, draws: StepDraws) -> TrainState:
        prop = self._propose_phase(state, draws)
        lnpdfs, grads = self._eval_target(prop.samples)
        return self._update_phase(state, prop, lnpdfs, grads, draws)

    # ------------------------------------------------------------------
    # Public API
    # ------------------------------------------------------------------
    def _check_capacity(self) -> None:
        """Every ``add_iters`` steps while VIPS may still grow past the
        padded capacity: raise if the padding is full (the JAX package
        repads here; the port does not yet)."""
        cfg = self.vips_cfg
        kmax = self.state.model.max_components
        if cfg is None or kmax >= cfg.max_components:
            return
        self._steps_to_capacity_check -= 1
        if self._steps_to_capacity_check > 0:
            return
        self._steps_to_capacity_check = max(1, cfg.add_iters)
        if int(self.state.model.num_active) >= kmax:
            raise NotImplementedError(
                f"component capacity {kmax} is full and max_components="
                f"{cfg.max_components}: growing the padding is not ported "
                "yet; set tpu.max_components to preallocate")

    def train_iter(self, draws: Optional[StepDraws] = None) -> None:
        """Advance one iteration, with ``draws`` or fresh generator draws."""
        self._check_capacity()
        if draws is None:
            draws = self.draw(self.state.num_updates)
        self.state = self._full_step(self.state, draws)

    def train_iters(self, n: int) -> None:
        for _ in range(n):
            self.train_iter()

    @property
    def model(self) -> GmmState:
        return self.state.model

    @property
    def num_updates(self) -> int:
        return self.state.num_updates

    # ------------------------------------------------------------------
    # Construction
    # ------------------------------------------------------------------
    @staticmethod
    def build_from_config(config: dict, target_distribution: LNPDF,
                          model: GmmState, meta: Optional[MetaState] = None,
                          seed: Optional[int] = None,
                          device="cuda") -> "GMMVI":
        """A GMMVI instance from a reference-schema config dict; ``model``
        is a padded GmmState (see ``experiments.setup``) on ``device``."""
        from gmmvi_tpu_torch.configs import validate_config

        dev = resolve_device(device)
        validate_config(config)
        _check_supported(config)
        tpu_cfg = config.get("tpu", {}) or {}
        if model.device != dev:
            raise ValueError(f"model is on {model.device}, expected {dev}")
        kmax, d = model.max_components, model.num_dimensions

        sel_c = config["sample_selector_config"]
        n_des = int(sel_c["desired_samples_per_component"])
        reused = int(math.floor(sel_c["ratio_reused_samples_to_desired"]
                                * n_des))
        default_bg = min(4 * kmax, 2048) if reused > 0 else kmax
        selector_cfg = SelectorConfig(
            kind=config["sample_selector_type"],
            desired_samples_per_component=n_des,
            reused_samples_per_component=reused,
            max_background_dists=int(tpu_cfg.get("max_background_dists",
                                                 default_bg)))
        sel_ops.check_supported(selector_cfg)

        vips_cfg = None
        if config["num_component_adapter_type"] == "adaptive":
            ac = config["num_component_adapter_config"]
            mi = config.get("model_initialization", {})
            pm, ic = mi.get("prior_mean"), mi.get("initial_cov")
            prior_entropy = None
            if pm is not None and ic is not None:
                prior_entropy = adapt_ops.diagonal_gaussian_entropy(
                    np.asarray(ic, np.float32) * np.ones(d, np.float32))
            vips_cfg = VipsConfig(
                del_iters=int(ac["del_iters"]),
                add_iters=int(ac["add_iters"]),
                max_components=int(ac["max_components"]),
                thresholds_for_add_heuristic=tuple(
                    float(t) for t in np.atleast_1d(
                        ac["thresholds_for_add_heuristic"])),
                min_weight_for_del_heuristic=float(
                    ac["min_weight_for_del_heuristic"]),
                num_database_samples=int(ac["num_database_samples"]),
                num_prior_samples=int(ac["num_prior_samples"]),
                prior_entropy=prior_entropy)
            if vips_cfg.num_prior_samples > 0:
                raise NotImplementedError(
                    "prior samples for the add heuristic "
                    "(num_prior_samples > 0) are not ported yet")

        w_total = sel_ops.total_window_size(selector_cfg, kmax)
        # with reuse, old samples need their generating distributions kept
        default_ring = (min(reused + 4, int(tpu_cfg.get("max_dist_ring_iters",
                                                        64)))
                        if reused > 0 else 2)
        num_db_cand = (vips_cfg.num_database_samples if vips_cfg is not None
                       else 0)
        reservoir = int(tpu_cfg.get("reservoir_capacity",
                                    max(1024, min(num_db_cand, 16384))))
        if vips_cfg is not None and vips_cfg.num_database_samples > reservoir:
            vips_cfg = vips_cfg._replace(num_database_samples=reservoir)
        keep_samples = bool(config.get("use_sample_database", True))
        db = db_ops.create_sample_db(
            dim=d, max_components=kmax, capacity=w_total,
            dist_ring_iters=int(tpu_cfg.get("dist_ring_iters", default_ring)),
            reservoir_capacity=reservoir, diagonal=model.diagonal,
            keep_samples=keep_samples, device=dev)
        if not keep_samples:
            # no database: no reuse, as the JAX package configures it
            selector_cfg = selector_cfg._replace(reused_samples_per_component=0)

        if meta is None:
            meta = meta_ops.create_meta_state(
                model,
                config["component_stepsize_adapter_config"][
                    "initial_stepsize"],
                config.get("ng_estimator_config", {}).get(
                    "initial_l2_regularizer", 1e-12),
                meta_ops.history_length_from_config(config))
        wstep = step_ops.create_weight_stepsize_state(
            config["weight_stepsize_adapter_config"]["initial_stepsize"],
            device=dev)
        if seed is None:
            seed = int(config.get("seed", config.get("start_seed", 0)))
        state = TrainState(model=model, meta=meta, db=db, wstep=wstep,
                           adapt=adapt_ops.create_adaptation_state(dev),
                           num_updates=0)
        est_cfg = dict(config.get("ng_estimator_config", {}))
        est_cfg.setdefault("only_use_own_samples", False)
        est_cfg.setdefault("use_self_normalized_importance_weights", True)
        est_cfg.pop("initial_l2_regularizer", None)
        return GMMVI(
            target_distribution=target_distribution, initial_state=state,
            temperature=config["temperature"], selector_cfg=selector_cfg,
            estimator_type=config["ng_estimator_type"], estimator_cfg=est_cfg,
            component_stepsize_type=config[
                "component_stepsize_adapter_type"],
            component_stepsize_cfg=config[
                "component_stepsize_adapter_config"],
            weight_updater_type=config["weight_updater_type"],
            weight_updater_cfg=config["weight_updater_config"],
            weight_stepsize_type=config["weight_stepsize_adapter_type"],
            weight_stepsize_cfg=config["weight_stepsize_adapter_config"],
            vips_cfg=vips_cfg, seed=seed, device=dev)


# module slot -> the settings the port supports so far
_SUPPORTED = {
    "ng_estimator_type": ("Stein", "MORE"),
    "sample_selector_type": ("component-based",),
    "ng_based_updater_type": ("trust-region",),
    "component_stepsize_adapter_type": ("improvement-based",),
    "weight_updater_type": ("trust-region", "direct"),
    "weight_stepsize_adapter_type": ("improvement_based", "fixed"),
}

# tpu.* settings whose other values select paths not ported yet
_SUPPORTED_TPU = {
    "trust_region_search": ("bracket",),
    "db_layout": ("auto", "global"),
    "db_eviction": ("ring",),
    "debug_nans": (False,),
}


def _check_supported(config: dict) -> None:
    """Raise NotImplementedError naming the first module or setting of
    ``config`` that this slice of the port does not have."""
    for key, allowed in _SUPPORTED.items():
        if config[key] not in allowed:
            raise NotImplementedError(
                f"{key}: '{config[key]}' is not ported yet (the port has "
                f"{allowed})")
    if config["num_component_adapter_type"] not in ("adaptive",):
        raise NotImplementedError(
            f"num_component_adapter_type: "
            f"'{config['num_component_adapter_type']}' is not ported yet")
    if config["model_initialization"].get("use_diagonal_covs", False):
        raise NotImplementedError(
            "diagonal covariances are not ported yet (full covariances only)")
    tpu_cfg = config.get("tpu", {}) or {}
    for key, allowed in _SUPPORTED_TPU.items():
        if key in tpu_cfg and tpu_cfg[key] not in allowed:
            raise NotImplementedError(
                f"tpu.{key}: {tpu_cfg[key]!r} is not ported yet (the port "
                f"has {allowed})")
    for key in ("data_shards", "comp_shards"):
        if int(tpu_cfg.get(key, 1) or 1) > 1:
            raise NotImplementedError(f"tpu.{key}: meshes are not ported yet")
