"""Experiment setup: target registry and initial-mixture construction.

(JAX counterpart: gmmvi_tpu/experiments/setup.py)

Initial means are drawn from ``np.random.RandomState(seed)`` exactly as the
JAX package draws them, so one seed gives the same initial mixture in both.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from gmmvi_tpu_torch.device import resolve_device
from gmmvi_tpu_torch.experiments.targets.lnpdf import LNPDF
from gmmvi_tpu_torch.models import meta as meta_ops
from gmmvi_tpu_torch.models.gmm import GmmState, create_gmm_state
from gmmvi_tpu_torch.models.meta import MetaState


def get_target_lnpdf(experiment: str, environment_config: dict, seed: int,
                     device="cuda") -> LNPDF:
    """Environment-name registry; the port has the Student-T mixture
    ("STM") so far.  The target is seeded with the run seed unless
    ``environment_config`` names its own."""
    environment_config = dict(environment_config or {})
    target_seed = environment_config.pop("seed", seed)
    if experiment == "STM":
        from gmmvi_tpu_torch.experiments.targets.student_t_mixture import \
            make_target
        return make_target(seed=target_seed, device=device,
                           **environment_config)
    raise NotImplementedError(
        f"target '{experiment}' is not ported yet (the port has STM)")


def construct_initial_mixture(
    num_dimensions: int,
    num_initial_components: int,
    prior_mean,
    prior_scale,
    use_diagonal_covs: bool,
    initial_cov=None,
    max_components: Optional[int] = None,
    rng: Optional[np.random.RandomState] = None,
    device="cuda",
) -> GmmState:
    """K components with means ~ N(prior_mean, prior_scale^2) (a single
    component sits at the prior mean) and the given isotropic initial
    covariance, padded to ``max_components`` slots."""
    if use_diagonal_covs:
        raise NotImplementedError(
            "diagonal covariances are not ported yet (full covariances only)")
    if rng is None:
        rng = np.random.RandomState()
    prior_mean = np.asarray(prior_mean, np.float64) * np.ones(num_dimensions)
    prior_scale = np.asarray(prior_scale, np.float64) * np.ones(num_dimensions)
    prior_var = prior_scale ** 2

    k = num_initial_components
    weights = np.ones(k, np.float32) / k
    means = np.zeros((k, num_dimensions), np.float32)
    for i in range(k):
        if k == 1:
            means[i] = prior_mean
        else:
            means[i] = prior_mean + np.sqrt(prior_var) * rng.standard_normal(
                num_dimensions)

    if initial_cov is None:
        cov = np.diag(prior_var)
    else:
        ic = np.asarray(initial_cov, np.float64)
        cov = np.diag(ic * np.ones(num_dimensions)) if ic.ndim <= 1 else ic
    covs = np.tile(cov[None, :, :], (k, 1, 1)).astype(np.float32)
    return create_gmm_state(weights, means, covs,
                            max_components=max_components or k,
                            device=resolve_device(device))


def default_max_components(config: dict, num_initial: int) -> int:
    """Padded capacity: ``tpu.max_components`` when set, else headroom for
    VIPS growth rounded up to a multiple of 8 (as in the JAX package)."""
    tpu_cfg = config.get("tpu", {}) or {}
    if "max_components" in tpu_cfg:
        return int(tpu_cfg["max_components"])
    if config.get("num_component_adapter_type") == "adaptive":
        cap = int(config["num_component_adapter_config"]["max_components"])
        guess = min(cap, max(2 * num_initial, num_initial + 16))
    else:
        guess = num_initial
    return ((guess + 7) // 8) * 8


def init_experiment(config: dict, device="cuda"
                    ) -> Tuple[LNPDF, GmmState, MetaState]:
    """Target, initial model and meta-state from a config dict."""
    dev = resolve_device(device)
    seed = int(config.get("seed", config.get("start_seed", 0)))
    if "environment_config" in config and "environment_name" in config \
            and "target_fn" not in config:
        target = get_target_lnpdf(config["environment_name"],
                                  config["environment_config"], seed,
                                  device=dev)
    elif "target_fn" in config:
        target = config["target_fn"]
    else:
        raise ValueError("No target distribution was specified")

    mi = config["model_initialization"]
    num_initial = int(mi["num_initial_components"])
    model = construct_initial_mixture(
        num_dimensions=target.get_num_dimensions(),
        num_initial_components=num_initial,
        prior_mean=mi["prior_mean"],
        prior_scale=mi["prior_scale"],
        use_diagonal_covs=bool(mi["use_diagonal_covs"]),
        initial_cov=mi.get("initial_cov"),
        max_components=default_max_components(config, num_initial),
        rng=np.random.RandomState(seed),
        device=dev,
    )
    meta = meta_ops.create_meta_state(
        model,
        initial_stepsize=config["component_stepsize_adapter_config"][
            "initial_stepsize"],
        initial_regularizer=config.get("ng_estimator_config", {}).get(
            "initial_l2_regularizer", 1e-12),
        max_reward_history_length=int(
            (config.get("tpu", {}) or {}).get(
                "max_reward_history_length",
                meta_ops.history_length_from_config(config))),
    )
    return target, model, meta
