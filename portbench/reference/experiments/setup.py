"""Experiment setup: target registry and initial-mixture construction.

(JAX counterpart: gmmvi_tpu/experiments/setup.py)

Initial means are drawn from ``np.random.RandomState(seed)`` exactly as the
JAX package draws them, so one seed gives the same initial mixture in both.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from portbench.reference.device import resolve_device
from portbench.reference.experiments.targets.lnpdf import LNPDF
from portbench.reference.models import meta as meta_ops
from portbench.reference.models.gmm import GmmState, create_gmm_state
from portbench.reference.models.meta import MetaState


def get_target_lnpdf(experiment: str, environment_config: dict, seed: int,
                     device="cuda", dtype=None) -> LNPDF:
    """The targets of the benchmark's experiments: the planar robots
    ("PlanarRobot1", "PlanarRobot4").  An unknown name raises ValueError.  ``dtype`` (default float32) is the
    target's arithmetic."""
    import torch

    dtype = torch.float32 if dtype is None else dtype
    if experiment in ("PlanarRobot1", "PlanarRobot4"):
        from portbench.reference.experiments.targets import planar_robot
        maker = (planar_robot.make_single_goal if experiment.endswith("1")
                 else planar_robot.make_four_goal)
        return maker(device=device, dtype=dtype)
    raise ValueError(f"unknown environment {experiment!r}")


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
    component sits at the prior mean) and the given isotropic or diagonal
    initial covariance, padded to ``max_components`` slots."""
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

    if use_diagonal_covs:
        cov_diag = (prior_var if initial_cov is None else
                    np.asarray(initial_cov, np.float64)
                    * np.ones(num_dimensions))
        covs = np.tile(cov_diag[None, :], (k, 1)).astype(np.float32)
    else:
        if initial_cov is None:
            cov = np.diag(prior_var)
        else:
            ic = np.asarray(initial_cov, np.float64)
            cov = np.diag(ic * np.ones(num_dimensions)) if ic.ndim <= 1 \
                else ic
        covs = np.tile(cov[None, :, :], (k, 1, 1)).astype(np.float32)
    return create_gmm_state(weights, means, covs,
                            max_components=max_components or k,
                            diagonal=use_diagonal_covs,
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
