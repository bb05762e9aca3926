"""Config system: 7-letter codenames and layered merging.

(JAX counterpart: gmmvi_tpu/configs/__init__.py)

The module defaults each codename letter selects, and the ``stm20``,
``stm300``, ``gmm20``, ``gmm100``, ``breast_cancer``, ``breast_cancer_mb``,
``german_credit``, ``german_credit_mb``, ``planar_robot_4``, ``talos``
and ``wine`` experiment defaults, are kept here as Python dicts: the port reads no YAML at run
time.  They equal the YAML
files of the JAX package
(``gmmvi_tpu/configs/module_configs`` and ``experiment_configs``); a CPU test
holds them to it.
"""
from __future__ import annotations

import copy
from typing import Mapping

# letter -> the module default it selects (one per module slot)
LETTER_DEFAULTS = {
    "Z": {"ng_estimator_type": "MORE",
          "ng_estimator_config": {
              "initial_l2_regularizer": 1.0e-12,
              "only_use_own_samples": False,
              "use_self_normalized_importance_weights": True}},
    "S": {"ng_estimator_type": "Stein",
          "ng_estimator_config": {
              "only_use_own_samples": False,
              "use_self_normalized_importance_weights": True}},
    "A": {"num_component_adapter_type": "adaptive",
          "num_component_adapter_config": {
              "del_iters": 100, "add_iters": 30, "max_components": 1000,
              "thresholds_for_add_heuristic": [5000.0, 1000.0, 500.0, 200.0,
                                               100.0, 50.0],
              "min_weight_for_del_heuristic": 1.0e-6,
              "num_database_samples": 100000, "num_prior_samples": 0}},
    "E": {"num_component_adapter_type": "fixed",
          "num_component_adapter_config": {}},
    "P": {"sample_selector_type": "mixture-based",
          "sample_selector_config": {
              "desired_samples_per_component": 100,
              "ratio_reused_samples_to_desired": 0.0}},
    "M": {"sample_selector_type": "component-based",
          "sample_selector_config": {
              "desired_samples_per_component": 100,
              "ratio_reused_samples_to_desired": 2.0}},
    "I": {"ng_based_updater_type": "direct", "ng_based_updater_config": {}},
    "Y": {"ng_based_updater_type": "iBLR", "ng_based_updater_config": {}},
    "T": {"ng_based_updater_type": "trust-region",
          "ng_based_updater_config": {}},
    "F": {"component_stepsize_adapter_type": "fixed",
          "component_stepsize_adapter_config": {"initial_stepsize": 1.0e-5}},
    "D": {"component_stepsize_adapter_type": "decaying",
          "component_stepsize_adapter_config": {
              "initial_stepsize": 1.0, "annealing_exponent": 0.55}},
    "R": {"component_stepsize_adapter_type": "improvement-based",
          "component_stepsize_adapter_config": {
              "initial_stepsize": 1.0, "min_stepsize": 0.001,
              "max_stepsize": 1.0, "stepsize_inc_factor": 1.15,
              "stepsize_dec_factor": 0.85}},
    "U": {"weight_updater_type": "direct",
          "weight_updater_config": {
              "use_self_normalized_importance_weights": True}},
    "O": {"weight_updater_type": "trust-region",
          "weight_updater_config": {
              "use_self_normalized_importance_weights": True}},
    "X": {"weight_stepsize_adapter_type": "fixed",
          "weight_stepsize_adapter_config": {"initial_stepsize": 1.0}},
    "G": {"weight_stepsize_adapter_type": "decaying",
          "weight_stepsize_adapter_config": {
              "initial_stepsize": 1.0, "annealing_exponent": 0.5}},
    "N": {"weight_stepsize_adapter_type": "improvement_based",
          "weight_stepsize_adapter_config": {
              "initial_stepsize": 1.0, "min_stepsize": 0.0001,
              "max_stepsize": 1.0, "stepsize_inc_factor": 1.15,
              "stepsize_dec_factor": 0.85}},
}

_GMM_DEFAULTS = {
    "start_seed": 10000,
    "environment_name": "GMM",
    "model_initialization": {"use_diagonal_covs": False,
                             "num_initial_components": 1,
                             "prior_mean": 0.0, "prior_scale": 31.63,
                             "initial_cov": 1000.0},
    "gmmvi_runner_config": {"log_metrics_interval": 100},
    "use_sample_database": True,
    "max_database_size": 10000000,
    "temperature": 1.0,
}

# the logistic-regression posteriors: one broad component grown by VIPS
_LR_DEFAULTS = {
    "start_seed": 10000,
    "environment_config": {},
    "model_initialization": {"use_diagonal_covs": False,
                             "num_initial_components": 1,
                             "prior_mean": 0.0, "prior_scale": 10.0,
                             "initial_cov": 100.0},
    "gmmvi_runner_config": {"log_metrics_interval": 20},
    "use_sample_database": True,
    "max_database_size": 10000000,
    "temperature": 1.0,
}
_MINIBATCH = {"batch_size": 64, "size_test_set": 0,
              "use_own_batch_per_sample": True}

EXPERIMENT_DEFAULTS = {
    "breast_cancer": {**_LR_DEFAULTS, "environment_name": "breastCancer",
                      "gmmvi_runner_config": {"log_metrics_interval": 50}},
    "breast_cancer_mb": {**_LR_DEFAULTS,
                         "environment_name": "breastCancer_mb",
                         "environment_config": _MINIBATCH},
    "german_credit": {**_LR_DEFAULTS, "environment_name": "GermanCredit"},
    "german_credit_mb": {**_LR_DEFAULTS,
                         "environment_name": "GermanCredit_mb",
                         "environment_config": _MINIBATCH},
    "planar_robot_4": {
        "start_seed": 10000,
        "environment_name": "PlanarRobot4",
        "environment_config": {},
        "model_initialization": {
            "use_diagonal_covs": False, "num_initial_components": 300,
            "prior_mean": 0.0, "prior_scale": [1.0] + [0.2] * 9,
            "initial_cov": [0.0625] + [0.0025] * 9},
        "gmmvi_runner_config": {"log_metrics_interval": 10},
        "use_sample_database": True,
        "max_database_size": 10000000,
        "temperature": 1.0,
    },
    "talos": {
        "start_seed": 10000,
        "environment_name": "Talos",
        "environment_config": {"context": [0.1, 0.5, 1.0]},
        "model_initialization": {"use_diagonal_covs": False,
                                 "num_initial_components": 1,
                                 "prior_mean": 0.0, "prior_scale": 1.0,
                                 "initial_cov": 1.0},
        "gmmvi_runner_config": {"log_metrics_interval": 500},
        "use_sample_database": True,
        "max_database_size": 500000,
        "temperature": 1.0,
    },
    "wine": {
        "start_seed": 10000,
        "environment_name": "WINE",
        "environment_config": {"likelihood_scaling": 1.0, "prior_std": 1.0,
                               "batch_size": 128},
        "model_initialization": {"use_diagonal_covs": False,
                                 "num_initial_components": 4,
                                 "prior_mean": 0.0, "prior_scale": 1.0,
                                 "initial_cov": 1.0},
        "gmmvi_runner_config": {"log_metrics_interval": 25},
        "use_sample_database": True,
        "max_database_size": 500000,
        "temperature": 1.0,
    },
    "gmm20": {**_GMM_DEFAULTS, "environment_config": {"num_dimensions": 20}},
    "gmm100": {**_GMM_DEFAULTS,
               "environment_config": {"num_dimensions": 100}},
    "stm20": {
        "start_seed": 10000,
        "environment_name": "STM",
        "environment_config": {"num_dimensions": 20,
                               "harder_setting": False,
                               "use_matlab_target": False},
        "model_initialization": {"use_diagonal_covs": False,
                                 "num_initial_components": 20,
                                 "prior_mean": 0.0, "prior_scale": 100.0,
                                 "initial_cov": 300.0},
        "gmmvi_runner_config": {"log_metrics_interval": 1000},
        "use_sample_database": True,
        "max_database_size": 10000000,
        "temperature": 1.0,
    },
    "stm300": {
        "start_seed": 10000,
        "environment_name": "STM",
        "environment_config": {"num_dimensions": 300,
                               "harder_setting": True,
                               "use_matlab_target": False},
        "model_initialization": {"use_diagonal_covs": False,
                                 "num_initial_components": 20,
                                 "prior_mean": 0.0, "prior_scale": 100.0,
                                 "initial_cov": 300.0},
        "gmmvi_runner_config": {"log_metrics_interval": 50},
        "use_sample_database": True,
        "max_database_size": 100000,
        "temperature": 1.0,
    },
}

# module slot -> the codename letters that fill it
ALL_CODENAME_LETTERS = {
    "ng_estimator": "SZ",
    "component_adaptation": "AE",
    "sample_selector": "MP",
    "ng_based_component_updater": "TIY",
    "component_stepsize_adaptation": "RFD",
    "weight_updater": "OU",
    "weight_stepsize_adaptation": "NXG",
}


def load_yaml(filename: str) -> dict:
    """The YAML file ``filename`` as a dict (a user's config file, as the
    examples read theirs; the defaults above are not read from YAML)."""
    import yaml

    with open(filename, "r") as stream:
        return yaml.safe_load(stream)


def _deep_merge(base: dict, updates: Mapping) -> dict:
    """In-place deep merge with replace semantics for non-dict leaves."""
    for key, value in updates.items():
        if key in base and isinstance(base[key], dict) \
                and isinstance(value, Mapping):
            _deep_merge(base[key], value)
        else:
            base[key] = copy.deepcopy(value)
    return base


def get_default_algorithm_config(algorithm_id: str) -> dict:
    """Merge the module default of each codename letter."""
    merged: dict = {}
    for letter in algorithm_id:
        letter = letter.upper()
        if letter not in LETTER_DEFAULTS:
            raise ValueError(
                f"unknown codename letter '{letter}' in '{algorithm_id}'")
        _deep_merge(merged, LETTER_DEFAULTS[letter])
    return merged


def get_default_experiment_config(experiment_id: str) -> dict:
    if experiment_id not in EXPERIMENT_DEFAULTS:
        raise NotImplementedError(
            f"experiment config '{experiment_id}' is not ported yet "
            f"(available: {sorted(EXPERIMENT_DEFAULTS)})")
    return copy.deepcopy(EXPERIMENT_DEFAULTS[experiment_id])


def get_default_config(algorithm_id: str, experiment_id: str) -> dict:
    return {**get_default_algorithm_config(algorithm_id),
            **get_default_experiment_config(experiment_id)}


def update_config(default_values: dict, updates: Mapping) -> dict:
    updated = copy.deepcopy(dict(default_values))
    return _deep_merge(updated, updates)


from gmmvi_tpu_torch.configs.validate import (  # noqa: E402
    ConfigError, validate_config)
