"""Stepsize adaptation for the component updates and the weight update.

(JAX counterpart: gmmvi_tpu/optimization/stepsize_adapters.py)

Component stepsizes: fixed (codename letter F), decaying (D) and
improvement-based (R), vectorized over the padded component axis.  Weight
stepsizes: fixed (X), decaying (G) and improvement-based (N), with their
scalar state in :class:`WeightStepsizeState`.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

from gmmvi_tpu_torch.device import resolve_device
from gmmvi_tpu_torch.models.gmm import GmmState
from gmmvi_tpu_torch.models.meta import MetaState
from gmmvi_tpu_torch.ops.stable import F32_MIN


def fixed_component_stepsize(meta: MetaState, config: dict) -> torch.Tensor:
    """The stepsizes stay at their initial values."""
    return meta.stepsizes


def decaying_component_stepsize(meta: MetaState, config: dict
                                ) -> torch.Tensor:
    """``s0 / (1 + n^exponent)`` per component, ``n`` the updates it has
    received."""
    return config["initial_stepsize"] / (
        1.0 + torch.pow(meta.num_received_updates,
                        config["annealing_exponent"]))


def improvement_based_component_stepsize(meta: MetaState, config: dict
                                         ) -> torch.Tensor:
    """Grow a component's stepsize when its reward improved, else shrink."""
    improved = meta.reward_history[:, -1] > meta.reward_history[:, -2]
    inc = torch.clamp(config["stepsize_inc_factor"] * meta.stepsizes,
                      max=config["max_stepsize"])
    dec = torch.clamp(config["stepsize_dec_factor"] * meta.stepsizes,
                      min=config["min_stepsize"])
    return torch.where(improved, inc, dec)


COMPONENT_STEPSIZE_ADAPTERS = {
    "fixed": fixed_component_stepsize,
    "decaying": decaying_component_stepsize,
    "improvement-based": improvement_based_component_stepsize,
}


@dataclass
class WeightStepsizeState:
    stepsize: torch.Tensor     # 0-d
    num_updates: torch.Tensor  # 0-d (decaying adapter)
    prev_elbo: torch.Tensor    # 0-d (improvement-based adapter)

    def replace(self, **kw) -> "WeightStepsizeState":
        return dataclasses.replace(self, **kw)


def create_weight_stepsize_state(initial_stepsize: float, device="cuda"
                                 ) -> WeightStepsizeState:
    f32 = dict(dtype=torch.float32, device=resolve_device(device))
    return WeightStepsizeState(
        stepsize=torch.tensor(initial_stepsize, **f32),
        num_updates=torch.tensor(0.0, **f32),
        prev_elbo=torch.tensor(F32_MIN, **f32),
    )


def improvement_based_weight_stepsize(state: WeightStepsizeState,
                                      model: GmmState, meta: MetaState,
                                      config: dict) -> WeightStepsizeState:
    """Track the ELBO estimate sum_o w_o R_o - sum_o w_o log w_o and grow
    the stepsize when it improved, else shrink it."""
    w = model.weights
    mask = model.mask
    elbo = torch.sum(w * torch.where(mask, meta.reward_history[:, -1], 0.0)) \
        - torch.sum(torch.where(mask, w * model.log_weights, 0.0))
    improved = elbo > state.prev_elbo
    inc = torch.clamp(config["stepsize_inc_factor"] * state.stepsize,
                      max=config["max_stepsize"])
    dec = torch.clamp(config["stepsize_dec_factor"] * state.stepsize,
                      min=config["min_stepsize"])
    return state.replace(stepsize=torch.where(improved, inc, dec),
                         prev_elbo=elbo)


def fixed_weight_stepsize(state: WeightStepsizeState, model: GmmState,
                          meta: MetaState, config: dict
                          ) -> WeightStepsizeState:
    """The stepsize stays at its initial value."""
    return state


def decaying_weight_stepsize(state: WeightStepsizeState, model: GmmState,
                             meta: MetaState, config: dict
                             ) -> WeightStepsizeState:
    """``s0 / (1 + n^exponent)``, ``n`` the weight updates so far.  The
    reference's default exponent is 0.5 (its YAML marks it TODO); it is
    kept."""
    new = config["initial_stepsize"] / (
        1.0 + torch.pow(state.num_updates, config["annealing_exponent"]))
    return state.replace(stepsize=new, num_updates=state.num_updates + 1.0)


# the weight adapter's name uses an underscore, as in the reference configs
WEIGHT_STEPSIZE_ADAPTERS = {
    "fixed": fixed_weight_stepsize,
    "decaying": decaying_weight_stepsize,
    "improvement_based": improvement_based_weight_stepsize,
}
