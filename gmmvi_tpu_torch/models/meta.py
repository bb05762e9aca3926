"""Per-component learner meta-state.

(JAX counterpart: gmmvi_tpu/models/meta.py)

Padded companion of :class:`~gmmvi_tpu_torch.models.gmm.GmmState`; add and
remove keep it in step with the model by the same slot write and
compaction gather.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

from gmmvi_tpu_torch.models import gmm as gmm_ops
from gmmvi_tpu_torch.models.gmm import GmmState
from gmmvi_tpu_torch.ops.stable import F32_MIN


@dataclass
class MetaState:
    """``reward_history`` / ``weight_history`` are rolling windows, newest
    entry last."""

    l2_regularizers: torch.Tensor       # [Kmax]
    last_etas: torch.Tensor             # [Kmax]; -1 = no warm start
    num_received_updates: torch.Tensor  # [Kmax] float
    stepsizes: torch.Tensor             # [Kmax]
    reward_history: torch.Tensor        # [Kmax, H], init F32_MIN
    weight_history: torch.Tensor        # [Kmax, H], init F32_MIN
    unique_component_ids: torch.Tensor  # [Kmax] int32
    max_component_id: torch.Tensor      # 0-d int32
    adding_thresholds: torch.Tensor     # [Kmax]
    initial_entropies: torch.Tensor     # [Kmax]
    initial_stepsize: float = 1.0
    initial_regularizer: float = 1e-12

    @property
    def max_components(self) -> int:
        return self.stepsizes.shape[0]

    def replace(self, **kw) -> "MetaState":
        return dataclasses.replace(self, **kw)


def create_meta_state(model: GmmState, initial_stepsize: float,
                      initial_regularizer: float,
                      max_reward_history_length: int) -> MetaState:
    kmax, h = model.max_components, max_reward_history_length
    f32 = dict(dtype=torch.float32, device=model.device)
    return MetaState(
        l2_regularizers=torch.full((kmax,), initial_regularizer, **f32),
        last_etas=torch.full((kmax,), -1.0, **f32),
        num_received_updates=torch.zeros((kmax,), **f32),
        stepsizes=torch.full((kmax,), initial_stepsize, **f32),
        reward_history=torch.full((kmax, h), F32_MIN, **f32),
        weight_history=torch.full((kmax, h), F32_MIN, **f32),
        unique_component_ids=torch.arange(kmax, dtype=torch.int32,
                                          device=model.device),
        max_component_id=torch.tensor(kmax - 1, dtype=torch.int32,
                                      device=model.device),
        adding_thresholds=torch.full((kmax,), -1.0, **f32),
        initial_entropies=gmm_ops.component_entropies(model),
        initial_stepsize=float(initial_stepsize),
        initial_regularizer=float(initial_regularizer),
    )


def history_length_from_config(config: dict) -> int:
    """2 * max(2, del_iters) with VIPS adaptation configured, else 2."""
    adapter_cfg = config.get("num_component_adapter_config", {}) or {}
    if "del_iters" in adapter_cfg:
        return 2 * max(2, int(adapter_cfg["del_iters"]))
    return 2


def store_rewards(meta: MetaState, rewards: torch.Tensor) -> MetaState:
    hist = torch.cat([meta.reward_history[:, 1:], rewards[:, None]], dim=1)
    return meta.replace(reward_history=hist)


def store_weights(meta: MetaState, weights: torch.Tensor) -> MetaState:
    hist = torch.cat([meta.weight_history[:, 1:], weights[:, None]], dim=1)
    return meta.replace(weight_history=hist)


def add_component_meta(meta: MetaState, slot: torch.Tensor,
                       has_room: torch.Tensor, initial_weight,
                       adding_threshold, initial_entropy) -> MetaState:
    """Meta-state of a component added at ``slot``: reward row F32_MIN,
    weight row the raw initial weight, a fresh unique id."""
    at = (torch.arange(meta.max_components, device=slot.device) == slot) \
        & has_room

    def setrow(arr, value):
        return torch.where(at, torch.as_tensor(value, dtype=arr.dtype,
                                               device=arr.device), arr)

    new_id = meta.max_component_id + 1
    return meta.replace(
        l2_regularizers=setrow(meta.l2_regularizers, meta.initial_regularizer),
        last_etas=setrow(meta.last_etas, -1.0),
        num_received_updates=setrow(meta.num_received_updates, 0.0),
        stepsizes=setrow(meta.stepsizes, meta.initial_stepsize),
        reward_history=torch.where(at[:, None], F32_MIN, meta.reward_history),
        weight_history=torch.where(
            at[:, None], torch.as_tensor(initial_weight, dtype=torch.float32,
                                         device=slot.device),
            meta.weight_history),
        unique_component_ids=setrow(meta.unique_component_ids, new_id),
        max_component_id=torch.where(has_room, new_id,
                                     meta.max_component_id).to(torch.int32),
        adding_thresholds=setrow(meta.adding_thresholds, adding_threshold),
        initial_entropies=setrow(meta.initial_entropies, initial_entropy),
    )


def remove_components_meta(meta: MetaState, order: torch.Tensor
                           ) -> MetaState:
    """Apply the model's compaction permutation."""
    return meta.replace(
        l2_regularizers=meta.l2_regularizers[order],
        last_etas=meta.last_etas[order],
        num_received_updates=meta.num_received_updates[order],
        stepsizes=meta.stepsizes[order],
        reward_history=meta.reward_history[order],
        weight_history=meta.weight_history[order],
        unique_component_ids=meta.unique_component_ids[order],
        adding_thresholds=meta.adding_thresholds[order],
        initial_entropies=meta.initial_entropies[order],
    )
