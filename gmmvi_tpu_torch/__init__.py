"""gmmvi_tpu_torch: GMM variational inference in PyTorch, with hand-written
CUDA kernels for NVIDIA Hopper.

A port of the JAX package ``gmmvi_tpu`` with the same config schema,
codename letters, padded ``[Kmax, ...]`` mixture state and state field
paths.  Entry points (``GmmviRunner.build_from_config``,
``iterate_and_log``, ``GMMVI.build_from_config``, ``train_iter``,
``train_iters``, ``experiments.setup.init_experiment``) run on the CUDA
card unless given ``device="cpu"``.

:func:`state_from_numpy` and :func:`state_to_numpy` carry a training state
across as numpy arrays keyed by the JAX package's pytree paths (as its
checkpoints name them), so the two packages can be compared leaf by leaf;
a decimating database (``tpu.db_eviction: decimate``) keeps the JAX
package's ``DecimatingDbState`` paths, a sharded one (``tpu.db_layout:
sharded``) its ``[P, ...]`` leaves, of which a rank of a meshed run holds
its own shard.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from gmmvi_tpu_torch.device import resolve_device
from gmmvi_tpu_torch.models.gmm import GmmState
from gmmvi_tpu_torch.models.meta import MetaState
from gmmvi_tpu_torch.optimization.component_adaptation import AdaptationState
from gmmvi_tpu_torch.optimization.gmmvi import GMMVI, StepDraws, TrainState
from gmmvi_tpu_torch.optimization.sample_db import SampleDbState
from gmmvi_tpu_torch.optimization.sample_db_decimate import DecimatingDbState
from gmmvi_tpu_torch.optimization.sample_db_sharded import (
    SHARDED_FIELDS, ShardedSampleDbState)
from gmmvi_tpu_torch.optimization.stepsize_adapters import \
    WeightStepsizeState
from gmmvi_tpu_torch.parallel import reduce
from gmmvi_tpu_torch.runner import GmmviRunner

_PARTS = {"model": GmmState, "meta": MetaState, "db": SampleDbState,
          "wstep": WeightStepsizeState, "adapt": AdaptationState}


def _tensor_fields(cls):
    return [f.name for f in dataclasses.fields(cls)
            if f.type in ("torch.Tensor", torch.Tensor)]


def _part_classes(state: Optional[TrainState] = None,
                  named: Optional[Dict[str, np.ndarray]] = None):
    """The class of each part of ``state`` (or of the state whose leaves
    are ``named``): the database's is the decimating one where it has a
    ``count``, the sharded one where its ``write_pos`` has a shard axis."""
    if state is not None:
        return {part: type(getattr(state, part)) for part in _PARTS}
    db = SampleDbState
    if named is not None and "db.count" in named:
        db = DecimatingDbState
    elif named is not None and np.ndim(named.get("db.write_pos", 0)) == 1:
        db = ShardedSampleDbState
    return {**_PARTS, "db": db}


def state_to_numpy(state: TrainState) -> Dict[str, np.ndarray]:
    """Every tensor leaf of ``state`` as a numpy array keyed by its path
    (``model.means``, ``db.write_pos``, ..., ``num_updates``); a rank's
    shard of a sharded database as it holds it (see
    :func:`gathered_state_to_numpy`)."""
    named = {}
    for part, cls in _part_classes(state).items():
        obj = getattr(state, part)
        for name in _tensor_fields(cls):
            named[f"{part}.{name}"] = getattr(obj, name).detach().cpu(
                ).numpy()
    named["num_updates"] = np.asarray(state.num_updates, np.int32)
    return named


def state_from_numpy(named: Dict[str, np.ndarray], device="cuda",
                     like: Optional[TrainState] = None) -> TrainState:
    """The port's :class:`TrainState` from JAX ``TrainState`` leaves keyed
    by path.  The JAX ``key`` leaf has no counterpart and is ignored (the
    port draws from a generator, or from injected :class:`StepDraws`).
    Static settings (``diagonal``, ``keep_samples``, the meta-state's
    initial stepsize and regularizer) come from ``like`` when given, else
    from the dataclass defaults.  A meshed state's sharded database
    (``[P, ...]`` leaves) goes into a rank's state (``like`` with ``[n,
    ...]`` of them) as its own shards: ``n`` from ``like.db.first_shard``
    on."""
    dev = resolve_device(device)
    classes = _part_classes(like, named)
    if like is not None and isinstance(like.db, ShardedSampleDbState):
        n = like.db.n_local
        lo = like.db.first_shard
        named = {k: (v[lo:lo + n] if k[3:] in SHARDED_FIELDS
                     and k.startswith("db.") and v.shape[0] != n else v)
                 for k, v in named.items()}
    missing = [f"{part}.{name}" for part, cls in classes.items()
               for name in _tensor_fields(cls)
               if f"{part}.{name}" not in named]
    if missing or "num_updates" not in named:
        raise KeyError(f"missing state leaves: {missing or ['num_updates']}")
    parts = {}
    for part, cls in classes.items():
        kw = {name: torch.as_tensor(np.array(named[f"{part}.{name}"]),
                                    device=dev)
              for name in _tensor_fields(cls)}
        if like is not None:
            ref = getattr(like, part)
            kw.update({f.name: getattr(ref, f.name)
                       for f in dataclasses.fields(cls)
                       if f.name not in kw})
        parts[part] = cls(**kw)
    return TrainState(num_updates=int(named["num_updates"]), **parts)


def gathered_state_to_numpy(state: TrainState) -> Dict[str, np.ndarray]:
    """:func:`state_to_numpy` with a sharded database's leaves stacked from
    every rank of the current ``parallel.reduce`` scope (one all-gather
    each; call it in every rank): the JAX package's ``[P, ...]`` layout of a
    meshed state."""
    named = state_to_numpy(state)
    if isinstance(state.db, ShardedSampleDbState):
        for name in SHARDED_FIELDS:
            named[f"db.{name}"] = reduce.gather_shards(
                getattr(state.db, name)).cpu().numpy()
    return named


__all__ = ["GMMVI", "GmmviRunner", "StepDraws", "TrainState",
           "gathered_state_to_numpy", "state_from_numpy", "state_to_numpy"]
