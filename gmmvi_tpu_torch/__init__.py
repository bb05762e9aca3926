"""gmmvi_tpu_torch: GMM variational inference in PyTorch, with hand-written
CUDA kernels for NVIDIA Hopper.

A port of the JAX package ``gmmvi_tpu`` with the same config schema,
codename letters, padded ``[Kmax, ...]`` mixture state and state field
paths.  Entry points (``GMMVI.build_from_config``, ``train_iter``,
``train_iters``, ``experiments.setup.init_experiment``) run on the CUDA
card unless given ``device="cpu"``.

:func:`state_from_numpy` and :func:`state_to_numpy` carry a training state
across as numpy arrays keyed by the JAX package's pytree paths (as its
checkpoints name them), so the two packages can be compared leaf by leaf.
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
from gmmvi_tpu_torch.optimization.stepsize_adapters import \
    WeightStepsizeState

_PARTS = {"model": GmmState, "meta": MetaState, "db": SampleDbState,
          "wstep": WeightStepsizeState, "adapt": AdaptationState}


def _tensor_fields(cls):
    return [f.name for f in dataclasses.fields(cls)
            if f.type in ("torch.Tensor", torch.Tensor)]


def state_to_numpy(state: TrainState) -> Dict[str, np.ndarray]:
    """Every tensor leaf of ``state`` as a numpy array keyed by its path
    (``model.means``, ``db.write_pos``, ..., ``num_updates``)."""
    named = {}
    for part, cls in _PARTS.items():
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
    from the dataclass defaults."""
    dev = resolve_device(device)
    missing = [f"{part}.{name}" for part, cls in _PARTS.items()
               for name in _tensor_fields(cls)
               if f"{part}.{name}" not in named]
    if missing or "num_updates" not in named:
        raise KeyError(f"missing state leaves: {missing or ['num_updates']}")
    parts = {}
    for part, cls in _PARTS.items():
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


__all__ = ["GMMVI", "StepDraws", "TrainState", "state_from_numpy",
           "state_to_numpy"]
