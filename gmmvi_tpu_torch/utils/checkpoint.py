"""Checkpoint and resume of the full training state.

(JAX counterpart: gmmvi_tpu/utils/checkpoint.py, file format v2)

One ``.npz`` file holds every leaf of a :class:`TrainState` under
``leaf::<path>`` (the JAX package's pytree paths: ``model.means``,
``db.write_pos``, ..., ``num_updates``), beside ``__format_version__`` and
``__structure_hash__`` (a fingerprint of the paths, shapes and dtypes).  The
port keeps its random state in a ``torch.Generator`` rather than a key: its
state goes under the leaf ``generator``, so a resumed run draws what an
unbroken one would.

A checkpoint of the JAX package loads too: its ``key`` leaf is ignored and
the generator is left as it is.  Loading into a state whose paths or shapes
differ raises, naming them; a dtype-only difference warns and converts.

A meshed run saves one file in the JAX package's layout: every rank calls
:func:`save_state` inside its ``parallel.reduce`` scope, a sharded
database's ``[P, ...]`` leaves are gathered from the ranks, and only rank 0
writes.  Every rank loads the file and keeps its own shard.
"""
from __future__ import annotations

import hashlib
import warnings
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

FORMAT_VERSION = 2
GENERATOR_LEAF = "generator"
_IGNORED_LEAVES = ("key",)   # the JAX package's PRNG key


def _leaf_specs(state) -> Dict[str, Tuple[tuple, np.dtype]]:
    """(shape, numpy dtype) of every leaf of ``state`` by path, read without
    copying the state to the host."""
    from gmmvi_tpu_torch import _part_classes, _tensor_fields

    specs = {}
    for part, cls in _part_classes(state).items():
        obj = getattr(state, part)
        for name in _tensor_fields(cls):
            t = getattr(obj, name)
            specs[f"{part}.{name}"] = (
                tuple(t.shape), np.dtype(str(t.dtype).replace("torch.", "")))
    specs["num_updates"] = ((), np.dtype(np.int32))
    return specs


def structure_hash(specs: Dict[str, Tuple[tuple, np.dtype]]) -> str:
    """Fingerprint of leaf paths, shapes and dtypes (the JAX package's)."""
    desc = ";".join(f"{k}:{shape}:{dtype}"
                    for k, (shape, dtype) in sorted(specs.items()))
    return hashlib.sha256(desc.encode()).hexdigest()[:16]


def save_state(path: str, state,
               generator: Optional[torch.Generator] = None) -> None:
    """Save ``state`` (and ``generator``'s state) to ``path`` (.npz)."""
    from gmmvi_tpu_torch import gathered_state_to_numpy

    named = gathered_state_to_numpy(state)
    if dist.is_initialized() and dist.get_rank() != 0:
        return
    if generator is not None:
        named[GENERATOR_LEAF] = generator.get_state().numpy()
    specs = {k: (tuple(v.shape), v.dtype) for k, v in named.items()}
    np.savez(path, __format_version__=np.asarray(FORMAT_VERSION),
             __structure_hash__=np.asarray(structure_hash(specs)),
             **{f"leaf::{k}": v for k, v in named.items()})


def stored_max_components(path: str) -> int:
    """The padded component capacity of the state saved at ``path`` (0 if
    the file holds no model; :func:`load_state` then names what is
    missing)."""
    with np.load(path, allow_pickle=False) as data:
        if "leaf::model.log_weights" not in data:
            return 0
        return int(data["leaf::model.log_weights"].shape[0])


def load_state(path: str, like, device="cuda"):
    """``(state, generator_state)`` from ``path``: the state built with the
    structure of ``like`` (a freshly built state of the same config and
    capacity) on ``device``, and the saved generator state as a uint8
    tensor (None for a file without one, such as the JAX package's).  A
    rank of a meshed run takes its own shards of a sharded database (from
    ``like.db.first_shard`` on)."""
    from gmmvi_tpu_torch import state_from_numpy
    from gmmvi_tpu_torch.optimization.sample_db_sharded import (
        SHARDED_FIELDS, ShardedSampleDbState)

    with np.load(path, allow_pickle=False) as data:
        if "__format_version__" not in data:
            raise ValueError(f"{path} is not a gmmvi checkpoint (no format "
                             "version); files before format v2 are not "
                             "supported")
        version = int(data["__format_version__"])
        if version > FORMAT_VERSION:
            raise ValueError(f"checkpoint format v{version} is newer than "
                             f"supported v{FORMAT_VERSION}")
        stored = {k[len("leaf::"):]: data[k] for k in data.files
                  if k.startswith("leaf::")}
    if isinstance(like.db, ShardedSampleDbState):
        n = like.db.n_local
        lo = like.db.first_shard
        stored.update({f"db.{k}": stored[f"db.{k}"][lo:lo + n]
                       for k in SHARDED_FIELDS if f"db.{k}" in stored})
    expected = _leaf_specs(like)
    missing = sorted(set(expected) - set(stored))
    extra = sorted(set(stored) - set(expected) - {GENERATOR_LEAF,
                                                  *_IGNORED_LEAVES})
    if missing or extra:
        raise ValueError(
            "checkpoint structure mismatch: "
            + (f"missing in file: {missing[:5]}; " if missing else "")
            + (f"not in target state: {extra[:5]}; " if extra else "")
            + "was the config (capacities, selector sizes, module types) "
            "changed since saving?")
    bad_shapes = [k for k, (shape, _) in expected.items()
                  if tuple(stored[k].shape) != shape]
    if bad_shapes:
        detail = ", ".join(f"{k}: file {stored[k].shape} vs state "
                           f"{expected[k][0]}" for k in bad_shapes[:5])
        raise ValueError(
            f"checkpoint leaf shapes differ ({detail}): rebuild with the "
            "same capacities (tpu.max_components, window sizes) or grow "
            "the capacity before loading")
    bad_dtypes = [k for k, (_, dtype) in expected.items()
                  if stored[k].dtype != dtype]
    if bad_dtypes:
        warnings.warn("checkpoint leaf dtypes differ from the target state "
                      f"({bad_dtypes[:5]}); converting to the target dtypes")
    named = {k: stored[k].astype(dtype, copy=False)
             for k, (_, dtype) in expected.items()}
    gen = stored.get(GENERATOR_LEAF)
    return (state_from_numpy(named, device=device, like=like),
            None if gen is None else torch.from_numpy(gen.copy()))
