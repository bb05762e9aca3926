"""Every collective of a meshed training step.

(No JAX twin: the JAX package leaves these to XLA's SPMD partitioner,
which inserts a ``psum`` wherever a contraction runs over the sharded
sample axis and an all-gather wherever a sharded batch meets a replicated
buffer.  The port has no partitioner, so the step calls them here.)

A step runs inside :func:`scope` with the run's ``DeviceMesh``; outside
a scope (an unmeshed run), and for a dimension the mesh does not have,
every function is the identity or the plain local reduction, so the
unmeshed step is unchanged to the bit.  Inside:

* ``data`` axis: :func:`data_sum`, :func:`data_max`,
  :func:`data_masked_logsumexp` and :func:`data_signed_weighted_logsumexp`
  reduce the rank's partial over the sample rows of every rank of its data
  group; :func:`rows` gives the rank its block of a replicated batch and
  :func:`gather_rows` puts the blocks together again (the global ring's
  write); :func:`gather_shards` stacks the sharded database's per-rank
  ``[1, ...]`` leaves into the JAX package's ``[P, ...]``;
* ``comp`` axis (a hybrid mesh): :func:`comp_range` is the rank's slice of
  the component axis and :func:`comp_gather` gathers the slices back.

Only ``all_reduce`` and ``all_gather`` are used, which gloo has for CUDA
tensors, so ranks that share one card run over gloo.  Uneven blocks are
padded to the largest for the gather and trimmed after it.  With two ranks
on an axis a sum is ``a + b`` on both (IEEE addition commutes), so the
replicated state stays equal to the bit on every rank.

:data:`STATS` counts the collectives and the bytes each rank sends; with a
:class:`~gmmvi_tpu_torch.utils.profiling.PhaseTimers` in :data:`TIMERS`,
every collective is timed under ``"collectives"`` (the card is
synchronized first, so the wait for earlier work is not counted).
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Iterator, List, Optional, Tuple

import torch
import torch.distributed as dist

from gmmvi_tpu_torch.ops.stable import (masked_logsumexp,
                                        signed_weighted_logsumexp)

STATS = {"collectives": 0, "bytes": 0}
TIMERS = None   # a utils.profiling.PhaseTimers, or None


@dataclass
class _Axis:
    group: Optional[dist.ProcessGroup]
    size: int
    rank: int


@dataclass
class _Scope:
    data: _Axis
    comp: _Axis


_SCOPE: Optional[_Scope] = None


def _axis(mesh, name: str) -> _Axis:
    if mesh is None or name not in (mesh.mesh_dim_names or ()):
        return _Axis(None, 1, 0)
    return _Axis(mesh.get_group(name), mesh.size(
        mesh.mesh_dim_names.index(name)), mesh.get_local_rank(name))


@contextlib.contextmanager
def scope(mesh) -> Iterator[None]:
    """Run the enclosed step on ``mesh`` (a ``DeviceMesh`` with a
    ``data`` and maybe a ``comp`` dimension); None: unmeshed."""
    global _SCOPE
    prev = _SCOPE
    _SCOPE = None if mesh is None else _Scope(_axis(mesh, "data"),
                                              _axis(mesh, "comp"))
    try:
        yield
    finally:
        _SCOPE = prev


def reset_stats() -> None:
    STATS.update(collectives=0, bytes=0)


def _data() -> Optional[_Axis]:
    """The data axis of the scope (a mesh of one rank has one too: its
    collectives run, as they would on more)."""
    if _SCOPE is None or _SCOPE.data.group is None:
        return None
    return _SCOPE.data


def _comp() -> Optional[_Axis]:
    if _SCOPE is None or _SCOPE.comp.group is None:
        return None
    return _SCOPE.comp


def data_size() -> int:
    return 1 if _SCOPE is None else _SCOPE.data.size


@contextlib.contextmanager
def _collective(t: torch.Tensor) -> Iterator[None]:
    STATS["collectives"] += 1
    STATS["bytes"] += t.numel() * t.element_size()
    if TIMERS is None:
        yield
        return
    if t.is_cuda:
        torch.cuda.synchronize(t.device)
    with TIMERS.phase("collectives"):
        yield
        if t.is_cuda:
            torch.cuda.synchronize(t.device)


def _all_reduce(x: torch.Tensor, op, axis: _Axis) -> torch.Tensor:
    is_bool = x.dtype == torch.bool
    t = x.to(torch.int32) if is_bool else x.clone()
    with _collective(t):
        dist.all_reduce(t, op=op, group=axis.group)
    return t.bool() if is_bool else t


def _all_gather(x: torch.Tensor, sizes: List[int], axis: _Axis
                ) -> torch.Tensor:
    """Concatenate every rank's ``x`` (``sizes[r]`` rows on rank r) in
    rank order; blocks are padded to the largest for the gather."""
    is_bool = x.dtype == torch.bool
    x = x.to(torch.uint8) if is_bool else x
    width = max(sizes)
    buf = torch.zeros((width,) + tuple(x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    buf[:x.shape[0]] = x
    parts = [torch.empty_like(buf) for _ in sizes]
    with _collective(buf):
        dist.all_gather(parts, buf, group=axis.group)
    out = torch.cat([p[:n] for p, n in zip(parts, sizes)])
    return out.bool() if is_bool else out


def _block_sizes(n: int, p: int) -> List[int]:
    """Rows of each of ``torch.tensor_split``'s ``p`` blocks of ``n``."""
    return [n // p + (1 if r < n % p else 0) for r in range(p)]


# ----------------------------------------------------------------------
# data axis
# ----------------------------------------------------------------------
def row_range(n: int) -> Tuple[int, int]:
    """This rank's ``[lo, hi)`` of ``n`` rows (all of them unmeshed)."""
    ax = _data()
    if ax is None:
        return 0, n
    sizes = _block_sizes(n, ax.size)
    lo = sum(sizes[:ax.rank])
    return lo, lo + sizes[ax.rank]


def rows(x: torch.Tensor) -> torch.Tensor:
    """This rank's block of the leading axis of ``x`` (``x`` unmeshed)."""
    lo, hi = row_range(x.shape[0])
    return x if (lo, hi) == (0, x.shape[0]) else x[lo:hi]


def gather_rows(x: torch.Tensor, n: int) -> torch.Tensor:
    """The ``n`` rows whose blocks (:func:`rows`) the ranks hold, from this
    rank's block ``x``: an all-gather over ``data``."""
    ax = _data()
    if ax is None:
        return x
    return _all_gather(x, _block_sizes(n, ax.size), ax)


def gather_shards(x: torch.Tensor) -> torch.Tensor:
    """Every rank's equal leading block stacked in rank order (the
    sharded database's ``[1, ...]`` leaves to ``[P, ...]``)."""
    ax = _data()
    if ax is None:
        return x
    return _all_gather(x, [x.shape[0]] * ax.size, ax)


def data_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum of every rank's ``x`` over ``data``."""
    ax = _data()
    return x if ax is None else _all_reduce(x, dist.ReduceOp.SUM, ax)


def data_max(x: torch.Tensor) -> torch.Tensor:
    """Elementwise maximum of every rank's ``x`` over ``data``."""
    ax = _data()
    return x if ax is None else _all_reduce(x, dist.ReduceOp.MAX, ax)


def data_masked_logsumexp(a: torch.Tensor, mask=None, dim: int = 0,
                          keepdim: bool = False) -> torch.Tensor:
    """:func:`~gmmvi_tpu_torch.ops.stable.masked_logsumexp` over ``dim``,
    the sample axis, across the rows of every rank: a max, then a sum of
    exponentials shifted by it."""
    return masked_logsumexp(a, mask=mask, dim=dim, keepdim=keepdim,
                            combine_max=data_max, combine_sum=data_sum)


def data_signed_weighted_logsumexp(log_w: torch.Tensor, values: torch.Tensor,
                                   dim: int = 0, mask=None) -> torch.Tensor:
    """:func:`~gmmvi_tpu_torch.ops.stable.signed_weighted_logsumexp` over
    ``dim``, the sample axis, across the rows of every rank."""
    return signed_weighted_logsumexp(log_w, values, dim=dim, mask=mask,
                                     combine_max=data_max,
                                     combine_sum=data_sum)


# ----------------------------------------------------------------------
# comp axis
# ----------------------------------------------------------------------
def comp_range(k: int) -> Tuple[int, int]:
    """This rank's ``[lo, hi)`` of ``k`` components (all unmeshed or on a
    data mesh)."""
    ax = _comp()
    if ax is None:
        return 0, k
    sizes = _block_sizes(k, ax.size)
    lo = sum(sizes[:ax.rank])
    return lo, lo + sizes[ax.rank]


def comp_gather(x: torch.Tensor, k: int) -> torch.Tensor:
    """The ``k`` components whose slices (:func:`comp_range`) the ranks of
    this comp group hold, from this rank's slice ``x``."""
    ax = _comp()
    if ax is None:
        return x
    return _all_gather(x, _block_sizes(k, ax.size), ax)
