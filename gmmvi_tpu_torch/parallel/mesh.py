"""Device meshes for data-parallel and hybrid GMMVI runs.

(JAX counterpart: gmmvi_tpu/parallel/mesh.py)

The workload's scaling axis is the per-iteration sample batch: the model
and the optimizer state are small (``[K, D]``, ``[K, D, D]``) and stay
replicated on every rank, the sample rows are split over a ``data`` mesh
dimension, and every per-component sum over the samples is reduced
explicitly (``parallel/reduce.py``).  A 2-D ``("data", "comp")`` mesh also
splits the per-component chains (stepsizes, the estimate's moments, the
trust-region search and the Cholesky rebuild) over ``comp``.

PyTorch's idiom is one process per rank: start the ranks (``torchrun``, or
:func:`spawn` here), call :func:`initialize_distributed` in each with the
backend of your choice, then :func:`data_mesh`, :func:`hybrid_mesh` or
:func:`mesh_from_config` gives the ``DeviceMesh`` that ``GMMVI`` and
``GmmviRunner`` accept through their ``mesh`` argument.  The backend is
the caller's: ``nccl`` for one rank per card, ``gloo`` for ranks that
share a card (NCCL refuses two ranks on one device) and on the CPU.  The
step uses only ``all_reduce`` and ``all_gather``, which gloo has for CUDA
tensors.  The JAX package's ``batch_sharding`` / ``replicated`` have no
counterpart here: a rank takes its block of a batch's rows with
``parallel.reduce.rows`` (``torch.tensor_split``'s blocks, as ``P("data")``
blocks them).
"""
from __future__ import annotations

import datetime
import os
import socket
import time
from typing import Callable, Optional, Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

DEFAULT_TIMEOUT_S = 300.0


def initialize_distributed(backend: str,
                           init_method: Optional[str] = None,
                           world_size: Optional[int] = None,
                           rank: Optional[int] = None,
                           timeout_s: float = DEFAULT_TIMEOUT_S) -> None:
    """``torch.distributed.init_process_group`` with an explicit backend
    and a timeout (a hung collective then fails instead of stalling).
    ``init_method``, ``world_size`` and ``rank`` default to the
    environment (``torchrun`` sets them).  No-op when a group exists."""
    if dist.is_initialized():
        return
    dist.init_process_group(
        backend=backend, init_method=init_method, world_size=world_size,
        rank=rank, timeout=datetime.timedelta(seconds=timeout_s))


def _world_size() -> int:
    if not dist.is_initialized():
        raise RuntimeError(
            "no process group: call parallel.mesh.initialize_distributed "
            "in every rank first")
    return dist.get_world_size()


def _check_ranks(n: int) -> None:
    world = _world_size()
    if n != world:
        raise ValueError(f"a mesh of {n} ranks in a world of {world}: "
                         f"start exactly {n} ranks")


def data_mesh(num_devices: Optional[int] = None,
              device_type: str = "cuda") -> DeviceMesh:
    """1-D ``data`` mesh over ``num_devices`` ranks (default: all)."""
    n = _world_size() if num_devices is None else int(num_devices)
    _check_ranks(n)
    return init_device_mesh(device_type, (n,), mesh_dim_names=("data",))


def hybrid_mesh(num_comp: int, num_devices: Optional[int] = None,
                device_type: str = "cuda") -> DeviceMesh:
    """2-D ``("data", "comp")`` mesh: samples split over ``data``, the
    component axis of the per-component chains over ``comp`` (innermost,
    so a comp group is consecutive ranks).  Worth it for large-K adaptive
    runs; for small K a comp axis only adds collectives."""
    n = _world_size() if num_devices is None else int(num_devices)
    if n % num_comp:
        raise ValueError(f"{n} devices not divisible by num_comp={num_comp}")
    _check_ranks(n)
    return init_device_mesh(device_type, (n // num_comp, num_comp),
                            mesh_dim_names=("data", "comp"))


def mesh_from_config(tpu_cfg: dict, device_type: str = "cuda"
                     ) -> Optional[DeviceMesh]:
    """The mesh the config's ``tpu:`` section asks for, or None:
    ``tpu.data_shards`` (an int or ``"all"``) a 1-D ``data`` mesh, with
    ``tpu.comp_shards: M`` the 2-D hybrid mesh with ``comp`` M-way.  The
    world size plays the part of the JAX package's visible devices; a mesh
    of one rank without a process group is None (unmeshed), any other
    needs the group."""
    tpu_cfg = tpu_cfg or {}
    data = tpu_cfg.get("data_shards")
    comp = int(tpu_cfg.get("comp_shards", 1))
    if data is None and comp <= 1:
        return None
    if comp <= 1 and data in (1, "all", -1) and not dist.is_initialized():
        # one rank and no process group: an unmeshed run (the global ring
        # under db_layout auto), where the JAX package builds a mesh of one
        # device
        return None
    n_avail = _world_size()
    if data in (None, "all", -1):
        n = n_avail
    else:
        n = int(data) * comp
    if n > n_avail:
        raise ValueError(
            f"tpu mesh config requests {n} devices "
            f"(data_shards={data}, comp_shards={comp}) but only "
            f"{n_avail} are visible")
    if comp > 1:
        return hybrid_mesh(num_comp=comp, num_devices=n,
                           device_type=device_type)
    return data_mesh(num_devices=n, device_type=device_type)


def data_axis_size(mesh: DeviceMesh) -> int:
    """Ranks on the mesh's ``data`` dimension."""
    return mesh.size(mesh.mesh_dim_names.index("data"))


# ----------------------------------------------------------------------
# Starting ranks in one process tree
# ----------------------------------------------------------------------
def free_port() -> int:
    """A free TCP port on localhost for a rendezvous."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_entry(rank: int, fn: Callable, nprocs: int, backend: str,
                port: int, timeout_s: float, args: Sequence) -> None:
    torch.set_num_threads(1)
    os.environ.setdefault("OMP_NUM_THREADS", "1")
    initialize_distributed(backend, f"tcp://localhost:{port}", nprocs, rank,
                           timeout_s)
    try:
        fn(rank, nprocs, *args)
    finally:
        dist.destroy_process_group()


def spawn(fn: Callable, nprocs: int, backend: str, args: Sequence = (),
          timeout_s: float = DEFAULT_TIMEOUT_S) -> None:
    """Run ``fn(rank, nprocs, *args)`` in ``nprocs`` fresh processes
    (``spawn``, never ``fork``: safe after CUDA is initialised), each with
    one CPU thread and a process group of ``backend`` over a localhost
    rendezvous whose collectives time out after ``timeout_s``.  Waits at
    most ``timeout_s`` for all of them, then kills them and raises
    ``TimeoutError``; a rank that raises fails the call (the others are
    stopped).  ``fn`` must be importable by name (a module-level
    function)."""
    port = free_port()
    ctx = torch.multiprocessing.start_processes(
        _rank_entry, args=(fn, nprocs, backend, port, timeout_s, tuple(args)),
        nprocs=nprocs, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout_s
    try:
        while not ctx.join(timeout=max(0.1, deadline - time.monotonic())):
            if time.monotonic() >= deadline:
                raise TimeoutError(
                    f"{nprocs} ranks did not finish within {timeout_s} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join(5)


# ----------------------------------------------------------------------
# Checking that the replicated state is equal on every rank
# ----------------------------------------------------------------------
_HASH_CHUNK = 1 << 24


def _leaf_hash(t: torch.Tensor, salt: int) -> torch.Tensor:
    """An int64 hash of ``t``'s bits on its device: every element's bits
    times a distinct odd multiplier, summed (wrapping), in chunks of
    ``_HASH_CHUNK`` elements (a distribution ring of stm300 holds 10^9)."""
    flat = t.detach().reshape(-1)
    if flat.dtype == torch.bool:
        flat = flat.to(torch.uint8)
    elif flat.element_size() == 8:
        flat = flat.view(torch.int64)
    elif flat.element_size() == 4:
        flat = flat.view(torch.int32)
    h = torch.zeros((), dtype=torch.int64, device=flat.device)
    for lo in range(0, flat.numel(), _HASH_CHUNK):
        part = flat[lo:lo + _HASH_CHUNK].to(torch.int64)
        mult = torch.arange(lo, lo + part.numel(), dtype=torch.int64,
                            device=flat.device)
        h = h + torch.sum(part * ((mult * 2654435761 + salt * 40503) * 2
                                  + 1))
    return h


def replicated_state_hash(state) -> torch.Tensor:
    """A 0-d int64 hash of what every rank of a meshed run must hold
    alike: the model, the meta-state, the weight stepsize and the
    distribution ring of the database."""
    parts = [state.model, state.meta, state.wstep]
    leaves = [t for part in parts for t in vars(part).values()
              if isinstance(t, torch.Tensor)]
    leaves += [getattr(state.db, name) for name in (
        "dist_means", "dist_chols", "dist_inv_chols", "dist_block_iter")
        if hasattr(state.db, name)]
    h = torch.zeros((), dtype=torch.int64, device=leaves[0].device)
    for i, t in enumerate(leaves):
        h = h + _leaf_hash(t, i + 1) * (2 * i + 3)
    return h


def check_replicated(state) -> None:
    """Raise unless :func:`replicated_state_hash` is equal on every rank
    of the world (an all-reduce of its max and of its min; not counted in
    ``parallel.reduce.STATS``, it is a check, not part of the step)."""
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return
    h = replicated_state_hash(state)
    hi, lo = h.clone(), h.clone()
    dist.all_reduce(hi, op=dist.ReduceOp.MAX)
    dist.all_reduce(lo, op=dist.ReduceOp.MIN)
    if int(hi) != int(lo):
        raise AssertionError(
            f"rank {dist.get_rank()}: the replicated state differs between "
            f"ranks (hash max {int(hi)}, min {int(lo)})")
