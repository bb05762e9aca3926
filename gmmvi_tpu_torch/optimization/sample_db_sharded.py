"""Sharded sample database: one ring per data rank (``tpu.db_layout:
sharded``).

(JAX counterpart: gmmvi_tpu/optimization/sample_db_sharded.py)

With the global ring (``sample_db``) a meshed step all-gathers the target's
outputs for every step's write, since the ring is replicated.  Here every
data rank keeps its own ring and reservoir and writes only its own rows of
the proposal, so the per-step database traffic drops to a few small
all-reduces: the newest iteration and the per-age counts of the window's
bound, and the ``[R Kmax]`` counts of the background's weights.  The
distribution ring stays replicated (it is written from the replicated
model).

The semantics are the JAX package's:

* the reuse window is each shard's newest ``ceil(window / P)`` rows, and
  its count bound is applied at iteration granularity (whole recent
  iterations, newest first, until the global count reaches it; where it
  falls inside an iteration, that iteration is kept whole), so the
  window's multiset matches the global ring's when the shards' valid
  counts are balanced, up to that iteration's rows.  The JAX package's
  code drops the iteration the bound falls in, against its own
  documentation; with sample reuse that drops the first add batch once
  the background's selection trims the requested count, and its sharded
  ZAMTRUX stalls (the port keeps it);
* every ring keeps the full window capacity (write rates differ between
  shards: proposal rows block-shard by component slot); each reservoir
  shard holds ``ceil(C / P)`` and add candidates are drawn uniformly per
  shard;
* ``num_samples_written`` is global and exact.

The leading shard axis ``[P, ...]`` is the JAX package's.  On a mesh each
rank holds its own shard as ``[1, ...]`` (as JAX's per-shard body sees
it); in one process the same functions take all ``P`` shards at once, so
the database can be held against the JAX package's without ranks.  The
state says which shards a process holds: ``first_shard`` on, of
``n_shards`` (the rank's data rank and the data axis's size, set when the
database is built for a mesh).  Draws are ``[P, ...]``
for all shards (reservoir slots and accept uniforms ``[P, B / P]``,
candidate permutations ``[P, ceil(n / P)]`` or, without a database, ``[P,
S]`` uniforms); each process reads its own rows.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from gmmvi_tpu_torch.device import resolve_device
from gmmvi_tpu_torch.models.gmm import DensityPack, GmmState, density_pack
from gmmvi_tpu_torch.ops.stable import NEG_INF
from gmmvi_tpu_torch.optimization import sample_db as db_ops
from gmmvi_tpu_torch.optimization.sample_window import (
    SampleWindow, background, count_bins, select_dists)
from gmmvi_tpu_torch.parallel import reduce
from gmmvi_tpu_torch.utils.profiling import read

# the leaves with a leading shard axis; the others are replicated
SHARDED_FIELDS = ("samples", "target_lnpdfs", "target_grads", "sample_iter",
                  "sample_comp", "write_pos", "res_samples", "res_lnpdfs",
                  "res_count")


@dataclass
class ShardedSampleDbState:
    # per-shard sample rings [P, S, ...]
    samples: torch.Tensor
    target_lnpdfs: torch.Tensor
    target_grads: torch.Tensor
    sample_iter: torch.Tensor
    sample_comp: torch.Tensor
    write_pos: torch.Tensor            # [P]
    num_samples_written: torch.Tensor  # 0-d int32, global
    # replicated distribution ring (as in SampleDbState)
    dist_means: torch.Tensor
    dist_chols: torch.Tensor
    dist_inv_chols: torch.Tensor
    dist_block_iter: torch.Tensor
    # per-shard reservoirs [P, C_l, ...]
    res_samples: torch.Tensor
    res_lnpdfs: torch.Tensor
    res_count: torch.Tensor            # [P]
    diagonal: bool = False
    keep_samples: bool = True
    # shards over all ranks (default: those this process holds), and the
    # first of them this process holds
    n_shards: Optional[int] = None
    first_shard: int = 0

    def __post_init__(self):
        if self.n_shards is None:
            self.n_shards = self.n_local

    @property
    def n_local(self) -> int:
        """Shards this process holds (1 on a mesh)."""
        return self.samples.shape[0]

    @property
    def capacity(self) -> int:
        """One shard's ring capacity (the full window's)."""
        return self.samples.shape[1]

    @property
    def capacity_local(self) -> int:
        """The JAX package's name of :attr:`capacity`."""
        return self.capacity

    @property
    def num_dimensions(self) -> int:
        return self.samples.shape[2]

    @property
    def ring_iters(self) -> int:
        return self.dist_means.shape[0]

    @property
    def max_components(self) -> int:
        return self.dist_means.shape[1]

    @property
    def reservoir_capacity(self) -> int:
        """One shard's reservoir capacity (the range of its slot draws)."""
        return self.res_samples.shape[1]

    @property
    def reservoir_capacity_local(self) -> int:
        """The JAX package's name of :attr:`reservoir_capacity`."""
        return self.reservoir_capacity

    def replace(self, **kw) -> "ShardedSampleDbState":
        return dataclasses.replace(self, **kw)

    # the interface the optimizer calls, shared with the other databases
    has_reservoir = True
    row_sharded = True

    @property
    def uses_reservoir(self) -> bool:
        return self.keep_samples

    def add_samples(self, *args) -> "ShardedSampleDbState":
        return add_samples(self, *args)

    def get_newest_samples(self, *args) -> SampleWindow:
        return get_newest_samples(self, *args)

    def get_newest_samples_fused(self, *args, **kw):
        return get_newest_samples_fused(self, *args, **kw)

    def get_random_samples(self, *args):
        return get_random_samples(self, *args)

    def repad(self, *args) -> "ShardedSampleDbState":
        return repad_db(self, *args)

    def size_metrics(self):
        """The runner's ``db_size`` (over every shard) and ``num_dists``,
        0-d float64."""
        size = reduce.data_sum(torch.sum(torch.clamp(
            self.write_pos, max=self.capacity)))
        return (size.double(),
                torch.sum(self.dist_block_iter >= 0).double()
                * self.max_components)


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def create_sharded_db(dim: int, max_components: int, capacity: int,
                      dist_ring_iters: int, reservoir_capacity: int,
                      n_shards: int, n_local=None, first_shard: int = 0,
                      diagonal: bool = False, keep_samples: bool = True,
                      device="cuda") -> ShardedSampleDbState:
    """``n_local`` (default all ``n_shards``) of ``n_shards`` shards from
    ``first_shard`` on, each with a ring of the global window's
    ``capacity`` and a reservoir of ``ceil(reservoir_capacity /
    n_shards)``."""
    device = resolve_device(device)
    p = n_shards if n_local is None else n_local
    s, r, kmax = capacity, dist_ring_iters, max_components
    c_l = max(1, _ceil_div(reservoir_capacity, n_shards))
    f32 = dict(dtype=torch.float32, device=device)
    i32 = dict(dtype=torch.int32, device=device)
    eye = (torch.ones((r, kmax, dim), **f32) if diagonal else
           torch.eye(dim, **f32).expand(r, kmax, dim, dim).contiguous())
    return ShardedSampleDbState(
        samples=torch.zeros((p, s, dim), **f32),
        target_lnpdfs=torch.zeros((p, s), **f32),
        target_grads=torch.zeros((p, s, dim), **f32),
        sample_iter=torch.full((p, s), -1, **i32),
        sample_comp=torch.zeros((p, s), **i32),
        write_pos=torch.zeros((p,), **i32),
        num_samples_written=torch.zeros((), **i32),
        dist_means=torch.zeros((r, kmax, dim), **f32),
        dist_chols=eye,
        dist_inv_chols=eye.clone(),
        dist_block_iter=torch.full((r,), -1, **i32),
        res_samples=torch.zeros((p, c_l, dim), **f32),
        res_lnpdfs=torch.full((p, c_l), NEG_INF, **f32),
        res_count=torch.zeros((p,), **i32),
        diagonal=diagonal, keep_samples=keep_samples, n_shards=n_shards,
        first_shard=first_shard)


def _local(db: ShardedSampleDbState, draws: torch.Tensor) -> torch.Tensor:
    """This process's rows of ``[P, ...]`` draws."""
    return draws[db.first_shard:db.first_shard + db.n_local]


def add_samples(db: ShardedSampleDbState, iteration: int, model: GmmState,
                samples: torch.Tensor, valid: torch.Tensor,
                mapping: torch.Tensor, target_lnpdfs: torch.Tensor,
                target_grads: torch.Tensor, rand_slots: torch.Tensor,
                accept_u: torch.Tensor) -> ShardedSampleDbState:
    """Write this process's rows of the batch (``[n_local B / P, ...]``:
    its shards' blocks, in order) into its shards, each block compacted
    into its own ring and reservoir; ``rand_slots`` and ``accept_u`` are
    ``[P, B / P]``.  ``num_samples_written`` grows by the valid rows of
    every rank (one all-reduce)."""
    pl = db.n_local
    if samples.shape[0] % pl:
        raise ValueError(f"sharded DB needs the batch ({samples.shape[0]}) "
                         f"divisible by its shards ({pl})")
    b_l = samples.shape[0] // pl

    def blocks(x):
        return x.reshape((pl, b_l) + tuple(x.shape[1:]))

    rows = [blocks(x) for x in (samples, target_lnpdfs, target_grads,
                                mapping.to(torch.int32))]
    val = blocks(valid)
    slots, acc = _local(db, rand_slots), _local(db, accept_u)
    out = []
    for p in range(pl):
        out.append(db_ops.write_ring(
            (db.samples[p], db.target_lnpdfs[p], db.target_grads[p],
             db.sample_iter[p], db.sample_comp[p]), db.write_pos[p],
            (db.res_samples[p], db.res_lnpdfs[p], db.res_count[p]),
            iteration, [r[p] for r in rows], val[p], slots[p], acc[p]))
    ring = [torch.stack([o[0][i] for o in out]) for i in range(5)]
    res = [torch.stack([o[2][i] for o in out]) for i in range(3)]
    n_valid = reduce.data_sum(valid.sum(dtype=torch.int32))
    new_db = db.replace(
        samples=ring[0], target_lnpdfs=ring[1], target_grads=ring[2],
        sample_iter=ring[3], sample_comp=ring[4],
        write_pos=torch.stack([o[1] for o in out]),
        num_samples_written=db.num_samples_written + n_valid,
        res_samples=res[0], res_lnpdfs=res[1], res_count=res[2])
    return db_ops.snapshot_dists(new_db, iteration, model)


def _gather_window(db: ShardedSampleDbState, window: int,
                   n_requested: torch.Tensor):
    """Each shard's newest ``ceil(window / P)`` rows, oldest first, flat
    ``[n_local w_l, ...]`` (shard by shard), with the iteration-granular
    count bound: whole recent iterations are kept newest first until their
    global valid count reaches ``n_requested`` (the newest always, and the
    one that reaches it whole).  The collectives: the newest iteration (a
    max) and the ``[R]`` per-age counts (a sum).  Returns (samples,
    lnpdfs, grads, comp, valid, dist_key, iters)."""
    pl, s_l = db.n_local, db.capacity
    kmax, r = db.max_components, db.ring_iters
    w_l = _ceil_div(window, db.n_shards)
    wp = db.write_pos.to(torch.int64)[:, None]                  # [pl, 1]
    pos = wp - w_l + torch.arange(w_l, device=wp.device)[None, :]
    in_rng = (pos >= 0) & (pos >= wp - s_l)
    idx = torch.remainder(pos, s_l)
    shard = torch.arange(pl, device=wp.device)[:, None]

    def flat(x):
        return x[shard, idx].reshape((pl * w_l,) + tuple(x.shape[2:]))

    samples, lnpdfs, grads = (flat(db.samples), flat(db.target_lnpdfs),
                              flat(db.target_grads))
    it, comp = flat(db.sample_iter), flat(db.sample_comp)
    in_rng = in_rng.reshape(-1)
    row = torch.remainder(it, r)
    fresh = (it >= 0) & (db.dist_block_iter[row.long()] == it)
    valid0 = in_rng & fresh
    t_max = reduce.data_max(torch.max(torch.where(valid0, it, -1)))
    age = t_max - it
    hist = reduce.data_sum(count_bins(
        torch.where(valid0, torch.clamp(age, 0, r - 1), r), r))
    # whole iterations, newest first, until n_requested is reached; the one
    # that reaches it is kept whole, as the JAX package documents (its code
    # drops that one instead: with reuse, once the background's selection
    # trims the count, the first add batch goes and the window shrinks to
    # the newest few samples a component)
    allowed = torch.cumsum(hist, 0) - hist < n_requested
    allowed[0] = True                       # never cut inside the newest
    max_age = allowed.sum() - 1
    valid = valid0 & (age <= max_age)
    return samples, lnpdfs, grads, comp, valid, row * kmax + comp, it


def _window_counts(valid, dist_key, nkeys: int) -> torch.Tensor:
    """``[R Kmax]`` counts of the valid samples' keys over every shard
    (one all-reduce)."""
    return reduce.data_sum(count_bins(torch.where(valid, dist_key, nkeys),
                                      nkeys))


def get_newest_samples(db: ShardedSampleDbState, window: int,
                       n_requested: torch.Tensor, max_background_dists: int
                       ) -> SampleWindow:
    """Sharded form of :func:`sample_db.get_newest_samples`
    (``n_requested`` is global, applied at iteration granularity)."""
    kmax, r = db.max_components, db.ring_iters
    samples, lnpdfs, grads, comp, valid, dist_key, sample_iters = \
        _gather_window(db, window, n_requested)
    nkeys = r * kmax
    counts = _window_counts(valid, dist_key, nkeys)
    top_counts, top_keys, sel_mask, selected = select_dists(
        counts, min(max_background_dists, nkeys), dist_key)
    valid = valid & selected
    total = torch.sum(torch.where(sel_mask, top_counts, 0.0))
    log_weights = torch.where(
        sel_mask, torch.log(top_counts) - torch.log(torch.clamp(total,
                                                                min=1.0)),
        NEG_INF)
    means_u, inv_u, log_dets_u = db_ops._gather_dists(db, top_keys)
    bg = background(db.diagonal, means_u, inv_u,
                    log_weights.to(means_u.dtype), log_dets_u, samples)
    return SampleWindow(
        samples=samples, mapping=comp, target_lnpdfs=lnpdfs,
        target_grads=grads, background_log_pdfs=bg, valid=valid,
        num_valid=reduce.data_sum(valid.sum(dtype=torch.int32)),
        sample_iters=sample_iters)


def get_newest_samples_fused(db: ShardedSampleDbState, window: int,
                             n_requested: torch.Tensor,
                             max_background_dists: int, model: GmmState,
                             iteration: int, any_old_dists: bool
                             ) -> Tuple[SampleWindow, DensityPack]:
    """Sharded form of :func:`sample_db.get_newest_samples_fused`: the
    window's keys are counted once over every shard (one ``[R Kmax]``
    all-reduce), the current row's counts weight the current components
    and the others select the older distributions."""
    kmax, r = db.max_components, db.ring_iters
    samples, lnpdfs, grads, comp, valid, dist_key, sample_iters = \
        _gather_window(db, window, n_requested)
    pack = density_pack(model, samples)
    nkeys = r * kmax
    cur_row = iteration % r
    is_cur = torch.div(dist_key, kmax, rounding_mode="floor") == cur_row
    counts = _window_counts(valid, dist_key, nkeys).reshape(r, kmax)
    counts_cur = counts[cur_row]
    old = None
    if not any_old_dists:
        valid = valid & is_cur
    else:
        counts_old = counts.clone()
        counts_old[cur_row] = 0.0
        old = select_dists(counts_old.reshape(-1),
                           min(max_background_dists, nkeys), dist_key)
        valid = valid & (is_cur | old[3])
    bg = db_ops.mixed_background(db, pack, counts_cur, old, samples)
    win = SampleWindow(
        samples=samples, mapping=comp, target_lnpdfs=lnpdfs,
        target_grads=grads, background_log_pdfs=bg, valid=valid,
        num_valid=reduce.data_sum(valid.sum(dtype=torch.int32)),
        sample_iters=sample_iters)
    return win, pack


def get_random_samples(db: ShardedSampleDbState, draw: torch.Tensor,
                       n: int):
    """``n`` candidates, each shard contributing ``ceil(n / P)`` (without
    replacement within a shard), gathered from every rank in shard order:
    from the reservoirs, ``draw`` ``[P, ceil(n / P)]`` the first entries of
    a permutation of each shard's slots (slots beyond the filled prefix
    invalid); without a database, ``draw`` ``[P, S]`` uniforms ordering
    each shard's rows of the newest add batch."""
    pl = db.n_local
    n_l = _ceil_div(n, db.n_shards)
    draw = _local(db, draw)
    shard = torch.arange(pl, device=draw.device)[:, None]
    if not db.keep_samples:
        s_l = db.capacity
        pos = db.write_pos.to(torch.int64)[:, None] - 1 - torch.arange(
            s_l, device=draw.device)[None, :]
        idx = torch.remainder(pos, s_l)
        it = db.sample_iter[shard, idx]
        newest = reduce.data_max(torch.max(torch.where(pos >= 0, it, -1)))
        ok = (pos >= 0) & (it == newest)
        sel = torch.argsort(torch.where(ok, draw, 2.0), dim=1,
                            stable=True)[:, :n_l]
        rows = idx[shard, sel]
        smp, lnp, okv = (db.samples[shard, rows],
                         db.target_lnpdfs[shard, rows], ok[shard, sel])
    else:
        filled = torch.clamp(db.res_count, max=db.reservoir_capacity)
        perm = draw[:, :n_l].long()
        smp, lnp = db.res_samples[shard, perm], db.res_lnpdfs[shard, perm]
        okv = perm < filled[:, None]
    d = smp.shape[-1]
    return (reduce.gather_shards(smp.reshape(pl * n_l, d))[:n],
            reduce.gather_shards(lnp.reshape(pl * n_l))[:n],
            reduce.gather_shards(okv.reshape(pl * n_l))[:n])


def repad_db(db: ShardedSampleDbState, new_max_components: int,
             new_capacity: int) -> ShardedSampleDbState:
    """:func:`sample_db.repad_db` shard by shard: the distribution ring's
    component axis, and every ring to ``new_capacity`` with its newest
    samples at their positions."""
    kmax, d = db.max_components, db.dist_means.shape[-1]
    s_old, s_new = db.capacity, new_capacity
    k_extra = new_max_components - kmax
    dev = db.samples.device
    f32 = dict(dtype=torch.float32, device=dev)
    new = db
    if k_extra > 0:
        r = db.ring_iters
        pad_chol = (torch.ones((r, k_extra, d), **f32) if db.diagonal else
                    torch.eye(d, **f32).expand(r, k_extra, d, d))
        new = new.replace(
            dist_means=torch.cat([db.dist_means,
                                  torch.zeros((r, k_extra, d), **f32)], 1),
            dist_chols=torch.cat([db.dist_chols, pad_chol], 1),
            dist_inv_chols=torch.cat([db.dist_inv_chols, pad_chol], 1))
    if s_new > s_old:
        written = read(db.write_pos.tolist, "repad")

        def relay(old_arr, fill=0):
            arr = torch.full((db.n_local, s_new) + tuple(old_arr.shape[2:]),
                             fill, dtype=old_arr.dtype, device=dev)
            for p, wp in enumerate(written):
                n_keep = min(wp, s_old)
                pos = torch.arange(n_keep, device=dev) + (wp - n_keep)
                arr[p, pos % s_new] = old_arr[p, pos % s_old]
            return arr

        new = new.replace(
            samples=relay(db.samples), target_lnpdfs=relay(db.target_lnpdfs),
            target_grads=relay(db.target_grads),
            sample_iter=relay(db.sample_iter, fill=-1),
            sample_comp=relay(db.sample_comp))
    return new
