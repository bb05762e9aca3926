"""Statically-shaped sample database, global-ring layout.

(JAX counterpart: gmmvi_tpu/optimization/sample_db.py, ``SampleDbState``)

Three fixed-capacity structures, as in the JAX package:

* a sample ring ``[S, ...]`` of the newest samples with their target
  log-densities, gradients, iteration and generating component slot;
* a distribution ring ``[R, Kmax, ...]`` of per-iteration snapshots of the
  mixture's components;
* a reservoir ``[C, ...]`` of (sample, target log-density) pairs drawn
  uniformly over the whole run, for the add heuristic.

Ring positions are modular index arithmetic (``pos % S``): every gather and
every write stays in bounds, where the JAX package leans on clamped gathers
and dropped scatters.  Updates return new tensors and leave their inputs as
they were, like the JAX functions.  Random draws (reservoir slots, accept
uniforms, candidate permutation) come in as tensors, so a caller can inject
any draws it likes.

With sample reuse the window holds samples of older iterations, whose
generating distributions are read back from the distribution ring and
weighted by ``sample_window.background`` (kernel B4 on the card).  A
diagonal model's ring holds ``[R, Kmax, D]`` square roots of the variances
and their reciprocals.

With ``tpu.db_eviction: decimate`` the database is a
``sample_db_decimate.DecimatingDbState`` instead, and with ``tpu.db_layout:
sharded`` a ``sample_db_sharded.ShardedSampleDbState``.  The optimizer
calls each through the methods the state classes share (``add_samples``,
``get_newest_samples``, ``get_newest_samples_fused``,
``get_random_samples``, ``repad``, ``size_metrics``, ``has_reservoir``,
``uses_reservoir``, ``row_sharded``), so the kind chosen when it is built
is never tested again.

On a mesh this ring is replicated: every rank writes the whole batch (the
optimizer all-gathers the target's outputs first), and the window's
counts and selection cover all of it, while its densities and background
are taken on the rank's block of rows (``parallel.reduce.rows``).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from gmmvi_tpu_torch.device import resolve_device
from gmmvi_tpu_torch.models.gmm import DensityPack, GmmState, density_pack
from gmmvi_tpu_torch.ops.stable import NEG_INF, masked_logsumexp
from gmmvi_tpu_torch.parallel import reduce
from gmmvi_tpu_torch.utils.profiling import read
from gmmvi_tpu_torch.optimization.sample_window import (
    SampleWindow, background, count_bins, rank_window, select_dists)


@dataclass
class SampleDbState:
    # sample ring
    samples: torch.Tensor              # [S, D]
    target_lnpdfs: torch.Tensor        # [S]
    target_grads: torch.Tensor         # [S, D]
    sample_iter: torch.Tensor          # [S] int32, -1 = empty
    sample_comp: torch.Tensor          # [S] int32 generating slot
    write_pos: torch.Tensor            # 0-d int32: valid samples ever written
    num_samples_written: torch.Tensor  # 0-d int32: function evaluations
    # distribution ring
    dist_means: torch.Tensor           # [R, Kmax, D]
    dist_chols: torch.Tensor           # [R, Kmax, D, D] ([R, Kmax, D] diag)
    dist_inv_chols: torch.Tensor       # [R, Kmax, D, D] ([R, Kmax, D] diag)
    dist_block_iter: torch.Tensor      # [R] int32, -1 = empty
    # reservoir
    res_samples: torch.Tensor          # [C, D]
    res_lnpdfs: torch.Tensor           # [C]
    res_count: torch.Tensor            # 0-d int32: items ever offered
    diagonal: bool = False
    keep_samples: bool = True

    @property
    def capacity(self) -> int:
        return self.samples.shape[0]

    @property
    def num_dimensions(self) -> int:
        return self.samples.shape[1]

    @property
    def ring_iters(self) -> int:
        return self.dist_means.shape[0]

    @property
    def max_components(self) -> int:
        return self.dist_means.shape[1]

    @property
    def reservoir_capacity(self) -> int:
        return self.res_samples.shape[0]

    def replace(self, **kw) -> "SampleDbState":
        return dataclasses.replace(self, **kw)

    # the interface the optimizer calls, shared with DecimatingDbState
    has_reservoir = True
    # the optimizer hands it the whole batch (on a mesh, gathered)
    row_sharded = False

    @property
    def uses_reservoir(self) -> bool:
        """Whether the add candidates come from the reservoir (drawn by a
        permutation of its slots) rather than from the newest add batch
        (drawn by ``[S]`` uniforms): False without a database
        (``use_sample_database: False``)."""
        return self.keep_samples

    def add_samples(self, *args) -> "SampleDbState":
        return add_samples(self, *args)

    def get_newest_samples(self, *args) -> SampleWindow:
        return get_newest_samples(self, *args)

    def get_newest_samples_fused(self, *args, **kw):
        return get_newest_samples_fused(self, *args, **kw)

    def get_random_samples(self, *args):
        return get_random_samples(self, *args)

    def repad(self, *args) -> "SampleDbState":
        return repad_db(self, *args)

    def size_metrics(self):
        """The runner's ``db_size`` and ``num_dists``, 0-d float64."""
        return (torch.clamp(self.write_pos, max=self.capacity).double(),
                torch.sum(self.dist_block_iter >= 0).double()
                * self.max_components)


def create_sample_db(dim: int, max_components: int, capacity: int,
                     dist_ring_iters: int, reservoir_capacity: int,
                     diagonal: bool = False, keep_samples: bool = True,
                     device="cuda") -> SampleDbState:
    device = resolve_device(device)
    s, r, kmax, c = capacity, dist_ring_iters, max_components, \
        reservoir_capacity
    f32 = dict(dtype=torch.float32, device=device)
    i32 = dict(dtype=torch.int32, device=device)
    eye = (torch.ones((r, kmax, dim), **f32) if diagonal else
           torch.eye(dim, **f32).expand(r, kmax, dim, dim).contiguous())
    return SampleDbState(
        samples=torch.zeros((s, dim), **f32),
        target_lnpdfs=torch.zeros((s,), **f32),
        target_grads=torch.zeros((s, dim), **f32),
        sample_iter=torch.full((s,), -1, **i32),
        sample_comp=torch.zeros((s,), **i32),
        write_pos=torch.zeros((), **i32),
        num_samples_written=torch.zeros((), **i32),
        dist_means=torch.zeros((r, kmax, dim), **f32),
        dist_chols=eye,
        dist_inv_chols=eye.clone(),
        dist_block_iter=torch.full((r,), -1, **i32),
        res_samples=torch.zeros((c, dim), **f32),
        res_lnpdfs=torch.full((c,), NEG_INF, **f32),
        res_count=torch.zeros((), **i32),
        diagonal=diagonal,
        keep_samples=keep_samples,
    )


def add_samples(db: SampleDbState, iteration: int, model: GmmState,
                samples: torch.Tensor, valid: torch.Tensor,
                mapping: torch.Tensor, target_lnpdfs: torch.Tensor,
                target_grads: torch.Tensor, rand_slots: torch.Tensor,
                accept_u: torch.Tensor) -> SampleDbState:
    """Append the valid rows of a statically-shaped batch ``[B, ...]``.

    The valid rows move to the front in order and are written to the ring
    positions ``write_pos + j`` (mod S) for ``j < n_valid``; the other rows
    of that circular range keep what they held.  ``rand_slots`` ``[B]``
    (uniform in ``[0, C)``) and ``accept_u`` ``[B]`` (uniform in
    ``[0, 1)``) drive the reservoir's random replacement."""
    if samples.shape[0] > db.capacity:
        raise ValueError(f"batch {samples.shape[0]} > ring capacity "
                         f"{db.capacity}")
    ring, write_pos, res, n_valid = write_ring(
        (db.samples, db.target_lnpdfs, db.target_grads, db.sample_iter,
         db.sample_comp), db.write_pos,
        (db.res_samples, db.res_lnpdfs, db.res_count), iteration,
        (samples, target_lnpdfs, target_grads, mapping), valid, rand_slots,
        accept_u)
    new_db = db.replace(
        samples=ring[0], target_lnpdfs=ring[1], target_grads=ring[2],
        sample_iter=ring[3], sample_comp=ring[4], write_pos=write_pos,
        num_samples_written=db.num_samples_written + n_valid,
        res_samples=res[0], res_lnpdfs=res[1], res_count=res[2])
    return snapshot_dists(new_db, iteration, model)


def snapshot_dists(db, iteration: int, model: GmmState):
    """``db`` with the current components in the distribution ring's row
    ``iteration % R``.  Writing the host integer ``iteration`` copies it to
    the card, which waits for the card (the read ``snapshot_dists``)."""
    row = iteration % db.ring_iters

    def set_row(ring, value):
        out = ring.clone()
        out[row] = value
        return out

    return db.replace(
        dist_means=set_row(db.dist_means, model.means),
        dist_chols=set_row(db.dist_chols, model.chols),
        dist_inv_chols=set_row(db.dist_inv_chols, model.inv_chols),
        dist_block_iter=read(lambda: set_row(db.dist_block_iter, iteration),
                             "snapshot_dists"))


def write_ring(ring, write_pos, reservoir, iteration: int, rows, valid,
               rand_slots, accept_u):
    """One ring's write: ``ring`` (samples, lnpdfs, grads, iterations,
    components) ``[S, ...]`` from ``write_pos`` on, and its reservoir
    (samples ``[C, D]``, lnpdfs ``[C]``, count), from ``rows`` (samples,
    lnpdfs, grads, components) ``[B, ...]`` of which ``valid`` are kept.
    Returns (ring, write_pos, reservoir, n_valid)."""
    samples, target_lnpdfs, target_grads, mapping = rows
    s, b = ring[0].shape[0], samples.shape[0]
    dev = samples.device
    validf = valid.to(torch.int32)
    n_valid = validf.sum(dtype=torch.int32)

    order = torch.argsort(torch.logical_not(valid).to(torch.int8),
                          stable=True)
    j = torch.arange(b, device=dev)
    idx = torch.remainder(write_pos.to(torch.int64) + j, s)
    take = j < n_valid

    def splice(arr, new_rows):
        sel = take.reshape((b,) + (1,) * (arr.ndim - 1))
        merged = torch.where(sel, new_rows[order].to(arr.dtype), arr[idx])
        return arr.index_copy(0, idx, merged)

    iters_b = torch.full((b,), iteration, dtype=torch.int32, device=dev)
    ring = tuple(splice(arr, new) for arr, new in zip(
        ring, (samples, target_lnpdfs, target_grads, iters_b, mapping)))

    # reservoir: uniform over history, batched random replacement
    res_samples, res_lnpdfs, res_count = reservoir
    c = res_samples.shape[0]
    item_no = res_count + torch.cumsum(validf, 0, dtype=torch.int32)
    fill_slots = torch.clamp(item_no - 1, 0, c - 1)
    slots = torch.where(item_no <= c, fill_slots, rand_slots.to(torch.int32))
    accept_p = torch.clamp(
        c / torch.clamp(item_no.to(torch.float32), min=1.0), max=1.0)
    accept = valid & (accept_u < accept_p)
    # several accepted rows may pick one slot: the last of them wins.  The
    # winner per slot is found explicitly (amax over row numbers, rejected
    # rows go to a spill bin c), never left to a scatter's write order.
    slot_of = torch.where(accept, slots, c).to(torch.int64)
    last = torch.full((c + 1,), -1, dtype=torch.int64, device=dev)
    last = last.scatter_reduce(0, slot_of, j, reduce="amax")[:c]
    found = last >= 0
    src = torch.clamp(last, min=0)
    reservoir = (torch.where(found[:, None], samples[src], res_samples),
                 torch.where(found, target_lnpdfs[src], res_lnpdfs),
                 res_count + n_valid)
    return ring, write_pos + n_valid, reservoir, n_valid


def _gather_window(db: SampleDbState, window: int,
                   n_requested: torch.Tensor):
    """The ``window`` newest ring rows, oldest first, with a validity mask:
    in range and with the generating distribution still in its ring row.
    Returns (samples, lnpdfs, grads, comp, valid, dist_key, iters)."""
    s, kmax, r = db.capacity, db.max_components, db.ring_iters
    if window > s:
        raise ValueError(f"window {window} > capacity {s}")
    wp = db.write_pos.to(torch.int64)
    pos = wp - window + torch.arange(window, device=wp.device)
    in_range = (pos >= 0) & (pos >= wp - n_requested) & (pos >= wp - s)
    idx = torch.remainder(pos, s)
    it = db.sample_iter[idx]
    comp = db.sample_comp[idx]
    row = torch.remainder(it, r)
    fresh = (it >= 0) & (db.dist_block_iter[row.long()] == it)
    return (db.samples[idx], db.target_lnpdfs[idx], db.target_grads[idx],
            comp, in_range & fresh, row * kmax + comp, it)


def _gather_dists(db: SampleDbState, keys: torch.Tensor):
    """(means, inv_chols, log_dets) of the ring's distributions at flat keys
    ``row * Kmax + comp``."""
    d = db.dist_means.shape[-1]
    keys = keys.long()
    factor = (d,) if db.diagonal else (d, d)
    chols = db.dist_chols.reshape(-1, *factor)[keys]
    log_dets = torch.sum(torch.log(
        chols if db.diagonal else torch.diagonal(chols, dim1=-2, dim2=-1)),
        -1)
    return (db.dist_means.reshape(-1, d)[keys],
            db.dist_inv_chols.reshape(-1, *factor)[keys], log_dets)


def get_newest_samples(db: SampleDbState, window: int,
                       n_requested: torch.Tensor, max_background_dists: int
                       ) -> SampleWindow:
    """Up to ``n_requested`` newest valid samples within a ``window``-sized
    frame, with count-weighted background densities over their generating
    distributions; samples of distributions beyond the
    ``max_background_dists`` most used are masked out."""
    kmax, r = db.max_components, db.ring_iters
    samples, lnpdfs, grads, comp, valid, dist_key, sample_iters = \
        _gather_window(db, window, n_requested)
    nkeys = r * kmax
    counts = count_bins(torch.where(valid, dist_key, nkeys), nkeys)
    top_counts, top_keys, sel_mask, selected = select_dists(
        counts, min(max_background_dists, nkeys), dist_key)
    valid = valid & selected
    total = torch.sum(torch.where(sel_mask, top_counts, 0.0))
    log_weights = torch.where(
        sel_mask, torch.log(top_counts) - torch.log(torch.clamp(total,
                                                                min=1.0)),
        NEG_INF)
    means_u, inv_u, log_dets_u = _gather_dists(db, top_keys)
    return rank_window(db.diagonal, means_u, inv_u, log_weights, log_dets_u,
                       samples, comp, lnpdfs, grads, valid, sample_iters)


def get_newest_samples_fused(db: SampleDbState, window: int,
                             n_requested: torch.Tensor,
                             max_background_dists: int, model: GmmState,
                             iteration: int, any_old_dists: bool
                             ) -> Tuple[SampleWindow, DensityPack]:
    """The newest window and the current model's density pack over it
    (kernel B1 on the card).  Samples drawn at ``iteration`` came from the
    current components, so their part of the background mixture is
    assembled from the pack's component densities with count weights.  With
    sample reuse (``any_old_dists``) the older generating distributions are
    selected as in :func:`get_newest_samples` (``max_background_dists``
    bounds only them) and evaluated by kernel B4, and the two halves are
    combined with ``logaddexp``."""
    kmax, r = db.max_components, db.ring_iters
    samples, lnpdfs, grads, comp, valid, dist_key, sample_iters = \
        _gather_window(db, window, n_requested)
    is_cur = torch.div(dist_key, kmax, rounding_mode="floor") \
        == iteration % r
    counts_cur = count_bins(torch.where(valid & is_cur, comp, kmax), kmax)
    old = None
    if not any_old_dists:
        valid = valid & is_cur
    else:
        nkeys = r * kmax
        counts = count_bins(torch.where(valid & ~is_cur, dist_key, nkeys),
                            nkeys)
        old = select_dists(counts, min(max_background_dists, nkeys),
                           dist_key)
        valid = valid & (is_cur | old[3])
    # the counts above cover the whole window; the densities cover this
    # rank's block of it
    num_valid = valid.sum(dtype=torch.int32)
    samples, comp, lnpdfs, grads, valid, sample_iters = (
        reduce.rows(x) for x in (samples, comp, lnpdfs, grads, valid,
                                 sample_iters))
    pack = density_pack(model, samples)
    bg = mixed_background(db, pack, counts_cur, old, samples)
    win = SampleWindow(
        samples=samples, mapping=comp, target_lnpdfs=lnpdfs,
        target_grads=grads, background_log_pdfs=bg, valid=valid,
        num_valid=num_valid, sample_iters=sample_iters)
    return win, pack


def mixed_background(db, pack: DensityPack, counts_cur: torch.Tensor, old,
                     samples: torch.Tensor) -> torch.Tensor:
    """The background log density at ``samples``: the current components
    weighted by ``counts_cur`` ``[Kmax]`` (from the pack's component
    densities) and, with sample reuse, the older distributions ``old``
    (:func:`select_dists`' output over the ring's keys, evaluated by kernel
    B4), combined with ``logaddexp``; without reuse (``old`` None) the
    current part alone."""
    if old is None:
        total = counts_cur.sum()
        log_w_cur = torch.where(
            counts_cur > 0,
            torch.log(torch.clamp(counts_cur, min=1.0))
            - torch.log(torch.clamp(total, min=1.0)),
            NEG_INF)
        return masked_logsumexp(
            pack.component_log_densities + log_w_cur[:, None],
            mask=(counts_cur > 0)[:, None], dim=0)
    top_counts, top_keys, sel_mask, _ = old
    total = torch.sum(torch.where(sel_mask, top_counts, 0.0)) \
        + counts_cur.sum()
    log_total = torch.log(torch.clamp(total, min=1.0))
    log_w_cur = torch.where(
        counts_cur > 0,
        torch.log(torch.clamp(counts_cur, min=1.0)) - log_total, NEG_INF)
    log_w_old = torch.where(sel_mask, torch.log(top_counts) - log_total,
                            NEG_INF)
    means_u, inv_u, log_dets_u = _gather_dists(db, top_keys)
    # all U rows: the kernel skips the unselected ones, so the JAX
    # package's two-size ladder (a cond on the live count) is not needed
    bg_old = background(db.diagonal, means_u, inv_u,
                        log_w_old.to(means_u.dtype), log_dets_u, samples)
    bg_cur = masked_logsumexp(
        pack.component_log_densities + log_w_cur[:, None],
        mask=(counts_cur > 0)[:, None], dim=0)
    return torch.logaddexp(bg_cur, bg_old)


def get_random_samples(db: SampleDbState, draw: torch.Tensor,
                       n: Optional[int] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``n`` (samples, lnpdfs, valid) candidates for the add heuristic,
    without replacement.  From the reservoir (``uses_reservoir``): ``draw``
    is the first ``n`` entries of a random permutation of its C slots, and
    slots beyond the filled prefix are invalid.  Without a database
    ``draw`` is ``[S]`` uniforms in [0, 1), and the candidates are the rows
    of the newest add batch in their stable order, the first ``n`` (all
    with ``n`` None): the reference's database then holds only that
    batch."""
    if not db.keep_samples:
        s = db.capacity
        pos = db.write_pos.to(torch.int64) - 1 - torch.arange(
            s, device=draw.device)                           # newest first
        idx = torch.remainder(pos, s)
        it = db.sample_iter[idx]
        newest = torch.max(torch.where(pos >= 0, it, -1))
        ok = (pos >= 0) & (it == newest)
        sel = torch.argsort(torch.where(ok, draw, 2.0), stable=True)[:n]
        return db.samples[idx[sel]], db.target_lnpdfs[idx[sel]], ok[sel]
    filled = torch.clamp(db.res_count, max=db.reservoir_capacity)
    perm = draw.long()
    return db.res_samples[perm], db.res_lnpdfs[perm], perm < filled


def repad_db(db: SampleDbState, new_max_components: int, new_capacity: int
             ) -> SampleDbState:
    """Grow the distribution ring's component axis (identity factors in the
    new slots) and the sample ring's capacity.  The newest ``min(written,
    old capacity, new capacity)`` samples are laid out again so that each
    keeps its position ``pos % capacity``: the window's contents, order and
    validity are unchanged.  The reservoir is unchanged."""
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
        written = read(db.write_pos, "repad")
        n_keep = min(written, s_old)
        pos = torch.arange(n_keep, device=dev) + (written - n_keep)
        old_idx, new_idx = pos % s_old, pos % s_new

        def relay(old_arr, fill=0):
            arr = torch.full((s_new,) + tuple(old_arr.shape[1:]), fill,
                             dtype=old_arr.dtype, device=dev)
            arr[new_idx] = old_arr[old_idx]
            return arr

        new = new.replace(
            samples=relay(db.samples), target_lnpdfs=relay(db.target_lnpdfs),
            target_grads=relay(db.target_grads),
            sample_iter=relay(db.sample_iter, fill=-1),
            sample_comp=relay(db.sample_comp))
    return new
