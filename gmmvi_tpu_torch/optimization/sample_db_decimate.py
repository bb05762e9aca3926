"""The decimating sample database (``tpu.db_eviction: decimate``), the
reference-exact parity mode.

(JAX counterpart: gmmvi_tpu/optimization/sample_db_decimate.py)

Samples live in the prefix ``[0, count)`` of fixed arrays, each with the row
of its generating distribution in a table of (mean, factor, inverse factor)
rows; every add appends the model's active components to the table.  When
an add would overflow the store, every ``stride``-th stored sample survives
(``stride`` 2 is the reference's ``[::2]``; a larger power of two when one
halving does not make room), and the table is compacted to the rows still
referenced, in ascending order.  The table also compacts itself when it
cannot take another block of components.  With ``keep_samples`` False each
add replaces the store.

Both data-dependent branches (decimate, compact) are computed every add
and selected with ``torch.where``, so an add reads nothing back from the
device.  The window's count-weighted background over the ``max_background_
dists`` most used table rows goes through ``sample_window.background``
(kernel B4 on the card up to D = 128, B5's mixture output up to 512).
Updates return new tensors and leave their inputs as they were; the random
candidates take their uniforms as a tensor.  The state's methods are the
interface the optimizer calls, the ring's (``sample_db.SampleDbState``).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

from gmmvi_tpu_torch.device import resolve_device
from gmmvi_tpu_torch.models.gmm import GmmState, density_pack
from gmmvi_tpu_torch.ops.stable import NEG_INF
from gmmvi_tpu_torch.optimization.sample_window import (
    SampleWindow, count_bins, rank_window, select_dists)


@dataclass
class DecimatingDbState:
    # contiguous sample store [0, count)
    samples: torch.Tensor              # [S, D]
    target_lnpdfs: torch.Tensor        # [S]
    target_grads: torch.Tensor         # [S, D]
    sample_iter: torch.Tensor          # [S] int32
    sample_comp: torch.Tensor          # [S] int32 generating slot
    dist_idx: torch.Tensor             # [S] int32 row in the table
    count: torch.Tensor                # 0-d int32 stored samples
    num_samples_written: torch.Tensor  # 0-d int32 function evaluations
    # distribution table [0, dist_count)
    dist_means: torch.Tensor           # [U, D]
    dist_chols: torch.Tensor           # [U, D, D] ([U, D] diagonal)
    dist_inv_chols: torch.Tensor       # [U, D, D] ([U, D] diagonal)
    dist_count: torch.Tensor           # 0-d int32
    diagonal: bool = False
    keep_samples: bool = True

    @property
    def capacity(self) -> int:
        return self.samples.shape[0]

    @property
    def dist_capacity(self) -> int:
        return self.dist_means.shape[0]

    def replace(self, **kw) -> "DecimatingDbState":
        return dataclasses.replace(self, **kw)

    # the interface the optimizer calls, shared with SampleDbState: no
    # reservoir (the candidates are the stored samples), and shapes that
    # do not depend on the padding
    has_reservoir = uses_reservoir = row_sharded = False

    def add_samples(self, iteration, model, samples, valid, mapping,
                    target_lnpdfs, target_grads, rand_slots=None,
                    accept_u=None) -> "DecimatingDbState":
        del rand_slots, accept_u
        return add_samples(self, iteration, model, samples, valid, mapping,
                           target_lnpdfs, target_grads)

    def get_newest_samples(self, *args) -> SampleWindow:
        return get_newest_samples(self, *args)

    def get_newest_samples_fused(self, window, n_requested,
                                 max_background_dists, model, iteration,
                                 any_old_dists=True):
        """The window (it carries its own background) and the model's
        density pack over it (kernel B1 on the card)."""
        del iteration, any_old_dists
        win = get_newest_samples(self, window, n_requested,
                                 max_background_dists)
        return win, density_pack(model, win.samples)

    def get_random_samples(self, *args):
        return get_random_samples(self, *args)

    def repad(self, new_max_components, new_capacity) -> "DecimatingDbState":
        del new_max_components, new_capacity
        return self

    def size_metrics(self):
        """The runner's ``db_size`` and ``num_dists``, 0-d float64."""
        return self.count.double(), self.dist_count.double()


def create_decimating_db(dim: int, max_components: int, capacity: int,
                         dist_capacity: int, diagonal: bool = False,
                         keep_samples: bool = True, device="cuda"
                         ) -> DecimatingDbState:
    del max_components       # the shapes do not depend on the padding
    device = resolve_device(device)
    s, u = capacity, dist_capacity
    f32 = dict(dtype=torch.float32, device=device)
    i32 = dict(dtype=torch.int32, device=device)
    eye = (torch.ones((u, dim), **f32) if diagonal else
           torch.eye(dim, **f32).expand(u, dim, dim).contiguous())
    return DecimatingDbState(
        samples=torch.zeros((s, dim), **f32),
        target_lnpdfs=torch.zeros((s,), **f32),
        target_grads=torch.zeros((s, dim), **f32),
        sample_iter=torch.full((s,), -1, **i32),
        sample_comp=torch.zeros((s,), **i32),
        dist_idx=torch.zeros((s,), **i32),
        count=torch.zeros((), **i32),
        num_samples_written=torch.zeros((), **i32),
        dist_means=torch.zeros((u, dim), **f32),
        dist_chols=eye,
        dist_inv_chols=eye.clone(),
        dist_count=torch.zeros((), **i32),
        diagonal=diagonal,
        keep_samples=keep_samples,
    )


def _select(cond: torch.Tensor, a: DecimatingDbState, b: DecimatingDbState
            ) -> DecimatingDbState:
    """Field-wise ``torch.where(cond, a, b)`` for a 0-d ``cond``."""
    return a.replace(**{
        f.name: torch.where(cond, getattr(a, f.name), getattr(b, f.name))
        for f in dataclasses.fields(a)
        if isinstance(getattr(a, f.name), torch.Tensor)})


def _compact_dists(db: DecimatingDbState) -> DecimatingDbState:
    """Drop the table rows no stored sample references and renumber the
    rest in ascending order (``tf.unique`` on the stored rows, since blocks
    are appended in order)."""
    s, u = db.capacity, db.dist_capacity
    dev = db.samples.device
    stored = torch.arange(s, device=dev) < db.count
    # rows past the table (a block that did not fit) go to the spill bin
    in_use = torch.clamp(torch.where(stored, db.dist_idx.long(), u), max=u)
    used = torch.zeros(u + 1, dtype=torch.int32, device=dev).index_fill(
        0, in_use, 1)[:u]
    new_pos = torch.cumsum(used, 0, dtype=torch.int32) - 1
    order = torch.argsort(used == 0, stable=True)
    return db.replace(
        dist_means=db.dist_means[order],
        dist_chols=db.dist_chols[order],
        dist_inv_chols=db.dist_inv_chols[order],
        dist_idx=torch.where(
            stored, new_pos[torch.clamp(db.dist_idx.long(), 0, u - 1)],
            0).to(torch.int32),
        dist_count=used.sum(dtype=torch.int32))


def _decimate(db: DecimatingDbState, room_needed: torch.Tensor
              ) -> DecimatingDbState:
    """Keep every ``stride``-th stored sample, the oldest of each group, with
    ``stride`` the smallest power of two that frees ``room_needed`` rows,
    then compact the table."""
    s = db.capacity
    dev = db.samples.device
    count = db.count.long()
    room = torch.clamp(s - room_needed.long(), min=1)
    need = torch.clamp(torch.div(count + room - 1, room,
                                 rounding_mode="floor"), min=2)
    stride = torch.bitwise_left_shift(
        torch.ones((), dtype=torch.int64, device=dev),
        torch.ceil(torch.log2(need.to(torch.float32))).to(torch.int64))
    # a float log2 that rounded down gets one more doubling
    stride = torch.where(torch.div(count + stride - 1, stride,
                                   rounding_mode="floor") > room,
                         2 * stride, stride)
    j = torch.arange(s, device=dev)
    src = torch.clamp(stride * j, max=s - 1)
    new_count = torch.div(count + stride - 1, stride, rounding_mode="floor")
    live = j < new_count

    def keep(field, fill):
        sel = live.reshape((s,) + (1,) * (field.ndim - 1))
        return torch.where(sel, field[src], fill)

    db = db.replace(
        samples=keep(db.samples, 0.0),
        target_lnpdfs=keep(db.target_lnpdfs, 0.0),
        target_grads=keep(db.target_grads, 0.0),
        sample_iter=keep(db.sample_iter, -1),
        sample_comp=keep(db.sample_comp, 0),
        dist_idx=keep(db.dist_idx, 0),
        count=new_count.to(torch.int32))
    return _compact_dists(db)


def add_samples(db: DecimatingDbState, iteration: int, model: GmmState,
                samples: torch.Tensor, valid: torch.Tensor,
                mapping: torch.Tensor, target_lnpdfs: torch.Tensor,
                target_grads: torch.Tensor) -> DecimatingDbState:
    """Append the valid rows of ``samples`` ``[B, ...]`` in order, after a
    decimation where they would overflow the store, and the model's active
    components to the table (after a compaction where they would overflow
    it)."""
    s, kmax, u = db.capacity, model.max_components, db.dist_capacity
    b = samples.shape[0]
    if b > s or kmax > u:
        raise ValueError(f"batch {b} > store {s} or Kmax {kmax} > table "
                         f"{u}")
    dev = samples.device
    n_valid = valid.sum(dtype=torch.int32)
    if not db.keep_samples:
        zero = torch.zeros((), dtype=torch.int32, device=dev)
        db = db.replace(count=zero, dist_count=zero)
    db = _select(db.count + n_valid > s, _decimate(db, n_valid), db)
    db = _select(db.dist_count + model.num_active > u, _compact_dists(db),
                 db)

    # the components go to rows dist_count + k; the rows of the others
    # (and of any beyond the table, which is dropped as the JAX package
    # drops it) are written back as they were
    k = torch.arange(kmax, device=dev)
    rows = db.dist_count.long() + k
    write = (k < model.num_active) & (rows < u)
    rows = torch.remainder(rows, u)

    def append(table, value):
        sel = write.reshape((kmax,) + (1,) * (table.ndim - 1))
        return table.index_copy(0, rows, torch.where(sel, value,
                                                     table[rows]))

    j = torch.arange(b, device=dev)
    idx = torch.remainder(db.count.long() + j, s)
    take = j < n_valid
    order = torch.argsort(torch.logical_not(valid).to(torch.int8),
                          stable=True)

    def splice(store, new_rows):
        sel = take.reshape((b,) + (1,) * (store.ndim - 1))
        merged = torch.where(sel, new_rows[order].to(store.dtype),
                             store[idx])
        return store.index_copy(0, idx, merged)

    return db.replace(
        dist_means=append(db.dist_means, model.means),
        dist_chols=append(db.dist_chols, model.chols),
        dist_inv_chols=append(db.dist_inv_chols, model.inv_chols),
        samples=splice(db.samples, samples),
        target_lnpdfs=splice(db.target_lnpdfs, target_lnpdfs),
        target_grads=splice(db.target_grads, target_grads),
        sample_iter=splice(db.sample_iter, torch.full(
            (b,), iteration, dtype=torch.int32, device=dev)),
        sample_comp=splice(db.sample_comp, mapping),
        dist_idx=splice(db.dist_idx, db.dist_count + mapping.to(torch.int32)),
        count=db.count + n_valid,
        num_samples_written=db.num_samples_written + n_valid,
        dist_count=db.dist_count + model.num_active.to(torch.int32))


def get_newest_samples(db: DecimatingDbState, window: int,
                       n_requested: torch.Tensor, max_background_dists: int
                       ) -> SampleWindow:
    """Up to ``n_requested`` newest stored samples within a ``window``-sized
    frame (after decimation it reaches into thinned history), with the
    count-weighted background over their distinct generating rows; samples
    of rows beyond the ``max_background_dists`` most used drop out."""
    s, u = db.capacity, db.dist_capacity
    count = db.count.long()
    pos = count - window + torch.arange(window, device=count.device)
    valid = (pos >= 0) & (pos >= count - n_requested)
    idx = torch.clamp(pos, 0, s - 1)
    dist_key = db.dist_idx[idx]
    counts = count_bins(torch.clamp(torch.where(valid, dist_key, u),
                                    max=u), u)
    top_counts, top_keys, sel_mask, selected = select_dists(
        counts, min(max_background_dists, u), dist_key)
    valid = valid & selected
    total = torch.sum(torch.where(sel_mask, top_counts, 0.0))
    log_w = torch.where(
        sel_mask, torch.log(torch.clamp(top_counts, min=1.0))
        - torch.log(torch.clamp(total, min=1.0)), NEG_INF)
    chols = db.dist_chols[top_keys]
    log_dets = torch.sum(torch.log(
        chols if db.diagonal else
        torch.abs(torch.diagonal(chols, dim1=-2, dim2=-1))), -1)
    return rank_window(db.diagonal, db.dist_means[top_keys],
                       db.dist_inv_chols[top_keys], log_w, log_dets,
                       db.samples[idx], db.sample_comp[idx],
                       db.target_lnpdfs[idx], db.target_grads[idx], valid,
                       db.sample_iter[idx])


def get_random_samples(db: DecimatingDbState, uniform: torch.Tensor, n: int):
    """(samples, lnpdfs, valid) of ``n`` stored samples drawn without
    replacement: the stored rows in the stable order of ``uniform`` ``[S]``
    (uniform in [0, 1)), the empty rows after them, invalid."""
    ok = torch.arange(db.capacity, device=uniform.device) < db.count
    sel = torch.argsort(torch.where(ok, uniform, 2.0), stable=True)[:n]
    return db.samples[sel], db.target_lnpdfs[sel], ok[sel]
