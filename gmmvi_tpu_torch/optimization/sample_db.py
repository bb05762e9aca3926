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
generating distributions are read back from the distribution ring: the
distinct ones are counted, the ``max_background_dists`` most used kept (in
``lax.top_k``'s order) and their count-weighted mixture evaluated at every
sample by kernel B4 (``ops/background.py``, whose plain version is the JAX
package's ``_dist_log_pdfs`` chain).  Counts and the selection table are
scatters into spill-binned tensors, so no step reads the device.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Tuple

import torch

from gmmvi_tpu_torch.device import resolve_device
from gmmvi_tpu_torch.models.gmm import DensityPack, GmmState, density_pack
from gmmvi_tpu_torch.ops.background import background_logpdf
from gmmvi_tpu_torch.ops.stable import NEG_INF, masked_logsumexp


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
    dist_chols: torch.Tensor           # [R, Kmax, D, D]
    dist_inv_chols: torch.Tensor       # [R, Kmax, D, D]
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


def create_sample_db(dim: int, max_components: int, capacity: int,
                     dist_ring_iters: int, reservoir_capacity: int,
                     diagonal: bool = False, keep_samples: bool = True,
                     device="cuda") -> SampleDbState:
    if diagonal:
        raise NotImplementedError(
            "diagonal covariances are not ported yet (full covariances only)")
    device = resolve_device(device)
    s, r, kmax, c = capacity, dist_ring_iters, max_components, \
        reservoir_capacity
    f32 = dict(dtype=torch.float32, device=device)
    i32 = dict(dtype=torch.int32, device=device)
    eye = torch.eye(dim, **f32).expand(r, kmax, dim, dim).contiguous()
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
    s, b = db.capacity, samples.shape[0]
    if b > s:
        raise ValueError(f"batch {b} > ring capacity {s}")
    dev = samples.device
    validf = valid.to(torch.int32)
    n_valid = validf.sum(dtype=torch.int32)

    order = torch.argsort(torch.logical_not(valid).to(torch.int8),
                          stable=True)
    j = torch.arange(b, device=dev)
    idx = torch.remainder(db.write_pos.to(torch.int64) + j, s)
    take = j < n_valid

    def splice(ring, rows):
        sel = take.reshape((b,) + (1,) * (ring.ndim - 1))
        merged = torch.where(sel, rows[order].to(ring.dtype), ring[idx])
        return ring.index_copy(0, idx, merged)

    iters_b = torch.full((b,), iteration, dtype=torch.int32, device=dev)
    new_db = db.replace(
        samples=splice(db.samples, samples),
        target_lnpdfs=splice(db.target_lnpdfs, target_lnpdfs),
        target_grads=splice(db.target_grads, target_grads),
        sample_iter=splice(db.sample_iter, iters_b),
        sample_comp=splice(db.sample_comp, mapping),
        write_pos=db.write_pos + n_valid,
        num_samples_written=db.num_samples_written + n_valid,
    )

    # distribution ring: snapshot the current components
    row = iteration % db.ring_iters

    def set_row(ring, value):
        out = ring.clone()
        out[row] = value
        return out

    new_db = new_db.replace(
        dist_means=set_row(db.dist_means, model.means),
        dist_chols=set_row(db.dist_chols, model.chols),
        dist_inv_chols=set_row(db.dist_inv_chols, model.inv_chols),
        dist_block_iter=set_row(db.dist_block_iter, iteration),
    )

    # reservoir: uniform over history, batched random replacement
    c = db.reservoir_capacity
    item_no = db.res_count + torch.cumsum(validf, 0, dtype=torch.int32)
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
    return new_db.replace(
        res_samples=torch.where(found[:, None], samples[src],
                                db.res_samples),
        res_lnpdfs=torch.where(found, target_lnpdfs[src], db.res_lnpdfs),
        res_count=db.res_count + n_valid,
    )


@dataclass
class SampleWindow:
    """A statically-shaped view of the newest samples with their background
    densities; ``[W]``-shaped with a validity mask."""

    samples: torch.Tensor              # [W, D]
    mapping: torch.Tensor              # [W] generating slot
    target_lnpdfs: torch.Tensor        # [W]
    target_grads: torch.Tensor         # [W, D]
    background_log_pdfs: torch.Tensor  # [W]
    valid: torch.Tensor                # [W] bool
    num_valid: torch.Tensor            # 0-d int32
    sample_iters: torch.Tensor         # [W] int32

    @property
    def newest_mask(self) -> torch.Tensor:
        """True for the valid samples of the newest add batch."""
        newest = torch.max(torch.where(self.valid, self.sample_iters, -1))
        return self.valid & (self.sample_iters == newest)


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
    chols = db.dist_chols.reshape(-1, d, d)[keys]
    log_dets = torch.sum(torch.log(torch.diagonal(chols, dim1=-2, dim2=-1)),
                         -1)
    return (db.dist_means.reshape(-1, d)[keys],
            db.dist_inv_chols.reshape(-1, d, d)[keys], log_dets)


def _count(bins: torch.Tensor, size: int) -> torch.Tensor:
    """``[size]`` float counts of ``bins``; entries equal to ``size`` go to
    a spill bin (a scatter-add of ones: exact, and unlike bincount no host
    sync)."""
    bins = bins.long()
    return torch.zeros(size + 1, dtype=torch.float32,
                       device=bins.device).index_add_(
        0, bins, torch.ones_like(bins, dtype=torch.float32))[:size]


def _select_dists(counts: torch.Tensor, u: int, dist_key: torch.Tensor):
    """The ``u`` most used distributions in ``lax.top_k``'s order (by count,
    ties to the lower key): ``(top_counts, top_keys, sel_mask, selected)``
    where ``selected`` says for each sample whether its distribution is among
    them."""
    nkeys = counts.shape[0]
    top_keys = torch.sort(counts, descending=True, stable=True).indices[:u]
    top_counts = counts[top_keys]
    sel_mask = top_counts > 0
    table = torch.zeros(nkeys + 1, dtype=torch.bool, device=counts.device)
    table[torch.where(sel_mask, top_keys, nkeys)] = True
    selected = table[torch.clamp(dist_key.long(), max=nkeys)]
    return top_counts, top_keys, sel_mask, selected


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
    counts = _count(torch.where(valid, dist_key, nkeys), nkeys)
    top_counts, top_keys, sel_mask, selected = _select_dists(
        counts, min(max_background_dists, nkeys), dist_key)
    valid = valid & selected
    total = torch.sum(torch.where(sel_mask, top_counts, 0.0))
    log_weights = torch.where(
        sel_mask, torch.log(top_counts) - torch.log(torch.clamp(total,
                                                                min=1.0)),
        NEG_INF)
    means_u, inv_u, log_dets_u = _gather_dists(db, top_keys)
    bg = background_logpdf(means_u, inv_u, log_weights, log_dets_u, samples)
    return SampleWindow(
        samples=samples, mapping=comp, target_lnpdfs=lnpdfs,
        target_grads=grads, background_log_pdfs=bg, valid=valid,
        num_valid=valid.sum(dtype=torch.int32), sample_iters=sample_iters)


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
    pack = density_pack(model, samples)

    is_cur = torch.div(dist_key, kmax, rounding_mode="floor") \
        == iteration % r
    counts_cur = _count(torch.where(valid & is_cur, comp, kmax), kmax)
    if not any_old_dists:
        total = counts_cur.sum()
        log_w_cur = torch.where(
            counts_cur > 0,
            torch.log(torch.clamp(counts_cur, min=1.0))
            - torch.log(torch.clamp(total, min=1.0)),
            NEG_INF)
        bg = masked_logsumexp(
            pack.component_log_densities + log_w_cur[:, None],
            mask=(counts_cur > 0)[:, None], dim=0)
        valid = valid & is_cur
    else:
        nkeys = r * kmax
        counts = _count(torch.where(valid & ~is_cur, dist_key, nkeys), nkeys)
        top_counts, top_keys, sel_mask, selected = _select_dists(
            counts, min(max_background_dists, nkeys), dist_key)
        valid = valid & (is_cur | selected)
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
        bg_old = background_logpdf(means_u, inv_u, log_w_old, log_dets_u,
                                   samples)
        bg_cur = masked_logsumexp(
            pack.component_log_densities + log_w_cur[:, None],
            mask=(counts_cur > 0)[:, None], dim=0)
        bg = torch.logaddexp(bg_cur, bg_old)
    win = SampleWindow(
        samples=samples, mapping=comp, target_lnpdfs=lnpdfs,
        target_grads=grads, background_log_pdfs=bg, valid=valid,
        num_valid=valid.sum(dtype=torch.int32), sample_iters=sample_iters)
    return win, pack


def get_random_samples(db: SampleDbState, perm: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(samples, lnpdfs, valid) at reservoir slots ``perm`` (the first n
    entries of a random permutation of the C slots, so no slot repeats);
    slots beyond the filled prefix are invalid."""
    if not db.keep_samples:
        raise NotImplementedError(
            "candidates from the newest batch (use_sample_database: False) "
            "are not ported yet")
    filled = torch.clamp(db.res_count, max=db.reservoir_capacity)
    perm = perm.long()
    return db.res_samples[perm], db.res_lnpdfs[perm], perm < filled

