"""The GMMVI optimizer: one training iteration over an explicit state.

(JAX counterpart: gmmvi_tpu/optimization/gmmvi.py)

The learner state is one :class:`TrainState` with the same field paths as
the JAX package's (``model.means``, ``db.write_pos``, ...).  An iteration
runs eagerly: propose fresh samples (with sample reuse, after an ESS pass
over the newest stored samples: kernels B4 and B2 on the card), evaluate the
target, store them and take the current model's density pack (kernel B1;
B4 again for the older generating distributions), estimate the natural
gradient (Stein, or MORE through kernel B8), update components (the
trust region's search through kernel B3, or a direct or iBLR step) and
weights (kernel B2), then adapt the number of components (VIPS) or keep it
fixed.

A target that is not ``safe_for_jit`` (host state, a Python callable) is
evaluated on the valid rows only, in a power-of-two bucket, as the JAX
package's host-target path evaluates it (:meth:`GMMVI._eval_valid_rows`);
that reads the proposal's mask on the host once a step.  A safe target is
evaluated on the whole proposal, or, with ``tpu.compact_target_eval``
(``auto``: on for the component-based selector with sample reuse, where
most of the padded ``[Kmax n_des]`` proposal is invalid in steady state),
on its valid rows moved to the front and cut to the smallest size of a
ladder of halvings that holds them (:meth:`GMMVI._eval_target_bucketed`),
as the JAX package evaluates it; the count of valid rows is read on the
host once a step, where JAX picks the size on the device.

Every random draw of a step comes from the instance's ``torch.Generator``
unless the caller passes a :class:`StepDraws` with its own.  The iteration
count is a host integer (``TrainState.num_updates``), so the adaptation
gates need no device read; the bisections read one flag per trip.  When
VIPS fills the padded capacity below its ``max_components``, the state is
repadded between steps (:meth:`GMMVI.grow_capacity`), as the JAX package
does.

The ``tpu`` settings of the JAX package that select other paths are read
as it reads them: ``trust_region_search`` (``bracket``, ``newton``,
``grid``, ``bracket-eigen``) and ``trust_region_grid_size``,
``db_eviction: decimate`` (the decimating database,
``sample_db_decimate``, sized by ``max_database_size``,
``decimate_capacity_cap`` and ``max_dists``) and ``debug_nans`` (a step
whose state holds a NaN is run again under :class:`NanCheck`, which
raises ``FloatingPointError`` at the first operation that made one).  With
``num_prior_samples > 0`` and a configured prior, every step draws that
many prior samples, evaluates the target on them and adds them to the add
heuristic's candidates.

With a ``DeviceMesh`` (``mesh=``, or ``tpu.data_shards`` /
``tpu.comp_shards`` through ``parallel.mesh.mesh_from_config``) the step
runs in every rank of a ``torch.distributed`` group: the model and the
optimizer state stay replicated and equal to the bit, every rank draws the
same :class:`StepDraws` (as the JAX package's partitionable PRNG gives the
same values sharded or not), evaluates the target on its block of the
proposal's rows and takes densities, backgrounds and the estimator's and
weight update's sums over its rows of the window, whose per-component
partials are reduced over ``data`` (``parallel/reduce.py`` makes every
collective).  ``tpu.db_layout`` picks the database: ``global`` (the
replicated ring, whose write all-gathers the target's outputs) or
``sharded`` (a ring per rank, ``sample_db_sharded``); ``auto`` takes
``sharded`` on a data mesh where the proposal batch divides by its size
and the eviction is not ``decimate``, as the JAX package does.  On a
``("data", "comp")`` mesh every comp rank takes a slice of the components
through the stepsizes, the estimate and the component update (kernel B3's
search on the slice), and the slices are gathered back.  On the
host-target path each rank evaluates its own valid rows, in a bucket of
the next power of two of the largest rank's count.  The bucketed
evaluation of a safe target compacts the whole proposal alike on every
rank of the global layout, each evaluating its block of the bucket; on the
sharded layout each rank compacts its own rows, in the ladder's size that
holds the largest rank's count.
"""
from __future__ import annotations

import dataclasses
import math
import warnings
from dataclasses import dataclass
from typing import Optional, Union

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from gmmvi_tpu_torch.device import resolve_device
from gmmvi_tpu_torch.experiments.targets.lnpdf import LNPDF
from gmmvi_tpu_torch.models import gmm as gmm_ops
from gmmvi_tpu_torch.models import meta as meta_ops
from gmmvi_tpu_torch.models.gmm import GmmState
from gmmvi_tpu_torch.models.meta import MetaState
from gmmvi_tpu_torch.optimization import component_adaptation as adapt_ops
from gmmvi_tpu_torch.optimization import component_updaters as upd_ops
from gmmvi_tpu_torch.optimization import ng_estimators as est_ops
from gmmvi_tpu_torch.optimization import sample_db as db_ops
from gmmvi_tpu_torch.optimization import sample_selectors as sel_ops
from gmmvi_tpu_torch.optimization import stepsize_adapters as step_ops
from gmmvi_tpu_torch.optimization import weight_updaters as w_ops
from gmmvi_tpu_torch.optimization.component_adaptation import (
    AdaptationState, VipsConfig)
from gmmvi_tpu_torch.optimization import sample_db_decimate as dec_ops
from gmmvi_tpu_torch.optimization import sample_db_sharded as shd_ops
from gmmvi_tpu_torch.optimization.sample_selectors import SelectorConfig
from gmmvi_tpu_torch.optimization.stepsize_adapters import \
    WeightStepsizeState
from gmmvi_tpu_torch.parallel import reduce
from gmmvi_tpu_torch.parallel.mesh import data_axis_size, mesh_from_config
from gmmvi_tpu_torch.utils.profiling import count, read, span


@dataclass
class TrainState:
    """The complete learner state.  ``num_updates`` is a host integer; the
    JAX package's ``key`` has no counterpart (see :class:`StepDraws`)."""

    model: GmmState
    meta: MetaState
    db: Union[db_ops.SampleDbState, dec_ops.DecimatingDbState]
    wstep: WeightStepsizeState
    adapt: AdaptationState
    num_updates: int


@dataclass
class StepDraws:
    """The random numbers one iteration consumes.

    eps standard normal for the fresh samples: ``[Kmax, n_des, D]`` with
    the component-based selector, ``[n_des, D]`` with the mixture-based
    one, which also takes mapping ``[n_des]``, component indices drawn by
    the weights; rand_slots ``[B]`` integers in [0, C) and accept_u ``[B]``
    uniform in [0, 1) (the reservoir; B the proposal's size, ``Kmax n_des``
    or ``n_des``; None for a decimating database, which has none); the
    candidates of an add: db_perm ``[n]`` distinct reservoir slots or, where
    the candidates are the stored samples (the database's ``uses_reservoir``
    False), db_u ``[S]`` uniform in [0, 1); add_a a 0-d uniform (an add).
    These three are read only when an add is due.  prior_eps ``[P, D]``
    standard normal: the prior samples, every step when
    ``num_prior_samples`` P > 0 and a prior is configured.  A sharded
    database (``tpu.db_layout: sharded``) over S shards takes a block per
    shard: rand_slots and accept_u ``[S, B / S]``, db_perm ``[S, ceil(n /
    S)]`` (each row from a permutation of its shard's reservoir slots) or
    db_u ``[S, capacity]``.  On a mesh every rank is given the same draws."""

    eps: torch.Tensor
    rand_slots: Optional[torch.Tensor]
    accept_u: Optional[torch.Tensor]
    db_perm: Optional[torch.Tensor] = None
    add_a: Optional[torch.Tensor] = None
    mapping: Optional[torch.Tensor] = None
    db_u: Optional[torch.Tensor] = None
    prior_eps: Optional[torch.Tensor] = None


class NanCheck(TorchDispatchMode):
    """Raises ``FloatingPointError``, naming the operation, at the first
    operation on tensors whose floating-point output holds a NaN (a
    constant made from a Python NaN is not such an output).  Every output
    is read back: ``tpu.debug_nans`` runs a step under it only to find
    where a NaN that reached the state came from (:meth:`GMMVI.train_iter`),
    as JAX's ``jax_debug_nans`` re-runs a compiled step op by op; masked
    intermediates (a zero weight times a -inf log weight, a rejected
    Cholesky factor) raise there too."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not any(isinstance(a, torch.Tensor)
                   for a in tree_leaves((args, kwargs))):
            return out
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor) and t.is_floating_point() \
                    and bool(torch.isnan(t).any()):
                raise FloatingPointError(f"NaN in the output of {func}")
        return out


def _has_nan(state: "TrainState") -> bool:
    """Whether a floating-point leaf of ``state`` holds a NaN (one read)."""
    flags = [torch.isnan(t).any()
             for part in (state.model, state.meta, state.db, state.wstep,
                          state.adapt)
             for t in vars(part).values()
             if isinstance(t, torch.Tensor) and t.is_floating_point()]
    # on a sharded database the ranks' states differ: all stop or none
    return read(reduce.data_max(torch.stack(flags).any()), "nan_check")


# the meta-state leaves that steps 1-3 of an update may change
_COMPONENT_META = ("stepsizes", "l2_regularizers", "num_received_updates",
                   "last_etas")


def _slice_meta(meta: MetaState, lo: int, hi: int) -> MetaState:
    """Slots ``lo:hi`` of every per-component leaf of ``meta``."""
    return meta.replace(**{
        f.name: getattr(meta, f.name)[lo:hi]
        for f in dataclasses.fields(meta)
        if isinstance(getattr(meta, f.name), torch.Tensor)
        and getattr(meta, f.name).ndim > 0})


def _gather_components(model: GmmState, meta: MetaState, model_c: GmmState,
                       meta_c: MetaState):
    """``model`` and ``meta`` with the components that every comp rank
    updated on its slice: the changed leaves, packed by dtype, in one
    all-gather over ``comp`` each."""
    kmax = model.max_components
    leaves = {("model", n): getattr(model_c, n)
              for n in ("means", "chols", "inv_chols")}
    leaves.update({("meta", n): getattr(meta_c, n) for n in _COMPONENT_META})
    out = {}
    for dtype in {t.dtype for t in leaves.values()}:
        keys = [k for k, t in leaves.items() if t.dtype == dtype]
        flat = [leaves[k].reshape(leaves[k].shape[0], -1) for k in keys]
        full = reduce.comp_gather(torch.cat(flat, 1), kmax)
        for k, part in zip(keys, torch.split(
                full, [f.shape[1] for f in flat], dim=1)):
            out[k] = part.reshape(
                (kmax,) + tuple(leaves[k].shape[1:])).contiguous()
    return (model.replace(**{n: t for (o, n), t in out.items()
                             if o == "model"}),
            meta.replace(**{n: t for (o, n), t in out.items()
                            if o == "meta"}))


class GMMVI:
    """Assembles the training step from a config (module slots as in the
    JAX package) and holds the state between steps."""

    def __init__(self, target_distribution: LNPDF, initial_state: TrainState,
                 temperature: float, selector_cfg: SelectorConfig,
                 estimator_type: str, estimator_cfg: dict,
                 updater_type: str, component_stepsize_type: str,
                 component_stepsize_cfg: dict,
                 weight_updater_type: str, weight_updater_cfg: dict,
                 weight_stepsize_type: str, weight_stepsize_cfg: dict,
                 vips_cfg: Optional[VipsConfig], seed: int,
                 device: torch.device, prior_mean=None, prior_cov_diag=None,
                 trust_region_search: str = "bracket",
                 trust_region_grid_size: int = 32, debug_nans: bool = False,
                 mesh=None, compact_target_eval: str = "auto",
                 shard_local_buckets: bool = False):
        if mesh is not None and "data" not in (mesh.mesh_dim_names or ()):
            raise ValueError(
                f"mesh axes must include 'data' (got {mesh.mesh_dim_names}); "
                "use parallel.mesh.data_mesh or hybrid_mesh")
        self.mesh = mesh
        self.target_distribution = target_distribution
        self.state = initial_state
        self.temperature = float(temperature)
        self.selector_cfg = selector_cfg
        self.estimator_type = estimator_type
        self.estimator_cfg = dict(estimator_cfg)
        self.updater_type = updater_type
        self.component_stepsize_type = component_stepsize_type
        self.component_stepsize_cfg = dict(component_stepsize_cfg)
        self.weight_updater_type = weight_updater_type
        self.weight_updater_cfg = dict(weight_updater_cfg)
        self.weight_stepsize_type = weight_stepsize_type
        self.weight_stepsize_cfg = dict(weight_stepsize_cfg)
        self.vips_cfg = vips_cfg
        self.device = device
        self.generator = torch.Generator(device=device).manual_seed(seed)
        self.trust_region_search = trust_region_search
        self.trust_region_grid_size = int(trust_region_grid_size)
        self.debug_nans = bool(debug_nans)
        # the prior of the add heuristic's prior samples (None: none drawn)
        self.prior_mean = self.prior_std = None
        if (prior_mean is not None and vips_cfg is not None
                and vips_cfg.num_prior_samples > 0):
            self.prior_mean = torch.as_tensor(prior_mean, device=device)
            self.prior_std = torch.sqrt(torch.as_tensor(prior_cov_diag,
                                                        device=device))
        # > 1: the bucketed target evaluation compacts each rank's own rows
        # (the sharded layout, whose ranks hold different proposal rows)
        self._bucket_shards = 1
        if shard_local_buckets:
            if mesh is None:
                raise ValueError(
                    "shard_local_buckets requires a mesh with a 'data' axis")
            self._bucket_shards = data_axis_size(mesh)
        # the ladder of target-evaluation sizes (None: the whole proposal),
        # enabled on the JAX package's rule
        if compact_target_eval == "on":
            enabled = True
        elif compact_target_eval == "off":
            enabled = False
        else:
            enabled = (selector_cfg.is_vips
                       and selector_cfg.reused_samples_per_component > 0)
        self._eval_buckets = None
        if enabled and target_distribution.safe_for_jit \
                and selector_cfg.is_vips:
            self._eval_buckets = self._make_eval_buckets(
                initial_state.model.max_components)

    def _make_eval_buckets(self, kmax: int):
        """The ascending sizes ``batch, batch // 2, ...`` down to ``max(
        ceil(kmax / p), batch // 64)``, ``batch = kmax n_des // p`` with
        ``p`` the ranks that compact their own rows; None where fewer than
        two sizes remain (the JAX package's ladder)."""
        p = self._bucket_shards
        batch = kmax * self.selector_cfg.desired_samples_per_component // p
        floor = max(-(-kmax // p), batch // 64)
        ladder, size = [], batch
        while size >= floor and size > 0:
            ladder.append(size)
            size //= 2
        buckets = tuple(sorted(set(ladder)))
        return buckets if len(buckets) >= 2 else None

    # ------------------------------------------------------------------
    # Random draws
    # ------------------------------------------------------------------
    def draw(self, iteration: int) -> StepDraws:
        """Draws for the step that brings the count to ``iteration + 1``,
        from the instance's generator."""
        model, db = self.state.model, self.state.db
        g, dev = self.generator, self.device
        n_des = self.selector_cfg.desired_samples_per_component
        mapping = None
        if self.selector_cfg.is_vips:
            b = model.max_components * n_des
            eps_shape = (model.max_components, n_des, model.num_dimensions)
        else:
            b = n_des
            eps_shape = (n_des, model.num_dimensions)
            mapping = gmm_ops.sample_categorical(model, n_des, g)
        draws = StepDraws(eps=torch.randn(eps_shape, generator=g, device=dev),
                          rand_slots=None, accept_u=None, mapping=mapping)
        if db.has_reservoir:
            # a sharded database's draws are [P, B / P], a block per shard
            shape = ((db.n_shards, b // db.n_shards) if db.row_sharded
                     else (b,))
            draws.rand_slots = torch.randint(
                0, db.reservoir_capacity, shape, generator=g, device=dev,
                dtype=torch.int32)
            draws.accept_u = torch.rand(shape, generator=g, device=dev)
        cfg = self.vips_cfg
        if cfg is not None and adapt_ops.add_is_due(cfg, iteration + 1):
            n = cfg.num_database_samples
            if db.uses_reservoir and db.row_sharded:
                # each shard's candidates: a permutation of its slots
                n_l = -(-n // db.n_shards)
                draws.db_perm = torch.stack([
                    torch.randperm(db.reservoir_capacity, generator=g,
                                   device=dev)[:n_l]
                    for _ in range(db.n_shards)])
            elif db.uses_reservoir:
                draws.db_perm = torch.randperm(
                    db.reservoir_capacity, generator=g, device=dev)[:n]
            else:
                shape = ((db.n_shards, db.capacity) if db.row_sharded
                         else (db.capacity,))
                draws.db_u = torch.rand(shape, generator=g, device=dev)
            draws.add_a = torch.rand((), generator=g, device=dev)
        if self.prior_mean is not None:
            draws.prior_eps = torch.randn(
                (cfg.num_prior_samples, model.num_dimensions), generator=g,
                device=dev)
        return draws

    # ------------------------------------------------------------------
    # Phases
    # ------------------------------------------------------------------
    def _eval_target(self, samples: torch.Tensor):
        """(lnpdfs, grads) of the target at ``samples``, as the JAX
        package's ``_eval_target`` takes them: without a first-order
        estimator (MORE) ``log_density`` and zero grads; with Stein the
        target's ``log_density_and_grad`` where its
        ``use_log_density_and_grad`` flag is True, else the per-sample
        autograd of its ``log_density`` (``log_density_and_autograd``).
        Every path of a step evaluates the target here (the prior samples
        aside), in a span ``target.call``."""
        target = self.target_distribution
        count("target.rows", samples.shape[0])
        with span("target.call"):
            if self.estimator_type != "Stein":
                return target.log_density(samples), torch.zeros_like(samples)
            if target.use_log_density_and_grad:
                return target.log_density_and_grad(samples)
            return target.log_density_and_autograd(samples)

    def _propose_phase(self, state: TrainState, draws: StepDraws):
        return sel_ops.propose(state.model, state.db, self.selector_cfg,
                               draws.eps, draws.mapping)

    def _prior_samples(self, draws: StepDraws):
        """The prior samples ``prior_mean + sqrt(initial_cov) eps`` and the
        target's log densities at them (None, None without a prior)."""
        if self.prior_mean is None:
            return None, None
        samples = self.prior_mean[None, :] + self.prior_std[None, :] \
            * draws.prior_eps
        count("target.rows", samples.shape[0])
        with span("target.call"):
            lnpdfs = self.target_distribution.log_density(samples)
        return samples, lnpdfs.to(samples.dtype)

    def _update_phase(self, state: TrainState, prop: sel_ops.Proposal,
                      lnpdfs: torch.Tensor, grads: torch.Tensor,
                      draws: StepDraws, prior_samples=None,
                      prior_lnpdfs=None) -> TrainState:
        iteration = state.num_updates
        with span("finalize"):
            db, window, pack = sel_ops.finalize_fused(
                state.model, state.db, self.selector_cfg, iteration, prop,
                lnpdfs, grads, draws.rand_slots, draws.accept_u)
        model, meta, wstep = self._run_updates(state.model, state.meta,
                                               state.wstep, window, pack)
        num_updates = iteration + 1
        adapt = state.adapt
        if self.vips_cfg is not None:
            with span("adapt"):
                model, meta, adapt, db = \
                    adapt_ops.adapt_number_of_components(
                        model, meta, adapt, db, self.vips_cfg, num_updates,
                        draws.db_perm if db.uses_reservoir else draws.db_u,
                        draws.add_a, prior_samples, prior_lnpdfs)
        return TrainState(model=model, meta=meta, db=db, wstep=wstep,
                          adapt=adapt, num_updates=num_updates)

    def _run_updates(self, model: GmmState, meta: MetaState,
                     wstep: WeightStepsizeState, window, pack):
        """Component and weight updates on the window, in the reference's
        order; the weight update sees the updated components.  On a
        ``comp`` axis steps 1-3 take this rank's slice of the components
        (``gmm_ops.slice_components``, :func:`_slice_meta`) and
        :func:`_gather_components` puts the model and the meta-state
        together again.  The estimate (span ``estimate``) is taken before
        the component stepsizes, which it does not read, so that the
        stepsizes and the component update are one span (``update``); the
        weight stepsize and update are the span ``weights``."""
        kmax = model.max_components
        lo, hi = reduce.comp_range(kmax)
        sliced = (lo, hi) != (0, kmax)
        model_c, meta_c = ((gmm_ops.slice_components(model, lo, hi),
                            _slice_meta(meta, lo, hi)) if sliced
                           else (model, meta))
        with span("estimate"):
            est = self._estimate(model, meta_c, window, pack, sliced, lo, hi)
        with span("update"):
            # 1. component stepsizes
            new_stepsizes = step_ops.COMPONENT_STEPSIZE_ADAPTERS[
                self.component_stepsize_type](meta_c,
                                              self.component_stepsize_cfg)
            meta_c = meta_c.replace(stepsizes=torch.where(
                model_c.mask, new_stepsizes, meta_c.stepsizes))
            # 3. component update
            upd_kw = dict(temperature=self.temperature)
            if self.updater_type == "trust-region":
                upd_kw.update(search=self.trust_region_search,
                              grid_size=self.trust_region_grid_size)
            model_c, meta_c = upd_ops.UPDATERS[self.updater_type](
                model_c, meta_c, est.expected_hessians_neg,
                est.expected_gradients_neg, meta_c.stepsizes, **upd_kw)
            if sliced:
                model, meta = _gather_components(model, meta, model_c,
                                                 meta_c)
            else:
                model, meta = model_c, meta_c
        with span("weights"):
            # 4. weight stepsize
            wstep = step_ops.WEIGHT_STEPSIZE_ADAPTERS[
                self.weight_stepsize_type](wstep, model, meta,
                                           self.weight_stepsize_cfg)
            # 5. weight update (stores the component rewards)
            elr, meta = w_ops.expected_log_ratios(
                model, meta, window.samples, window.valid,
                window.background_log_pdfs, window.target_lnpdfs,
                self.temperature,
                self.weight_updater_cfg[
                    "use_self_normalized_importance_weights"])
            model, meta = w_ops.WEIGHT_UPDATERS[self.weight_updater_type](
                model, meta, elr, wstep.stepsize, self.temperature)
        return model, meta, wstep

    def _estimate(self, model: GmmState, meta_c: MetaState, window, pack,
                  sliced: bool, lo: int, hi: int):
        """2. The natural-gradient estimate (Stein or MORE) on the window,
        for this rank's slice of the components where ``sliced``."""
        est_kw = dict(
            use_self_normalized_importance_weights=self.estimator_cfg[
                "use_self_normalized_importance_weights"],
            only_use_own_samples=self.estimator_cfg["only_use_own_samples"],
            pack=pack, newest_mask=window.newest_mask)
        if sliced:
            est_kw.update(comp_slice=(lo, hi))
        if self.estimator_type == "MORE":
            return est_ops.more_estimate(
                model, window.samples, window.valid, window.mapping,
                window.background_log_pdfs, window.target_lnpdfs,
                meta_c.l2_regularizers, **est_kw)
        return est_ops.stein_estimate(
            model, window.samples, window.valid, window.mapping,
            window.background_log_pdfs, window.target_lnpdfs,
            window.target_grads, **est_kw)

    def _eval_valid_rows(self, samples: torch.Tensor, valid: torch.Tensor):
        """The host-target path (a target with ``safe_for_jit`` False), as
        the JAX package's ``train_iter`` takes it: the valid rows, read on
        the host, compacted into a bucket of the next power of two rows (at
        most all of them) padded with row 0, evaluated in one call, and
        scattered back with zeros elsewhere.  Where the padding repeats
        row 0, the last of its copies is kept, as JAX's scatter keeps it on
        the CPU.  A stateful target (a minibatch cursor) so sees the rows,
        in the order, that the JAX package gives it."""
        b, d = samples.shape
        idx = np.flatnonzero(read(lambda: valid.cpu().numpy(),
                                  "host_target"))
        count("target.valid_rows", len(idx))
        n_valid = len(idx)
        if reduce.data_size() > 1:
            # every rank's bucket fits the largest rank's valid rows
            n_valid = read(reduce.data_max(torch.tensor(
                n_valid, device=samples.device)), "host_target.ranks")
        bucket = min(1 << max(n_valid - 1, 0).bit_length(), b)
        padded = np.zeros(bucket, np.int64)
        padded[:len(idx)] = idx
        dev = samples.device
        lnp, grads = self._eval_target(
            samples[torch.as_tensor(padded, device=dev)])
        rows, first_from_end = np.unique(padded[::-1], return_index=True)
        rows = torch.as_tensor(rows, device=dev)
        last = torch.as_tensor(bucket - 1 - first_from_end, device=dev)
        lnpdfs = torch.zeros(b, dtype=samples.dtype, device=dev)
        lnpdfs[rows] = lnp[last].to(samples.dtype)
        out = torch.zeros_like(samples)
        out[rows] = grads[last].to(samples.dtype)
        return lnpdfs, out

    def _bucket_size(self, n_valid: int) -> int:
        """The smallest ladder size that holds ``n_valid`` rows (the
        largest where none does)."""
        return next((s for s in self._eval_buckets if s >= n_valid),
                    self._eval_buckets[-1])

    def _eval_target_bucketed(self, samples: torch.Tensor,
                              valid: torch.Tensor):
        """A safe target on (roughly) the valid rows only, as the JAX
        package's ``_eval_target_bucketed`` evaluates it: the valid rows
        moved to the front in their order (a stable argsort), the first
        rows of the smallest ladder size that holds them evaluated, and the
        results scattered back to those rows, zeros in every other.  Every
        consumer masks invalid rows; the bucket's invalid rows keep the
        target's values, as in JAX.  ``samples``/``valid`` are the whole
        proposal, the same on every rank: each rank evaluates its block of
        the bucket and the blocks are gathered.  Where the ranks compact
        their own rows (``_bucket_shards > 1``) they are this rank's rows,
        and the size holds the largest rank's count (one scalar all-reduce
        over ``data``).  Reads the count on the host (one device-to-host
        copy, the read ``bucket``); counts it under ``target.valid_rows``
        where it is this rank's."""
        b = samples.shape[0]
        shard_local = self._bucket_shards > 1
        order = torch.argsort(valid.logical_not().to(torch.uint8),
                              stable=True)
        n_valid = valid.sum()
        if shard_local:
            n_valid = reduce.data_max(n_valid)
        n_valid = read(n_valid, "bucket")
        if not shard_local:
            count("target.valid_rows", n_valid)
        rows = order[:self._bucket_size(n_valid)]
        bucket = samples[rows]
        if shard_local:
            lnp, grads = self._eval_target(bucket)
        else:
            lnp, grads = self._eval_target(reduce.rows(bucket))
            lnp = reduce.gather_rows(lnp, rows.shape[0])
            grads = reduce.gather_rows(grads, rows.shape[0])
        lnpdfs = lnp.new_zeros((b,))
        lnpdfs[rows] = lnp
        out = grads.new_zeros((b,) + tuple(grads.shape[1:]))
        out[rows] = grads
        return lnpdfs, out

    def _eval_proposal(self, state: TrainState, prop: sel_ops.Proposal):
        """(lnpdfs, grads) of the target at the proposal: this rank's rows
        on a row-sharded database, else the whole batch."""
        b = prop.samples.shape[0]
        safe = self.target_distribution.safe_for_jit
        if safe and self._eval_buckets is not None \
                and self._bucket_shards == 1:
            # every rank compacts the whole proposal alike
            lnpdfs, grads = self._eval_target_bucketed(prop.samples,
                                                       prop.valid)
            if state.db.row_sharded:
                lnpdfs, grads = reduce.rows(lnpdfs), reduce.rows(grads)
            return lnpdfs, grads
        # every rank holds the whole proposal; the target sees its rows
        rows, valid = reduce.rows(prop.samples), reduce.rows(prop.valid)
        if not safe:
            lnpdfs, grads = self._eval_valid_rows(rows, valid)
        elif self._eval_buckets is not None:
            lnpdfs, grads = self._eval_target_bucketed(rows, valid)
        else:
            lnpdfs, grads = self._eval_target(rows)
        if not state.db.row_sharded:
            # a replicated database writes the whole batch
            lnpdfs = reduce.gather_rows(lnpdfs, b)
            grads = reduce.gather_rows(grads, b)
        return lnpdfs, grads

    def _full_step(self, state: TrainState, draws: StepDraws) -> TrainState:
        with span("propose"):
            prop = self._propose_phase(state, draws)
        with span("target"):
            lnpdfs, grads = self._eval_proposal(state, prop)
            prior_samples, prior_lnpdfs = self._prior_samples(draws)
        if state.db.row_sharded:
            # each rank writes its own rows into its own shard
            prop = prop._replace(samples=reduce.rows(prop.samples),
                                 valid=reduce.rows(prop.valid),
                                 mapping=reduce.rows(prop.mapping))
        return self._update_phase(state, prop, lnpdfs, grads, draws,
                                  prior_samples, prior_lnpdfs)

    # ------------------------------------------------------------------
    # Capacity growth (VIPS can outgrow the initial padding)
    # ------------------------------------------------------------------
    def grow_capacity(self, new_max_components: int) -> None:
        """Grow the padded component capacity of the whole state: model,
        meta-state, the distribution ring's component axis and the sample
        ring (to the window of the new capacity).  Window contents,
        meta-state and feval counts are kept exactly; the selector's
        settings (``max_background_dists`` included) stay as built."""
        state = self.state
        if new_max_components <= state.model.max_components:
            return
        new_cap = sel_ops.total_window_size(self.selector_cfg,
                                            new_max_components)
        self.state = TrainState(
            model=gmm_ops.repad(state.model, new_max_components),
            meta=meta_ops.repad_meta(state.meta, new_max_components),
            db=state.db.repad(new_max_components, new_cap),
            wstep=state.wstep, adapt=state.adapt,
            num_updates=state.num_updates)
        if self._eval_buckets is not None:
            self._eval_buckets = self._make_eval_buckets(new_max_components)

    def _has_growth_headroom(self) -> bool:
        cfg = self.vips_cfg
        return (cfg is not None
                and self.state.model.max_components < cfg.max_components)

    def _grow_if_full(self) -> None:
        """If VIPS has filled the padding below its ``max_components``, grow
        it (with a warning) to ``min(max_components, round_up(max(2 Kmax,
        Kmax + 8), 8))`` rather than let adds become no-ops.  Reads
        ``num_active`` on the host."""
        if not self._has_growth_headroom():
            return
        cfg = self.vips_cfg
        kmax = self.state.model.max_components
        if read(self.state.model.num_active, "grow") >= kmax:
            new_kmax = min(cfg.max_components,
                           (max(2 * kmax, kmax + 8) + 7) // 8 * 8)
            warnings.warn(
                f"component capacity {kmax} exhausted; repadding to "
                f"{new_kmax} (max_components={cfg.max_components}). Set "
                "tpu.max_components to preallocate.")
            self.grow_capacity(new_kmax)

    def _maybe_grow(self) -> None:
        """The capacity check before every ``add_iters``-th step (iteration
        counts 0, add_iters, 2 add_iters, ...): with adds spaced
        ``add_iters`` apart, exactly one check falls between two adds.  The
        schedule follows the iteration count, so a resumed run checks where
        an unbroken one does."""
        if self._has_growth_headroom() \
                and self.state.num_updates % max(1, self.vips_cfg.add_iters) \
                == 0:
            self._grow_if_full()

    # ------------------------------------------------------------------
    # Public API
    # ------------------------------------------------------------------
    def train_iter(self, draws: Optional[StepDraws] = None) -> None:
        """Advance one iteration, with ``draws`` or fresh generator draws
        (made after any capacity growth, at the grown shapes).  On a mesh
        every rank calls it, with the same draws.  While tracing is on
        (``utils.profiling``) the step is the span ``train_iter`` around
        ``grow``, ``draw``, ``propose``, ``target``, ``finalize``,
        ``estimate``, ``update``, ``weights`` and ``adapt``."""
        with span("train_iter"), reduce.scope(self.mesh):
            with span("grow"):
                self._maybe_grow()
            if draws is None:
                with span("draw"):
                    draws = self.draw(self.state.num_updates)
            state = self._full_step(self.state, draws)
            if self.debug_nans and _has_nan(state):
                # the step again, op by op, to name where the NaN came from
                with NanCheck():
                    self._full_step(self.state, draws)
                raise FloatingPointError("NaN in the state after the step")
        self.state = state

    def train_iters(self, n: int) -> None:
        for _ in range(n):
            self.train_iter()

    @property
    def model(self) -> GmmState:
        return self.state.model

    @property
    def num_updates(self) -> int:
        return self.state.num_updates

    # ------------------------------------------------------------------
    # Construction
    # ------------------------------------------------------------------
    @staticmethod
    def build_from_config(config: dict, target_distribution: LNPDF,
                          model: GmmState, meta: Optional[MetaState] = None,
                          seed: Optional[int] = None,
                          device="cuda", mesh=None) -> "GMMVI":
        """A GMMVI instance from a reference-schema config dict; ``model``
        is a padded GmmState (see ``experiments.setup``) on ``device``.
        ``mesh`` (a ``DeviceMesh``; by default the one ``tpu.data_shards``
        / ``tpu.comp_shards`` ask for, or None) makes it a meshed run: call
        it in every rank."""
        from gmmvi_tpu_torch.configs import validate_config

        dev = resolve_device(device)
        validate_config(config)
        tpu_cfg = config.get("tpu", {}) or {}
        if mesh is None:
            mesh = mesh_from_config(tpu_cfg, device_type=dev.type)
        if model.device != dev:
            raise ValueError(f"model is on {model.device}, expected {dev}")
        kmax, d = model.max_components, model.num_dimensions

        sel_c = config["sample_selector_config"]
        n_des = int(sel_c["desired_samples_per_component"])
        reused = int(math.floor(sel_c["ratio_reused_samples_to_desired"]
                                * n_des))
        default_bg = min(4 * kmax, 2048) if reused > 0 else kmax
        selector_cfg = SelectorConfig(
            kind=config["sample_selector_type"],
            desired_samples_per_component=n_des,
            reused_samples_per_component=reused,
            max_background_dists=int(tpu_cfg.get("max_background_dists",
                                                 default_bg)))

        vips_cfg = None
        prior_mean = prior_cov_diag = None
        if config["num_component_adapter_type"] == "adaptive":
            ac = config["num_component_adapter_config"]
            mi = config.get("model_initialization", {})
            pm, ic = mi.get("prior_mean"), mi.get("initial_cov")
            prior_entropy = None
            if pm is not None and ic is not None:
                prior_mean = np.asarray(pm, np.float32) * np.ones(
                    d, np.float32)
                prior_cov_diag = np.asarray(ic, np.float32) * np.ones(
                    d, np.float32)
                prior_entropy = adapt_ops.diagonal_gaussian_entropy(
                    prior_cov_diag)
            vips_cfg = VipsConfig(
                del_iters=int(ac["del_iters"]),
                add_iters=int(ac["add_iters"]),
                max_components=int(ac["max_components"]),
                thresholds_for_add_heuristic=tuple(
                    float(t) for t in np.atleast_1d(
                        ac["thresholds_for_add_heuristic"])),
                min_weight_for_del_heuristic=float(
                    ac["min_weight_for_del_heuristic"]),
                num_database_samples=int(ac["num_database_samples"]),
                num_prior_samples=int(ac["num_prior_samples"]),
                prior_entropy=prior_entropy)

        w_total = sel_ops.total_window_size(selector_cfg, kmax)
        # with reuse, old samples need their generating distributions kept
        default_ring = (min(reused + 4, int(tpu_cfg.get("max_dist_ring_iters",
                                                        64)))
                        if reused > 0 else 2)
        num_db_cand = (vips_cfg.num_database_samples if vips_cfg is not None
                       else 0)
        reservoir = int(tpu_cfg.get("reservoir_capacity",
                                    max(1024, min(num_db_cand, 16384))))
        if vips_cfg is not None and vips_cfg.num_database_samples > reservoir:
            vips_cfg = vips_cfg._replace(num_database_samples=reservoir)
        keep_samples = bool(config.get("use_sample_database", True))
        db_eviction = str(tpu_cfg.get("db_eviction", "ring"))
        dist_ring_iters = int(tpu_cfg.get("dist_ring_iters", default_ring))
        batch = kmax * n_des if selector_cfg.is_vips else n_des
        layout = _db_layout(str(tpu_cfg.get("db_layout", "auto")), mesh,
                            db_eviction, batch)
        if layout == "sharded":
            db = shd_ops.create_sharded_db(
                dim=d, max_components=kmax, capacity=w_total,
                dist_ring_iters=dist_ring_iters,
                reservoir_capacity=reservoir,
                n_shards=data_axis_size(mesh), n_local=1,
                first_shard=mesh.get_local_rank("data"),
                diagonal=model.diagonal, keep_samples=keep_samples,
                device=dev)
        elif db_eviction == "decimate":
            # the reference's decimation on overflow, as the JAX package
            # sizes it: every add appends <= num_active components and >=
            # num_active samples, so capacity + Kmax table rows suffice
            cap = max(min(int(config.get("max_database_size", 10_000_000)),
                          int(tpu_cfg.get("decimate_capacity_cap",
                                          262_144))), w_total)
            db = dec_ops.create_decimating_db(
                dim=d, max_components=kmax, capacity=cap,
                dist_capacity=int(tpu_cfg.get("max_dists", cap + kmax)),
                diagonal=model.diagonal, keep_samples=keep_samples,
                device=dev)
        else:
            db = db_ops.create_sample_db(
                dim=d, max_components=kmax, capacity=w_total,
                dist_ring_iters=dist_ring_iters,
                reservoir_capacity=reservoir, diagonal=model.diagonal,
                keep_samples=keep_samples, device=dev)
        if not keep_samples:
            # no database: no reuse, as the JAX package configures it
            selector_cfg = selector_cfg._replace(reused_samples_per_component=0)

        if meta is None:
            meta = meta_ops.create_meta_state(
                model,
                config["component_stepsize_adapter_config"][
                    "initial_stepsize"],
                config.get("ng_estimator_config", {}).get(
                    "initial_l2_regularizer", 1e-12),
                meta_ops.history_length_from_config(config))
        wstep = step_ops.create_weight_stepsize_state(
            config["weight_stepsize_adapter_config"]["initial_stepsize"],
            device=dev)
        if seed is None:
            seed = int(config.get("seed", config.get("start_seed", 0)))
        state = TrainState(model=model, meta=meta, db=db, wstep=wstep,
                           adapt=adapt_ops.create_adaptation_state(dev),
                           num_updates=0)
        est_cfg = dict(config.get("ng_estimator_config", {}))
        est_cfg.setdefault("only_use_own_samples", False)
        est_cfg.setdefault("use_self_normalized_importance_weights", True)
        est_cfg.pop("initial_l2_regularizer", None)
        return GMMVI(
            target_distribution=target_distribution, initial_state=state,
            temperature=config["temperature"], selector_cfg=selector_cfg,
            estimator_type=config["ng_estimator_type"], estimator_cfg=est_cfg,
            updater_type=config["ng_based_updater_type"],
            component_stepsize_type=config[
                "component_stepsize_adapter_type"],
            component_stepsize_cfg=config[
                "component_stepsize_adapter_config"],
            weight_updater_type=config["weight_updater_type"],
            weight_updater_cfg=config["weight_updater_config"],
            weight_stepsize_type=config["weight_stepsize_adapter_type"],
            weight_stepsize_cfg=config["weight_stepsize_adapter_config"],
            vips_cfg=vips_cfg, seed=seed, device=dev, prior_mean=prior_mean,
            prior_cov_diag=prior_cov_diag,
            trust_region_search=str(tpu_cfg.get("trust_region_search",
                                                "bracket")),
            trust_region_grid_size=int(tpu_cfg.get("trust_region_grid_size",
                                                   32)),
            debug_nans=bool(tpu_cfg.get("debug_nans", False)), mesh=mesh,
            compact_target_eval=str(tpu_cfg.get("compact_target_eval",
                                                "auto")),
            # under the sharded layout each rank compacts its own rows
            shard_local_buckets=(layout == "sharded"))


def _db_layout(layout: str, mesh, db_eviction: str, batch: int) -> str:
    """``global`` or ``sharded``, as the JAX package chooses: ``auto`` is
    ``sharded`` on a data mesh where its preconditions hold (with a
    warning where they do not), an explicit layout is checked."""
    has_data = mesh is not None and "data" in (mesh.mesh_dim_names or ())
    n_sh = data_axis_size(mesh) if has_data else 1
    if layout == "auto":
        if not has_data:
            return "global"
        if db_eviction == "decimate":
            reason = ("tpu.db_eviction: decimate is a global store by "
                      "definition")
        elif batch % n_sh:
            reason = (f"the proposal batch ({batch}) is not divisible by "
                      f"the data-axis size ({n_sh})")
        else:
            return "sharded"
        warnings.warn("tpu.db_layout: auto falls back to the global ring "
                      f"(per-step batch all-gathers) — {reason}")
        return "global"
    if layout == "sharded":
        if not has_data:
            raise ValueError(
                "tpu.db_layout: sharded requires a mesh with a 'data' axis "
                "(set tpu.data_shards or pass mesh=)")
        if db_eviction == "decimate":
            raise ValueError(
                "tpu.db_layout: sharded is incompatible with "
                "tpu.db_eviction: decimate (the decimation parity mode is a "
                "global store by definition)")
        if batch % n_sh:
            raise ValueError(
                f"tpu.db_layout: sharded needs the proposal batch ({batch} "
                f"= Kmax*n_des) divisible by the data-axis size ({n_sh}); "
                "adjust desired_samples_per_component or "
                "tpu.max_components")
    return layout
