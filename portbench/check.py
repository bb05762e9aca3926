"""The comparison that decides ``correct``.

One timed iteration, the first of the window's first block, is captured as
the program runs it: its draws, the proposal and the target's values on it
(``GMMVI._eval_proposal``), the window and density pack that
``finalize_fused`` returns (the pack's component densities on a sample of
window rows drawn from the seed), the natural-gradient estimate
(``stein_estimate``) and the model and meta-state the step leaves.  Its
state before the step is the replay's snapshot, which the reference's own
step made (``core.warm_up``).  Everything captured is copied to the host
at once, so the window's peak memory is unchanged.

Once the window has closed and the program's state is freed, the frozen
plain reference (``portbench/reference``) judges it stage by stage in
float64 (:func:`judge`), each stage from the program's own inputs to it:
the target at the proposal's valid rows (its own target, made from the
published seed; the gradients at the rows whose float32 gradient
float32 determines), the database write and the window, the density pack and
the background (kernel B4's part in it) over the window, the Stein
estimate over that window, the trust-region search and the component
update from the program's estimate, and the weight update from the
reference's own updated components.  Float32 cannot be followed further:
the two bisections stop at coarse thresholds, so a decision whose KL a
float32 twin of the reference's arithmetic puts within ``KL_SLACK`` times
its own error (or ``AMBIGUITY`` of the bound) of a threshold may go either
way, and the program's eta is matched to the nearest outcome the reference
can reach (an unreachable one is counted in ``search_mismatch``).  For the
same reason the updated means and factors are judged, relative to their
norms, against that float32 twin of the update at the program's own eta
(from the program's estimate): at planar_robot_4's etas (1e3 to 1e7)
float32 moves a mean up to a hundred times farther than the float64
update does.  They are judged at the components whose eta the twin
reaches and whose float32 update one unit in the last place of eta moves
by at most ``STABLE`` (``update_judged`` counts them); elsewhere float32
does not determine the update.

The control is the reference in float32 with TF32 on
(:func:`reference_step` with ``tf32``), put in the program's place: it
produces the captured quantities itself and is judged as the program is.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import sys
from typing import Dict, List, Optional, Tuple

import torch

# relative distance of a KL to a bisection threshold below which the
# reference follows the decision both ways
AMBIGUITY = 1e-3
# how many times the float32 twin's KL error another float32 search may err
KL_SLACK = 100.0
# leaves of one component's (or the weights') decision tree at most
MAX_OUTCOMES = 64
# rows of the window whose component densities are compared
COMP_ROWS = 2048
NUMBERS = ("target_lnpdf", "target_grad", "window_mismatch",
           "density_model", "density_comp", "density_grad", "background",
           "ng_grad", "ng_hess", "ng_grad_med", "ng_hess_med",
           "search_mismatch", "update_judged", "update_means",
           "update_chols", "update_weights")


# ----------------------------------------------------------------------
# Host copies
# ----------------------------------------------------------------------
def to_device(obj, device):
    """``obj`` with every tensor moved to ``device``: dataclasses and
    named tuples rebuilt, dicts and lists mapped."""
    if isinstance(obj, torch.Tensor):
        return obj.to(device)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(obj, **{
            f.name: to_device(getattr(obj, f.name), device)
            for f in dataclasses.fields(obj) if f.init})
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*(to_device(v, device) for v in obj))
    if isinstance(obj, dict):
        return {k: to_device(v, device) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(to_device(v, device) for v in obj)
    return obj


def fields_of(obj) -> dict:
    if dataclasses.is_dataclass(obj):
        return {f.name: getattr(obj, f.name)
                for f in dataclasses.fields(obj) if f.init}
    return dict(obj._asdict())


def comp_rows(seed: int, window_rows: int) -> torch.Tensor:
    """The window rows whose component densities are compared, drawn from
    the seed."""
    g = torch.Generator().manual_seed(int(seed) % (2 ** 63))
    n = min(COMP_ROWS, window_rows)
    return torch.randperm(window_rows, generator=g)[:n].sort().values


# ----------------------------------------------------------------------
# Capture of the program's timed iteration
# ----------------------------------------------------------------------
class Capture:
    """Records the program's quantities over one ``train_iter`` between
    :meth:`arm` and :meth:`disarm`, copied to the host."""

    def __init__(self, opt, rows: torch.Tensor):
        self.opt = opt
        self.rows = rows
        self.data: Dict[str, object] = {}
        self._undo: List[Tuple[object, str, object]] = []

    def _patch(self, owner, name, wrapper):
        self._undo.append((owner, name, owner.__dict__.get(name)))
        setattr(owner, name, wrapper)

    def arm(self) -> None:
        opt = self.opt
        sel_mod = sys.modules["gmmvi_tpu_torch.optimization.sample_selectors"]
        est_mod = sys.modules["gmmvi_tpu_torch.optimization.ng_estimators"]
        draw, evaluate = opt.draw, opt._eval_proposal
        finalize, stein = sel_mod.finalize_fused, est_mod.stein_estimate
        rows = self.rows.to(opt.device)
        data = self.data

        def draw_w(iteration):
            draws = draw(iteration)
            data["draws"] = to_device(draws, "cpu")
            return draws

        def evaluate_w(state, prop):
            lnpdfs, grads = evaluate(state, prop)
            data["proposal"] = to_device(prop, "cpu")
            data["lnpdfs"], data["grads"] = lnpdfs.cpu(), grads.cpu()
            return lnpdfs, grads

        def finalize_w(*args, **kw):
            db, win, pack = finalize(*args, **kw)
            data["window"] = to_device(win, "cpu")
            data["pack"] = {
                "model": pack.model_log_densities.cpu(),
                "grads": pack.model_grads.cpu(),
                "comp": pack.component_log_densities.index_select(
                    1, rows).cpu()}
            return db, win, pack

        def stein_w(*args, **kw):
            est = stein(*args, **kw)
            data["estimate"] = to_device(est, "cpu")
            return est

        self._patch(opt, "draw", draw_w)
        self._patch(opt, "_eval_proposal", evaluate_w)
        self._patch(sel_mod, "finalize_fused", finalize_w)
        self._patch(est_mod, "stein_estimate", stein_w)

    def disarm(self) -> None:
        for owner, name, old in reversed(self._undo):
            if old is None:
                delattr(owner, name)
            else:
                setattr(owner, name, old)
        self._undo.clear()
        state = self.opt.state
        self.data["model"] = to_device(state.model, "cpu")
        self.data["meta"] = to_device(state.meta, "cpu")
        self.data["rows"] = self.rows


# ----------------------------------------------------------------------
# The reference's side
# ----------------------------------------------------------------------
@contextlib.contextmanager
def precision(tf32: bool):
    """Float32 matrix products in full float32, or in TF32 (the control)."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def ref_modules():
    """The reference's modules, imported on first use."""
    from portbench.reference.experiments import setup as ref_setup
    from portbench.reference.models import gmm as ref_gmm
    from portbench.reference.models import meta as ref_meta
    from portbench.reference.optimization import (
        component_updaters as ref_upd, ng_estimators as ref_est,
        sample_db as ref_db, sample_selectors as ref_sel,
        sample_window as ref_win, stepsize_adapters as ref_step,
        weight_updaters as ref_w)
    from portbench.reference.ops import trust_region as ref_tr
    return dict(setup=ref_setup, gmm=ref_gmm, meta=ref_meta, upd=ref_upd,
                est=ref_est, db=ref_db, sel=ref_sel, win=ref_win,
                step=ref_step, w=ref_w, tr=ref_tr)


def as_ref(obj, cls):
    """The program's state part ``obj`` as the reference's ``cls`` (the
    same fields)."""
    values = fields_of(obj)
    return cls(**{f.name: values[f.name] for f in dataclasses.fields(cls)
                  if f.init and f.name in values})


@dataclasses.dataclass
class StepSettings:
    """What the config dict sets for one step, read as
    ``GMMVI.build_from_config`` reads it."""

    selector: object
    temperature: float
    estimator: dict
    component_stepsize: Tuple[str, dict]
    weight_stepsize: Tuple[str, dict]
    weight_updater: Tuple[str, dict]
    updater: str
    search: str

    @staticmethod
    def from_config(cfg: dict, kmax: int) -> "StepSettings":
        m = ref_modules()
        if cfg["ng_estimator_type"] != "Stein":
            raise NotImplementedError("the reference judges Stein steps")
        tpu = cfg.get("tpu", {}) or {}
        sel_c = cfg["sample_selector_config"]
        n_des = int(sel_c["desired_samples_per_component"])
        reused = int(math.floor(sel_c["ratio_reused_samples_to_desired"]
                                * n_des))
        default_bg = min(4 * kmax, 2048) if reused > 0 else kmax
        if not cfg.get("use_sample_database", True):
            reused = 0
        selector = m["sel"].SelectorConfig(
            kind=cfg["sample_selector_type"],
            desired_samples_per_component=n_des,
            reused_samples_per_component=reused,
            max_background_dists=int(tpu.get("max_background_dists",
                                             default_bg)))
        est = dict(cfg.get("ng_estimator_config", {}))
        est.setdefault("only_use_own_samples", False)
        est.setdefault("use_self_normalized_importance_weights", True)
        return StepSettings(
            selector=selector, temperature=float(cfg["temperature"]),
            estimator=est,
            component_stepsize=(cfg["component_stepsize_adapter_type"],
                                cfg["component_stepsize_adapter_config"]),
            weight_stepsize=(cfg["weight_stepsize_adapter_type"],
                             cfg["weight_stepsize_adapter_config"]),
            weight_updater=(cfg["weight_updater_type"],
                            cfg["weight_updater_config"]),
            updater=cfg["ng_based_updater_type"],
            search=str(tpu.get("trust_region_search", "bracket")))


def ref_state(snapshot):
    """The program's snapshot as the reference's state parts."""
    m = ref_modules()
    return dict(
        model=as_ref(snapshot.model, m["gmm"].GmmState),
        meta=as_ref(snapshot.meta, m["meta"].MetaState),
        db=as_ref(snapshot.db, m["db"].SampleDbState),
        wstep=as_ref(snapshot.wstep, m["step"].WeightStepsizeState),
        iteration=snapshot.num_updates)


def ref_eval_target(target, samples, estimator_type: str = "Stein"):
    """The reference's ``GMMVI._eval_target``."""
    if estimator_type != "Stein":
        return target.log_density(samples), torch.zeros_like(samples)
    if target.use_log_density_and_grad:
        return target.log_density_and_grad(samples)
    return target.log_density_and_autograd(samples)


def to64(obj):
    """``obj`` with every floating-point tensor in float64."""
    if isinstance(obj, torch.Tensor):
        return obj.double() if obj.is_floating_point() else obj
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(obj, **{
            f.name: to64(getattr(obj, f.name))
            for f in dataclasses.fields(obj) if f.init})
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*(to64(v) for v in obj))
    if isinstance(obj, dict):
        return {k: to64(v) for k, v in obj.items()}
    return obj


def _stored_eta(exp_lower, exp_upper, temperature):
    success = exp_lower == exp_upper
    return torch.where(success, torch.clamp(exp_lower, min=temperature),
                       -1.0)


def _near(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.abs(a - b) <= 1e-5 * torch.abs(b) + 1e-6


def _choices(value, threshold, margin) -> list:
    """The outcomes of ``value < threshold`` that float32 could give: both
    where ``value`` lies within ``margin`` of ``threshold``."""
    if bool(torch.abs(value - threshold) < margin):
        return [True, False]
    return [bool(value < threshold)]


def _bracket_trip(lower, upper, upper_ok, eta, kl, kl_bound, act,
                  good=None, go_low=None, stop_width=None):
    """One trip of the reference's ``bracket_search`` (its arithmetic),
    with ``good``/``go_low``/``stop_width`` forced where given."""
    if stop_width is None:
        diff = torch.minimum(torch.exp(upper) - torch.exp(eta),
                             torch.exp(eta) - torch.exp(lower))
        stop_width = diff < 1e-1
    if good is None:
        good = torch.abs(kl_bound - kl) < 1e-1 * kl_bound
    if go_low is None:
        go_low = kl_bound > kl
    new_lower = torch.where(
        stop_width, lower,
        torch.where(good, eta, torch.where(go_low, lower, eta)))
    new_upper = torch.where(
        stop_width, upper,
        torch.where(good, eta, torch.where(go_low, eta, upper)))
    new_upper_ok = torch.where(~stop_width & ~good, upper_ok | go_low,
                               upper_ok)
    return (torch.where(act, new_lower, lower),
            torch.where(act, new_upper, upper),
            torch.where(act, new_upper_ok, upper_ok),
            stop_width | good)


def _kl_margin(kl64, kl32, b):
    """How far float32 may put a KL from the float64 one: ``KL_SLACK``
    times their gap here (another float32 arithmetic, a kernel's, may
    round worse than the twin's), at least ``AMBIGUITY`` of the bound;
    unbounded where one of them is not a number or a rejection
    (F32_MAX)."""
    big = 0.5 * torch.finfo(torch.float32).max
    if kl32 is None:
        return AMBIGUITY * b
    bad64 = ~torch.isfinite(kl64) | (kl64 >= big)
    bad32 = ~torch.isfinite(kl32) | (kl32 >= big)
    if bool(bad64 | bad32):
        return torch.full_like(b, math.inf)
    return torch.maximum(AMBIGUITY * b, KL_SLACK * torch.abs(kl64 - kl32))


def _bracket_tree(kl_eval, kl_bound, lower0, upper0, j, k, max_trips,
                  kl_eval32=None):
    """Every ``(exp_lower, exp_upper)`` component ``j``'s bisection can
    reach when each decision that float32 cannot resolve may go either way:
    a KL within :func:`_kl_margin` of its threshold, a bracket width within
    1e-5 of its stop.  Depth first, at most ``MAX_OUTCOMES``."""
    b = kl_bound[j]
    yes = torch.ones((), dtype=torch.bool, device=lower0.device)
    as_t = {True: yes, False: ~yes}
    stack = [(lower0[j], upper0[j], ~yes, 0)]
    leaves = []
    while stack and len(leaves) < MAX_OUTCOMES:
        lower, upper, upper_ok, trips = stack.pop()
        if trips >= max_trips:
            leaves.append((torch.exp(torch.where(upper_ok, upper, lower)),
                           torch.exp(upper)))
            continue
        eta = 0.5 * (lower + upper)
        etas = torch.exp(eta).expand(k).contiguous()
        kl = kl_eval(etas)[j]
        kl32 = None if kl_eval32 is None else kl_eval32(etas)[j].to(kl.dtype)
        margin = _kl_margin(kl, kl32, b)
        diff = torch.minimum(torch.exp(upper) - torch.exp(eta),
                             torch.exp(eta) - torch.exp(lower))
        for stop in _choices(diff, 1e-1, 1e-5):
            for good in _choices(torch.abs(b - kl), 0.1 * b, margin):
                for low in _choices(-b, -kl, margin):
                    lo, up, ok, done = _bracket_trip(
                        lower, upper, upper_ok, eta, kl, b, yes,
                        good=as_t[good], go_low=as_t[low],
                        stop_width=as_t[stop])
                    if bool(done):
                        leaves.append((torch.exp(torch.where(ok, up, lo)),
                                       torch.exp(up)))
                    else:
                        stack.append((lo, up, ok, trips + 1))
    return leaves


class ResolvedSearch:
    """Stands in for the reference's ``tr_search`` and ``bracket_search``
    (and wraps the inputs they are prepared from) in its component updater.
    Each component's outcome is the bisection's where the program's stored
    eta is that one; elsewhere the reachable outcome (:func:`_bracket_tree`,
    its margins from a float32 twin of the same KL) nearest the program's.
    With ``exact``, an outcome that reaches the program's eta is that eta
    to the bit (the update then follows the program's own eta)."""

    def __init__(self, program_etas: Optional[torch.Tensor],
                 temperature: float, exact: bool = False):
        self.program_etas = program_etas
        self.temperature = temperature
        self.exact = exact
        self.kl_eval32 = None

    def patches(self, upd, tr):
        """``(name, replacement)`` for the reference's updater module."""
        prepare, precompute = upd.prepare_tr_kl_inputs, \
            upd._tr_whitened_precompute

        def prepare_w(*args):
            inp32 = prepare(*(a.float() for a in args))
            self.kl_eval32 = lambda etas: tr.tr_kl_plain(etas.float(), inp32)
            return prepare(*args)

        def precompute_w(*args):
            out32 = precompute(*(a.float() for a in args))
            self.kl_eval32 = lambda etas: upd._tr_kl_whitened(
                etas.float(), *out32)
            return precompute(*args)

        return [("prepare_tr_kl_inputs", prepare_w),
                ("_tr_whitened_precompute", precompute_w),
                ("tr_search", self.tr_search),
                ("bracket_search", self.bracket)]

    def bracket(self, kl_eval, kl_bound, lower0, upper0, active=None,
                per_component_trips=False):
        m = ref_modules()
        max_trips = m["tr"].MAX_TRIPS
        exp_lo, exp_up, _ = m["tr"].bracket_search(kl_eval, kl_bound, lower0,
                                                   upper0, active)
        if self.program_etas is None:
            return exp_lo, exp_up, 0
        want = self.program_etas.to(exp_lo.dtype)
        stored = _stored_eta(exp_lo, exp_up, self.temperature)
        # -1: the program's update failed, after its search or in the
        # final KL; the updates' comparison judges which
        ok = _near(stored, want) | (want == -1.0)
        if active is not None:
            ok = ok | ~active
        k = lower0.shape[0]
        for j in torch.nonzero(~ok).flatten().tolist():
            leaves = _bracket_tree(kl_eval, kl_bound, lower0, upper0, j, k,
                                   max_trips, self.kl_eval32)
            if leaves:
                gaps = [float(torch.abs(_stored_eta(lo, up, self.temperature)
                                        - want[j])) for lo, up in leaves]
                exp_lo[j], exp_up[j] = leaves[gaps.index(min(gaps))]
        if self.exact:
            snap = _near(_stored_eta(exp_lo, exp_up, self.temperature),
                         want) & (want > 0)
            if active is not None:
                snap = snap & active
            exp_lo = torch.where(snap, want, exp_lo)
            exp_up = torch.where(snap, want, exp_up)
        return exp_lo, exp_up, 0

    def tr_search(self, inp, kl_bound, lower0, upper0, active):
        m = ref_modules()
        return self.bracket(lambda etas: m["tr"].tr_kl_plain(etas, inp),
                            kl_bound, lower0, upper0, active)


def weight_outcomes(model, meta, elr, kl_bound, temperature) -> list:
    """Every new log-weight vector the reference's trust-region weight
    update can reach when each decision whose KL lies within
    ``AMBIGUITY`` of its threshold (or whose bracket width lies within
    1e-5 of its stop) may go either way."""
    m = ref_modules()
    w = m["w"]
    mask = model.mask
    log_weights = torch.where(mask, model.log_weights, w.NEG_INF)
    rewards = torch.where(mask, elr, w.NEG_INF)

    def kl_at(eta):
        return w._tr_weight_kl(eta, log_weights, mask, rewards, temperature)

    f32 = dict(dtype=torch.float32, device=log_weights.device)
    yes = torch.tensor(True, device=log_weights.device)
    as_t = {True: yes, False: ~yes}
    b = torch.as_tensor(kl_bound, dtype=log_weights.dtype,
                        device=log_weights.device)
    stack = [(torch.tensor(-45.0, **f32), torch.tensor(45.0, **f32),
              log_weights, ~yes, 0)]
    leaves = []
    while stack and len(leaves) < MAX_OUTCOMES:
        lower, upper, lw, upper_ok, trips = stack.pop()
        if trips >= w.MAX_TRIPS:
            leaves.append((lower, upper, lw, upper_ok))
            continue
        log_eta = 0.5 * (upper + lower)
        width = torch.abs(torch.exp(upper) - torch.exp(lower))
        new_kl, new_lw = kl_at(torch.exp(log_eta))
        margin = AMBIGUITY * b
        for stop in _choices(width, 1e-1, 1e-5):
            for good_b in _choices(torch.abs(b - new_kl), 0.1 * b, margin):
                for up_b in _choices(-b, -new_kl, margin):
                    good, go_up, adv = as_t[good_b], as_t[up_b], as_t[not stop]
                    lw_n = torch.where(adv, new_lw, lw)
                    lower_n = torch.where(adv & ~good & ~go_up, log_eta,
                                          lower)
                    upper_n = torch.where(adv & ~good & go_up, log_eta, upper)
                    lower_n = torch.where(adv & good, upper_n, lower_n)
                    ok_n = torch.where(adv & ~good, upper_ok | go_up,
                                       upper_ok)
                    if stop or bool(adv & good):
                        leaves.append((lower_n, upper_n, lw_n, ok_n))
                    else:
                        stack.append((lower_n, upper_n, lw_n, ok_n,
                                      trips + 1))
    out = []
    for lower, upper, lw, upper_ok in leaves:
        converged = lower == upper
        _, lw_u = kl_at(torch.exp(upper))
        out.append(torch.where(converged, lw,
                               torch.where(upper_ok, lw_u, log_weights)))
    return out


def ref_component_update(st: StepSettings, model, meta, est,
                         program_etas=None, exact: bool = False):
    """The reference's component stepsizes and update from ``est``; with
    ``program_etas``, the search resolved toward them (to the bit with
    ``exact``).  ``(model, meta)``."""
    m = ref_modules()
    new_stepsizes = m["step"].COMPONENT_STEPSIZE_ADAPTERS[
        st.component_stepsize[0]](meta, st.component_stepsize[1])
    meta = meta.replace(stepsizes=torch.where(model.mask, new_stepsizes,
                                              meta.stepsizes))
    upd = m["upd"]
    patches = (ResolvedSearch(program_etas, st.temperature, exact).patches(
        upd, m["tr"]) if program_etas is not None else [])
    saved = [(name, getattr(upd, name)) for name, _ in patches]
    for name, fn in patches:
        setattr(upd, name, fn)
    try:
        kw = dict(temperature=st.temperature)
        if st.updater == "trust-region":
            kw.update(search=st.search)
        return upd.UPDATERS[st.updater](
            model, meta, est.expected_hessians_neg,
            est.expected_gradients_neg, meta.stepsizes, **kw)
    finally:
        for name, fn in saved:
            setattr(upd, name, fn)


# a component whose float32 update one unit in the last place of its eta
# moves by more than this (relative to the component's norm, as
# :func:`_row_gaps` measures) is one float32 does not determine
STABLE = 1e-4


def component_outcomes(st: StepSettings, pre64: dict, pre32: dict, est64,
                       est32, program_etas):
    """The float64 component update and its float32 twin (the reference's
    own arithmetic in float32 from the same inputs), each with its search
    resolved toward the program's etas, the twin's to the bit where it
    reaches them; the components the twin judges: the active ones whose
    program eta it reaches and whose update the next float32 eta above
    moves by at most ``STABLE``; and ``mismatch``, the active components
    whose program eta neither reaches.  ``(model, meta, judged, mismatch,
    twin_model, twin_meta)``."""
    model, meta = ref_component_update(st, pre64["model"], pre64["meta"],
                                       est64, program_etas)
    etas32 = program_etas.float()
    twin_model, twin_meta = ref_component_update(
        st, pre32["model"], pre32["meta"], est32, etas32, exact=True)
    nudged = torch.where(etas32 > 0, torch.nextafter(
        etas32, torch.full_like(etas32, math.inf)), etas32)
    moved, _ = ref_component_update(st, pre32["model"], pre32["meta"],
                                    est32, nudged, exact=True)
    active = pre64["model"].mask
    unmoved = torch.ones_like(active)
    for name in ("means", "chols"):
        gaps = _row_gaps(getattr(moved, name).double(),
                         getattr(twin_model, name).double(), active)
        unmoved[active] &= gaps <= STABLE
    want = program_etas.to(torch.float64)
    near64 = _near(meta.last_etas, want)
    near32 = _near(twin_meta.last_etas.double(), want)
    mismatch = int((active & ~near64 & ~near32).sum())
    return (model, meta, active & near32 & unmoved, mismatch, twin_model,
            twin_meta)


def ref_weight_update(st: StepSettings, model, meta, wstep, window,
                      program_log_weights=None, twin=None):
    """The reference's weight stepsize and update of ``model`` (whose
    components the reference updated) over ``window``.  With
    ``program_log_weights``, the outcome nearest them among the update's
    and the outcomes of the trust-region bisection when each decision
    within ``AMBIGUITY`` of its threshold may go either way, both also
    for a float32 twin (``twin``: the twin's components and the inputs in
    float32)."""
    m = ref_modules()
    wstep = m["step"].WEIGHT_STEPSIZE_ADAPTERS[st.weight_stepsize[0]](
        wstep, model, meta, st.weight_stepsize[1])
    elr, meta = m["w"].expected_log_ratios(
        model, meta, window.samples, window.valid,
        window.background_log_pdfs, window.target_lnpdfs, st.temperature,
        st.weight_updater[1]["use_self_normalized_importance_weights"])
    natural = m["w"].WEIGHT_UPDATERS[st.weight_updater[0]](
        model, meta, elr, wstep.stepsize, st.temperature)
    if program_log_weights is None:
        return natural
    dtype = natural[0].log_weights.dtype
    want = program_log_weights.to(dtype)

    def gap(lw):
        return float(torch.linalg.vector_norm(torch.where(
            model.mask, lw.to(dtype) - want, 0.0)))

    cands = [natural[0].log_weights]
    if twin is not None:
        cands.append(ref_weight_update(
            st, *twin, program_log_weights=program_log_weights)[0]
            .log_weights)
    if st.weight_updater[0] == "trust-region":
        cands += weight_outcomes(model, meta, elr, wstep.stepsize,
                                 st.temperature)
    best = min(cands, key=gap)
    return m["w"]._apply_new_log_weights(model, meta, best.to(dtype))


def ref_estimate(st: StepSettings, model, window, pack):
    m = ref_modules()
    return m["est"].stein_estimate(
        model, window.samples, window.valid, window.mapping,
        window.background_log_pdfs, window.target_lnpdfs,
        window.target_grads,
        use_self_normalized_importance_weights=st.estimator[
            "use_self_normalized_importance_weights"],
        only_use_own_samples=st.estimator["only_use_own_samples"],
        pack=pack, newest_mask=window.newest_mask)


def reference_target(cfg: dict, device, dtype=torch.float32):
    """The reference's own target, made from the run's seed."""
    m = ref_modules()
    return m["setup"].get_target_lnpdf(cfg["environment_name"],
                                       cfg["environment_config"],
                                       int(cfg["seed"]), device=device,
                                       dtype=dtype)


def reference_step(cfg: dict, snapshot, draws, rows: torch.Tensor, device,
                   tf32: bool) -> dict:
    """The reference's own float32 step from the snapshot and the draws,
    as the captured quantities of :class:`Capture`: the control where
    ``tf32`` (TF32 on), otherwise the reference in the program's
    precision (which the tests judge as they judge the program)."""
    m = ref_modules()
    with precision(tf32), torch.no_grad():
        pre = ref_state(to_device(snapshot, device))
        draws = to_device(draws, device)
        st = StepSettings.from_config(cfg, pre["model"].max_components)
        target = reference_target(cfg, device)
        prop = m["sel"].propose(pre["model"], pre["db"], st.selector,
                                draws.eps, draws.mapping)
        lnpdfs, grads = _eval_rows(target, prop)
        _, win, pack = m["sel"].finalize_fused(
            pre["model"], pre["db"], st.selector, pre["iteration"], prop,
            lnpdfs, grads, draws.rand_slots, draws.accept_u)
        est = ref_estimate(st, pre["model"], win, pack)
        model, meta = ref_component_update(st, pre["model"], pre["meta"],
                                           est)
        model, meta = ref_weight_update(st, model, meta, pre["wstep"], win)
        rows_d = rows.to(device)
        return to_device({
            "draws": draws, "proposal": prop, "lnpdfs": lnpdfs,
            "grads": grads, "window": win,
            "pack": {"model": pack.model_log_densities,
                     "grads": pack.model_grads,
                     "comp": pack.component_log_densities.index_select(
                         1, rows_d)},
            "estimate": est, "model": model, "meta": meta, "rows": rows},
            "cpu")


def _eval_rows(target, prop):
    """The target at the proposal's valid rows, zeros elsewhere."""
    idx = torch.nonzero(prop.valid).flatten()
    lnp, grads = ref_eval_target(target, prop.samples[idx])
    lnpdfs = torch.zeros(prop.samples.shape[0], dtype=lnp.dtype,
                         device=prop.samples.device)
    out = torch.zeros(prop.samples.shape, dtype=grads.dtype,
                      device=prop.samples.device)
    lnpdfs[idx] = lnp
    out[idx] = grads
    return lnpdfs, out


# ----------------------------------------------------------------------
# The numbers
# ----------------------------------------------------------------------
def _rel_max(a, b, mask) -> float:
    """max over ``mask`` of |a - b| / max(|b|, 1)."""
    if not bool(mask.any()):
        return 0.0
    a, b = a.to(b.dtype), b
    d = torch.abs(a - b) / torch.clamp(torch.abs(b), min=1.0)
    return float(torch.max(torch.where(mask, d, 0.0)))


# float32's resolution of a value: 8 units in its last place
F32_RESOLUTION = 2.0 ** -20
# a target row whose float32 gradient lies farther than this from the
# float64 one (as :func:`_row_gaps` measures) is one float32 does not
# determine
DETERMINED = 1e-3


def _row_gaps(a, b, mask, base=None) -> torch.Tensor:
    """Over the rows of ``mask``: ||a - b|| / max(||base||, the median
    row's ||base||, float32's resolution of ||b||), ``base`` = ``b`` by
    default: a row's change smaller than float32 resolves in the value it
    changes is judged at that resolution."""
    base = b if base is None else base
    a = a.to(b.dtype)
    a, b, base = (x.reshape(x.shape[0], -1)[mask] for x in (a, b, base))
    gap = torch.linalg.vector_norm(a - b, dim=1)
    norm = torch.linalg.vector_norm(base, dim=1)
    floor = torch.maximum(
        torch.clamp(torch.median(norm), min=1e-30),
        F32_RESOLUTION * torch.linalg.vector_norm(b, dim=1))
    return gap / torch.maximum(norm, floor)


def _row_gap(a, b, mask, base=None) -> float:
    """The largest of :func:`_row_gaps`."""
    if not bool(mask.any()):
        return 0.0
    return float(torch.max(_row_gaps(a, b, mask, base)))


def judge(cand: dict, cfg: dict, snapshot, device) -> Dict[str, float]:
    """The numbers compared for one captured iteration ``cand`` (the
    program's, or the control's), each as the float64 reference reads it,
    stage by stage from the candidate's inputs to that stage."""
    m = ref_modules()
    with precision(False), torch.no_grad():
        c = to_device(cand, device)
        c64 = to64(c)
        pre = to64(ref_state(to_device(snapshot, device)))
        st = StepSettings.from_config(cfg, pre["model"].max_components)
        target = reference_target(cfg, device, torch.float64)
        out: Dict[str, float] = {}
        # the target at the proposal's valid rows
        prop = m["sel"].Proposal(*c64["proposal"])
        valid = prop.valid
        ref_lnp, ref_grads = _eval_rows(target, prop)
        out["target_lnpdf"] = _rel_max(c["lnpdfs"], ref_lnp, valid)
        # the gradients at the rows whose float32 gradient (the
        # reference's own float32 arithmetic) lies within DETERMINED of
        # the float64 one: elsewhere float32 digits cancel
        _, grads32 = _eval_rows(reference_target(cfg, device),
                                m["sel"].Proposal(*c["proposal"]))
        determined = valid.clone()
        determined[valid] = _row_gaps(grads32, ref_grads,
                                      valid) <= DETERMINED
        out["target_grad"] = _row_gap(c["grads"], ref_grads, determined)
        # the database write, the window, its pack and background
        draws = c64["draws"]
        _, win, pack = m["sel"].finalize_fused(
            pre["model"], pre["db"], st.selector, pre["iteration"], prop,
            c64["lnpdfs"], c64["grads"], draws.rand_slots, draws.accept_u)
        cw = m["win"].SampleWindow(**fields_of(c64["window"]))
        wv = win.valid
        exact = [torch.ne(cw.valid, wv), torch.ne(cw.mapping, win.mapping)]
        both = wv & cw.valid
        for a, b in ((cw.samples, win.samples),
                     (cw.target_lnpdfs, win.target_lnpdfs),
                     (cw.target_grads, win.target_grads)):
            diff = torch.ne(a, b)
            exact.append(both & (diff.reshape(diff.shape[0], -1).any(1)))
        out["window_mismatch"] = float(sum(int(e.sum()) for e in exact)
                                       + abs(int(cw.num_valid)
                                             - int(win.num_valid)))
        out["density_model"] = _rel_max(c["pack"]["model"],
                                        pack.model_log_densities, wv)
        out["density_grad"] = _row_gap(c["pack"]["grads"], pack.model_grads,
                                       wv)
        rows = c["rows"].to(device)
        comp_ref = pack.component_log_densities.index_select(1, rows)
        comp_mask = pre["model"].mask[:, None] & wv[rows][None, :]
        out["density_comp"] = _rel_max(c["pack"]["comp"], comp_ref,
                                       comp_mask)
        out["background"] = _rel_max(cw.background_log_pdfs,
                                     win.background_log_pdfs, wv)
        # the estimate over the candidate's window
        active = pre["model"].mask
        est = ref_estimate(st, pre["model"], cw, pack)
        ce = c64["estimate"]
        for name, i, ref in (("ng_grad", 1, est.expected_gradients_neg),
                             ("ng_hess", 0, est.expected_hessians_neg)):
            gaps = _row_gaps(ce[i], ref, active)
            out[name] = float(torch.max(gaps))
            out[name + "_med"] = float(torch.median(gaps))
        # the search and the component update from the candidate's
        # estimate: the updated means and factors against the float32
        # twin at the program's etas, at the components whose update
        # float32 determines (float32 cannot follow the float64 update at
        # planar_robot_4's etas); the weight update from the reference's
        # own components
        pre32 = ref_state(to_device(snapshot, device))
        prog_model = m["gmm"].GmmState(**fields_of(c64["model"]))
        model, meta, judged, mismatch, twin_model, twin_meta = \
            component_outcomes(st, pre, pre32, ce, c["estimate"],
                               c64["meta"].last_etas)
        out["search_mismatch"] = float(mismatch)
        out["update_judged"] = float(judged.sum())
        out["update_means"] = _row_gap(prog_model.means,
                                       twin_model.means.double(), judged)
        out["update_chols"] = _row_gap(prog_model.chols,
                                       twin_model.chols.double(), judged)
        twin = (twin_model, twin_meta, pre32["wstep"],
                m["win"].SampleWindow(**fields_of(c["window"])))
        model_w, _ = ref_weight_update(
            st, model, meta, pre["wstep"], cw,
            program_log_weights=prog_model.log_weights, twin=twin)
        pm = pre["model"]
        lw_gap = torch.where(active, prog_model.log_weights
                             - model_w.log_weights, 0.0)
        lw_change = torch.where(active, model_w.log_weights
                                - pm.log_weights, 0.0)
        out["update_weights"] = float(
            torch.linalg.vector_norm(lw_gap)
            / torch.clamp(torch.linalg.vector_norm(lw_change), min=1e-30))
    return {k: out[k] for k in NUMBERS}


def verdict(numbers: Dict[str, float], limits: Dict[str, float]
            ) -> Tuple[bool, Dict[str, dict]]:
    """``correct`` and, per number, its value beside its limit.  The
    numbers the cell's limits name are compared (one not finite, or
    missing, fails); the others are reported with the limit null."""
    checks = {name: {"value": value, "limit": limits.get(name)}
              for name, value in numbers.items()}
    ok = True
    for name, limit in limits.items():
        value = numbers.get(name)
        good = value is not None and math.isfinite(value) and value <= limit
        ok = ok and good
        checks.setdefault(name, {"value": None, "limit": limit})
    return ok, checks
