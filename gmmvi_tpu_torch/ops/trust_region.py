"""Batched trust-region KL evaluation and the bracket search over it:
kernel B3.

(JAX counterpart: gmmvi_tpu/ops/pallas_trust_region.py ``_tr_kl_kernel``
and, for the search, gmmvi_tpu/optimization/component_updaters.py
``_bracketing_search_batched``; CUDA source:
gmmvi_tpu_torch/csrc/trust_region.cu)

For every component k at its own stepsize eta_k, with the interpolated
canonical parameters

    P_k = old_prec_k + reward_quad_k / eta_k,
    l_k = old_lin_k + reward_lin_k / eta_k,

computes KL(N(P_k^{-1} l_k, P_k^{-1}) || N(mean_k, Sigma_old_k)):

    0.5 * (kl_const_k + log|P_k| + ||L_k^{-1} O_k^T||_F^2
           + ||O_k (mean_k - P_k^{-1} l_k)||^2)

with L_k = chol(P_k), O_k the old inverse Cholesky factor and kl_const_k =
log|Sigma_old_k| - D.  Components with eta_k <= 0 or a non-positive-definite
P_k get F32_MAX, the rejection signal the bracket search expects.

:func:`tr_search` runs the reference's log-space bisection for every
component's stepsize to its end (:func:`bracket_search` around the KL), in
one launch on the card: one block per component, since a component's
bracket depends on its own KL alone.  :func:`newton_search` is the JAX
package's safeguarded Newton search, a host loop like
:func:`bracket_search`, and :func:`grid_search` its two batched grid
passes (JAX runs both in XLA: they have no kernel).

On a CPU tensor :func:`tr_kl` and :func:`tr_search` run their plain
PyTorch versions; on a CUDA tensor they launch their kernels or raise.
D <= 64.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from gmmvi_tpu_torch.ops import cuda
from gmmvi_tpu_torch.ops.stable import F32_MAX
from gmmvi_tpu_torch.utils.profiling import read

MAX_D = 64
MAX_TRIPS = 1000


class TrKlInputs(NamedTuple):
    """Per-component, eta-independent inputs of :func:`tr_kl`."""

    prec: torch.Tensor           # [K, D, D] old precision
    reward_quad: torch.Tensor    # [K, D, D]
    lin: torch.Tensor            # [K, D] old precision @ old mean
    reward_lin: torch.Tensor     # [K, D]
    old_inv_chols: torch.Tensor  # [K, D, D] lower triangular
    means: torch.Tensor          # [K, D] old means
    kl_const: torch.Tensor       # [K] old log-det of the covariance - D


def prepare_tr_kl_inputs(means, chols, inv_chols, reward_lin, reward_quad
                         ) -> TrKlInputs:
    """Inputs for :func:`tr_kl` from the old components and the rewards,
    made contiguous once here rather than on every bisection trip."""
    d = means.shape[1]
    prec = torch.einsum("kji,kjl->kil", inv_chols, inv_chols)
    lin = torch.einsum("kij,kj->ki", prec, means)
    old_logdet = 2.0 * torch.sum(
        torch.log(torch.abs(torch.diagonal(chols, dim1=-2, dim2=-1))), -1)
    return TrKlInputs(*[t.contiguous() for t in (
        prec, reward_quad, lin, reward_lin, inv_chols, means,
        old_logdet - d)])


def _check(inp: TrKlInputs, **per_component: torch.Tensor):
    """``inp`` and the [K] tensors ``per_component`` (by name; the first
    one's device is the call's)."""
    k, d = inp.means.shape
    shapes = {"prec": (k, d, d), "reward_quad": (k, d, d), "lin": (k, d),
              "reward_lin": (k, d), "old_inv_chols": (k, d, d),
              "means": (k, d), "kl_const": (k,)}
    cuda.check_tensors(
        {**{name: (t, (k,)) for name, t in per_component.items()},
         **{name: (t, shapes[name]) for name, t in zip(inp._fields, inp)}},
        next(iter(per_component.values())).device)
    if d > MAX_D:
        raise NotImplementedError(
            f"the trust-region KL kernel takes D <= {MAX_D} (got {d})")


def tr_kl_plain(etas: torch.Tensor, inp: TrKlInputs) -> torch.Tensor:
    """Plain PyTorch version of B3: KL [K], F32_MAX where infeasible."""
    d = inp.means.shape[1]
    inv_eta = 1.0 / etas
    a = inp.prec + inp.reward_quad * inv_eta[:, None, None]
    y = inp.lin + inp.reward_lin * inv_eta[:, None]
    l, info = torch.linalg.cholesky_ex(a)
    bad = (etas <= 0.0) | (info != 0)
    eye = torch.eye(d, dtype=a.dtype, device=a.device)
    l = torch.where(bad[:, None, None], eye, l)
    logdiag = torch.sum(torch.log(torch.diagonal(l, dim1=-2, dim2=-1)), -1)
    z = torch.linalg.solve_triangular(l, y[:, :, None], upper=False)
    new_mean = torch.linalg.solve_triangular(l.mT, z, upper=True)[:, :, 0]
    half = torch.linalg.solve_triangular(l, inp.old_inv_chols.mT,
                                         upper=False)
    trace = torch.sum(half * half, dim=(-2, -1))
    od = torch.einsum("kij,kj->ki", inp.old_inv_chols, inp.means - new_mean)
    kl = 0.5 * (inp.kl_const + 2.0 * logdiag + trace
                + torch.sum(od * od, dim=-1))
    return torch.where(bad, F32_MAX, kl)


def tr_kl(etas: torch.Tensor, inp: TrKlInputs) -> torch.Tensor:
    """B3: KL(new_k(eta_k) || old_k) for all K components in one call."""
    _check(inp, etas=etas)
    if etas.device.type == "cpu":
        return tr_kl_plain(etas, inp)
    k, d = inp.means.shape
    kl = torch.empty((k,), dtype=torch.float32, device=etas.device)
    lib = cuda.library("trust_region.cu")
    rc = lib.gmmvi_tr_kl(*[t.data_ptr() for t in (etas, *inp)],
                         kl.data_ptr(), k, d,
                         cuda.stream_ptr(etas.device))
    cuda.check(rc, "tr_kl")
    cuda.LAUNCHES["tr_kl"] += 1
    return kl


def bracket_search(kl_eval: Callable, kl_bound, lower0, upper0,
                   active: Optional[torch.Tensor] = None,
                   per_component_trips: bool = False):
    """The reference's log-space bisection for the largest stepsize within
    the KL bound, for all components in lockstep on the host: per trip, one
    ``kl_eval`` of etas [K] -> KLs [K], then masked bracket updates.  A
    component stops when the bracket (in eta space) is narrower than 0.1 or
    |KL - bound| < 0.1 bound; the loop stops when all have, at most 1000
    trips, reading one "all done" flag per trip (the read
    ``tr_search``).  Returns ``(exp(lower),
    exp(upper), trips)``, ``trips`` the loop's trips (an int) or, with
    ``per_component_trips``, the trips each component took before it
    stopped ([K] int32, one more device op per trip): what a loop per
    component would count, since a component's bracket depends on its own
    KL alone."""
    k = lower0.shape[0]
    dev = lower0.device
    lower, upper = lower0, upper0
    upper_ok = torch.zeros((k,), dtype=torch.bool, device=dev)
    done = (torch.zeros((k,), dtype=torch.bool, device=dev)
            if active is None else torch.logical_not(active))
    trips = 0
    each = (torch.zeros((k,), dtype=torch.int32, device=dev)
            if per_component_trips else None)
    while trips < MAX_TRIPS and not read(done.all(), "tr_search"):
        act = torch.logical_not(done)
        if per_component_trips:
            each += act
        eta = 0.5 * (lower + upper)
        kl = kl_eval(torch.exp(eta))
        diff = torch.minimum(torch.exp(upper) - torch.exp(eta),
                             torch.exp(eta) - torch.exp(lower))
        stop_width = diff < 1e-1
        good = torch.abs(kl_bound - kl) < 1e-1 * kl_bound
        go_low = kl_bound > kl
        new_lower = torch.where(
            stop_width, lower,
            torch.where(good, eta, torch.where(go_low, lower, eta)))
        new_upper = torch.where(
            stop_width, upper,
            torch.where(good, eta, torch.where(go_low, eta, upper)))
        new_upper_ok = torch.where(
            ~stop_width & ~good, upper_ok | go_low, upper_ok)
        lower = torch.where(act, new_lower, lower)
        upper = torch.where(act, new_upper, upper)
        upper_ok = torch.where(act, new_upper_ok, upper_ok)
        done = torch.where(act, stop_width | good, done)
        trips += 1
    lower = torch.where(upper_ok, upper, lower)
    return (torch.exp(lower), torch.exp(upper),
            each if per_component_trips else trips)


def newton_search(kl_grad_eval: Callable, kl_bound, lower0, upper0,
                  warm_t, active: Optional[torch.Tensor] = None):
    """The JAX package's safeguarded Newton search (``_newton_search``) for
    all components in lockstep on the host: the contract of
    :func:`bracket_search` (the largest eta with ``|KL - bound| < 0.1
    bound``, else the bracket-collapse fallback, at most 1000 trips), but
    each trip evaluates KL and dKL/d(log eta) at the current point ``t``
    (``kl_grad_eval``: etas [K] -> (KLs, slopes) [K]) and takes a Newton
    step on ``KL(t) - bound``, clipped into the sign bracket (bisection
    where the step leaves it, the slope is not negative or the point is
    infeasible).  ``warm_t`` [K] is the starting log eta (the bracket's
    midpoint where it is not finite).  A component that stops keeps its
    carry, as JAX's ``while_loop`` under ``vmap`` keeps it.  Reads one
    flag per trip (the read ``tr_search``).  Returns
    ``(exp(lower), exp(upper), trips)``."""
    k = lower0.shape[0]
    dev = lower0.device
    t = torch.where(torch.isfinite(warm_t), warm_t, 0.5 * (lower0 + upper0))
    t = torch.clamp(t, min=lower0, max=upper0)
    lower, upper = lower0, upper0
    upper_ok = torch.zeros((k,), dtype=torch.bool, device=dev)
    done = (torch.zeros((k,), dtype=torch.bool, device=dev)
            if active is None else torch.logical_not(active))
    trips = 0
    while trips < MAX_TRIPS and not read(done.all(), "tr_search"):
        act = torch.logical_not(done)
        kl, dkl = kl_grad_eval(torch.exp(t))
        good = torch.abs(kl_bound - kl) < 1e-1 * kl_bound
        go_low = kl_bound > kl
        new_lower = torch.where(good, t, torch.where(go_low, lower, t))
        new_upper = torch.where(good, t, torch.where(go_low, t, upper))
        new_upper_ok = torch.where(good, upper_ok, upper_ok | go_low)
        width = torch.exp(new_upper) - torch.exp(new_lower)
        t_newton = t - (kl - kl_bound) / dkl
        inside = (t_newton > new_lower) & (t_newton < new_upper)
        ok = torch.isfinite(t_newton) & (dkl < 0.0) & inside
        t_next = torch.where(ok, t_newton, 0.5 * (new_lower + new_upper))
        lower = torch.where(act, new_lower, lower)
        upper = torch.where(act, new_upper, upper)
        upper_ok = torch.where(act, new_upper_ok, upper_ok)
        t = torch.where(act, t_next, t)
        done = torch.where(act, good | (width < 1e-1), done)
        trips += 1
    lower = torch.where(upper_ok, upper, lower)
    return torch.exp(lower), torch.exp(upper), trips


def _linspace(start, stop, num: int) -> torch.Tensor:
    """``[num, K]`` points from ``start`` to ``stop`` [K] as ``jnp.linspace``
    makes them (``start (1 - i/(num-1)) + stop i/(num-1)``, the last one
    ``stop`` itself)."""
    div = num - 1
    step = (torch.arange(div, dtype=start.dtype, device=start.device)
            / div)[:, None]
    return torch.cat([start[None] * (1 - step) + stop[None] * step,
                      stop[None]])


def grid_search(kl_eval, kl_bound, lower0, upper0, grid_size: int):
    """The JAX package's two-level grid search (``_tr_grid_search``) for
    every component: KL at ``grid_size`` log etas from ``lower0`` to
    ``upper0``, then at as many between the grid point before the first
    feasible one (KL <= bound; NaN is not) and that point; the first
    feasible point of the second pass.  Returns ``(eta, any feasible in
    the first pass)``; ``kl_eval`` maps etas [K] to KLs [K]."""
    def first_feasible(grid):
        feas = torch.stack([kl_eval(torch.exp(g)) for g in grid]) <= kl_bound
        return feas.any(0), torch.argmax(feas.to(torch.int8), dim=0)

    g1 = _linspace(lower0, upper0, grid_size)
    any1, idx1 = first_feasible(g1)
    lo = g1.gather(0, torch.clamp(idx1 - 1, min=0)[None])[0]
    hi = torch.where(any1, g1.gather(0, idx1[None])[0], upper0)
    g2 = _linspace(lo, hi, grid_size)
    any2, idx2 = first_feasible(g2)
    eta_log = torch.where(any2, g2.gather(0, idx2[None])[0], hi)
    return torch.exp(eta_log), any1


def _check_search(inp: TrKlInputs, kl_bound, lower0, upper0, active):
    k = inp.means.shape[0]
    _check(inp, kl_bound=kl_bound, lower0=lower0, upper0=upper0)
    if (active.shape != (k,) or active.dtype != torch.bool
            or active.device != kl_bound.device
            or not active.is_contiguous()):
        raise ValueError(f"active: a contiguous bool [{k}] on "
                         f"{kl_bound.device} (got {active.dtype} "
                         f"{tuple(active.shape)} on {active.device})")


def tr_search_plain(inp: TrKlInputs, kl_bound, lower0, upper0, active):
    """Plain PyTorch version of the fused search: :func:`bracket_search`
    around :func:`tr_kl_plain`, counting each component's trips."""
    return bracket_search(lambda etas: tr_kl_plain(etas, inp), kl_bound,
                          lower0, upper0, active, per_component_trips=True)


def tr_search(inp: TrKlInputs, kl_bound: torch.Tensor, lower0: torch.Tensor,
              upper0: torch.Tensor, active: torch.Tensor):
    """B3, fused: every active component's bracket search from ``[lower0,
    upper0]`` (log space) against ``kl_bound`` [K], in one launch.  Returns
    ``(exp(lower), exp(upper), trips)`` as :func:`bracket_search` around
    :func:`tr_kl` with ``per_component_trips`` does, to the bit."""
    _check_search(inp, kl_bound, lower0, upper0, active)
    if kl_bound.device.type == "cpu":
        return tr_search_plain(inp, kl_bound, lower0, upper0, active)
    k, d = inp.means.shape
    opts = dict(dtype=torch.float32, device=kl_bound.device)
    exp_lower = torch.empty((k,), **opts)
    exp_upper = torch.empty((k,), **opts)
    trips = torch.empty((k,), dtype=torch.int32, device=kl_bound.device)
    lib = cuda.library("trust_region.cu")
    rc = lib.gmmvi_tr_search(
        *[t.data_ptr() for t in (*inp, kl_bound, lower0, upper0, active,
                                 exp_lower, exp_upper, trips)],
        k, d, cuda.stream_ptr(kl_bound.device))
    cuda.check(rc, "tr_search")
    cuda.LAUNCHES["tr_search"] += 1
    return exp_lower, exp_upper, trips
