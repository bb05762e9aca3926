"""Natural-gradient estimation: the Stein (first-order) and MORE
(zero-order) estimators.

(JAX counterpart: gmmvi_tpu/optimization/ng_estimators.py,
``stein_estimate`` with self-normalized importance weights and
``more_estimate``)

For every component o, the negated expected gradient and Hessian of the log
ratio ``log p(x) - log q(x)`` from one window of samples.  The Hessian is
always taken in moment form from the density pack's mixture gradients:

    H_o = E[g (Lam_o (x - mu_o))^T]
        = (sum_n w g (x - c)^T) Lam_o - (sum_n w g) (Lam_o (mu_o - c))^T,

centred on the active means' centroid ``c`` against float cancellation, so
the ``[Kmax, N, D]`` precision-times-difference array is never formed.  The
moments ``sum_n w g (x - c)^T`` come from kernel B7 (``ops/stein.py``) for
64 < D <= 512 and N >= 512, where the JAX package uses its kernel, and from
its plain version elsewhere: at D <= 64 that forms the outer products
``g (x - c)^T`` as ``[rows, D^2]`` in slabs of the window (one at the
planar robot's) and contracts them with the weights in one fp32 product
``[K, rows] @ [rows, D^2]``.  With standard importance weights the
estimate is the reference's stable expectation instead: per output element
a signed log-sum-exp over the samples, one component at a time
(:func:`_stein_standard_iw`, plain torch, as in the JAX package).

MORE fits every component's quadratic surrogate of the log ratios by
importance-weighted ridge regression: the weighted normal equations of all
components come from kernel B8 (``ops/more.py``) in one pass for D <= 45,
its envelope, and from its plain version, one component at a time, above
(as the JAX package fits them with ``lax.map`` there); then one batched
Cholesky solve and unwhitening (``ops/quadratic.py``).

A diagonal model keeps the diagonals only, in plain torch as in the JAX
package (B7 and B8 are not launched): the Stein Hessian is the elementwise
``E[g * Lam_o (x - mu_o)]``, unsymmetrized, and MORE fits the full
quadratic on elementwise-whitened samples, one component at a time, and
keeps the diagonal of its quadratic term.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from gmmvi_tpu_torch.models.gmm import (DensityPack, GmmState, density_pack,
                                        log_densities_also_individual)
from gmmvi_tpu_torch.models.gmm import diag_blocks, slice_components
from gmmvi_tpu_torch.ops import stein as stein_ops
from gmmvi_tpu_torch.ops.more import MAX_D as MORE_MAX_D
from gmmvi_tpu_torch.ops.more import more_grams, more_grams_plain
from gmmvi_tpu_torch.ops.quadratic import solve_quadratic_normal_eqs
from gmmvi_tpu_torch.ops.stable import NEG_INF
from gmmvi_tpu_torch.parallel import reduce

# elements of one [n, D, D] slab of the standard-IW Hessian's terms
_STANDARD_IW_CHUNK = 1 << 24


class NgEstimate(NamedTuple):
    expected_hessians_neg: torch.Tensor   # [Kmax, D, D] ([Kmax, D] diag)
    expected_gradients_neg: torch.Tensor  # [Kmax, D]


def _diag_prec_times_diffs(model: GmmState, samples: torch.Tensor, lo: int,
                           hi: int) -> torch.Tensor:
    """``[hi - lo, N, D]`` ``inv_k * (inv_k * (x - mu_k))`` of a diagonal
    model's components ``lo:hi`` at ``samples`` ``[N, D]``."""
    inv = model.inv_chols[lo:hi, None, :]
    return inv * (inv * (samples[None, :, :] - model.means[lo:hi, None, :]))


def _per_component_log_iw(comp_log_densities, background, sample_mask,
                          mapping, only_use_own_samples, newest_mask,
                          first: int = 0):
    """Raw log importance weights ``log q(x|o) - log bg(x)`` ``[K, N]``
    (slots ``first`` on) with their mask.  With ``only_use_own_samples``
    each component sees only its own newest samples, with log IW = 0."""
    log_iw = comp_log_densities - background[None, :]
    mask = sample_mask[None, :].expand(log_iw.shape)
    if only_use_own_samples:
        own = mapping[None, :] == torch.arange(
            first, first + log_iw.shape[0], device=mapping.device)[:, None]
        if newest_mask is not None:
            own = own & newest_mask[None, :]
        log_iw = torch.zeros_like(log_iw)
        mask = mask & own
    return log_iw, mask


def _self_normalized(log_iw, mask):
    """Self-normalized weights, normalized twice as in the reference (the
    normalizers over every rank's samples)."""
    log_w = log_iw - reduce.data_masked_logsumexp(log_iw, mask=mask, dim=1,
                                                  keepdim=True)
    w = torch.where(mask, torch.exp(log_w), 0.0)
    return w / torch.clamp(reduce.data_sum(w.sum(dim=1, keepdim=True)),
                           min=1e-38)


def _signed_lse_chunked(log_w: torch.Tensor, values_of, n: int,
                        chunk: int) -> torch.Tensor:
    """:func:`signed_weighted_logsumexp` over dim 0 of ``values_of(lo, hi)``
    (rows ``lo:hi`` of the values) weighted by ``log_w[lo:hi]``, in chunks
    of ``chunk`` rows: one pass for the maximum, one for the sum.  A single
    chunk is the one-shot computation."""
    if n <= chunk:
        vals = values_of(0, n)
        return reduce.data_signed_weighted_logsumexp(
            log_w.reshape((n,) + (1,) * (vals.ndim - 1)), vals, dim=0)

    def combined(lo, hi):
        vals = values_of(lo, hi)
        lw = log_w[lo:hi].reshape((hi - lo,) + (1,) * (vals.ndim - 1))
        comb = lw + torch.log(torch.abs(vals))
        return vals, torch.where(torch.isfinite(comb), comb, NEG_INF)

    spans = [(lo, min(lo + chunk, n)) for lo in range(0, n, chunk)]
    cmax = reduce.data_max(torch.stack([torch.amax(combined(lo, hi)[1],
                                                   dim=0)
                                        for lo, hi in spans]).amax(dim=0))
    cmax_safe = torch.where(torch.isfinite(cmax), cmax, 0.0)
    total = 0.0
    for lo, hi in spans:
        vals, comb = combined(lo, hi)
        total = total + torch.sum(torch.where(
            torch.isfinite(comb),
            torch.sign(vals) * torch.exp(comb - cmax_safe), 0.0), dim=0)
    total = reduce.data_sum(total)
    return torch.sign(total) * torch.exp(torch.log(torch.abs(total))
                                         + cmax_safe)


def _stein_standard_iw(model: GmmState, log_iw, mask, log_ratio_grads,
                       samples):
    """The Stein moments with standard importance weights, as the
    reference's stable expectation: per output element a signed
    log-sum-exp of ``log_iw + log|value|`` over the samples, divided by the
    count of samples the component sees.  The Hessian's terms are
    ``g[n, d] ptd[n, e]`` with ``ptd = Lam_o (x - mu_o)``, unsymmetrized;
    they are made one component at a time, in chunks of samples, so the
    ``[Kmax, N, D]`` and ``[N, D, D]`` arrays are never formed whole."""
    n, d = samples.shape
    counts = torch.clamp(reduce.data_sum(mask.sum(dim=1, dtype=samples.dtype)),
                         min=1.0)
    hess, grad = [], []
    if model.diagonal:
        # the elementwise terms g[n, d] ptd[n, d]
        for k in range(model.max_components):
            lw = torch.where(mask[k], log_iw[k], NEG_INF)[:, None]
            grad.append(reduce.data_signed_weighted_logsumexp(
                lw, log_ratio_grads, dim=0) / counts[k])
            vals = log_ratio_grads * _diag_prec_times_diffs(
                model, samples, k, k + 1)[0]
            hess.append(reduce.data_signed_weighted_logsumexp(lw, vals, dim=0)
                        / counts[k])
        return torch.stack(hess), torch.stack(grad)
    lam = model.inv_chols.mT @ model.inv_chols                   # [K, D, D]
    chunk = max(1, _STANDARD_IW_CHUNK // (d * d))
    for k in range(model.max_components):
        lw = torch.where(mask[k], log_iw[k], NEG_INF)
        grad.append(reduce.data_signed_weighted_logsumexp(
            lw[:, None], log_ratio_grads, dim=0) / counts[k])

        def terms(lo, hi, k=k):
            ptd = (samples[lo:hi] - model.means[k]) @ lam[k].mT   # [n, D]
            return log_ratio_grads[lo:hi, :, None] * ptd[:, None, :]

        hess.append(_signed_lse_chunked(lw, terms, n, chunk) / counts[k])
    return torch.stack(hess), torch.stack(grad)


def stein_estimate(
    model: GmmState,
    samples: torch.Tensor,         # [N, D]
    sample_mask: torch.Tensor,     # [N] bool
    mapping: torch.Tensor,         # [N] generating slot
    background: torch.Tensor,      # [N] log density of the sampling mixture
    target_lnpdfs: torch.Tensor,   # [N] (unused by the first-order form)
    target_grads: torch.Tensor,    # [N, D]
    use_self_normalized_importance_weights: bool = True,
    only_use_own_samples: bool = False,
    pack: Optional[DensityPack] = None,
    newest_mask: Optional[torch.Tensor] = None,
    comp_slice: Optional[Tuple[int, int]] = None,
) -> NgEstimate:
    """Stein's-lemma estimate.  With self-normalized importance weights
    (normalized twice, as in the reference) the Hessian is taken in moment
    form and symmetrized (a diagonal model's: its diagonal, directly); with
    standard ones it is the reference's stable expectation, unsymmetrized
    (:func:`_stein_standard_iw`).  On a mesh the samples are this rank's
    rows and every sum over them is reduced over ``data``; ``comp_slice``
    ``(lo, hi)`` estimates slots ``lo:hi`` only (a ``comp`` rank's)."""
    if pack is None:
        pack = density_pack(model, samples)
    log_ratio_grads = target_grads - pack.model_grads             # [N, D]
    lo, hi = comp_slice or (0, model.max_components)
    part = model if comp_slice is None else slice_components(model, lo, hi)

    log_iw, mask = _per_component_log_iw(
        pack.component_log_densities[lo:hi], background, sample_mask,
        mapping, only_use_own_samples, newest_mask, first=lo)
    if not use_self_normalized_importance_weights:
        hess, grad = _stein_standard_iw(part, log_iw, mask,
                                        log_ratio_grads, samples)
        return NgEstimate(-hess, -grad)
    w = _self_normalized(log_iw, mask)

    grad = reduce.data_sum(w @ log_ratio_grads)                   # [K, D]
    if model.diagonal:
        n, d = samples.shape
        hess = torch.zeros_like(grad)
        for (r0, r1), (a, b) in diag_blocks(part.max_components, n, d):
            hess[a:b] = hess[a:b] + torch.einsum(
                "kn,nd,knd->kd", w[a:b, r0:r1], log_ratio_grads[r0:r1],
                _diag_prec_times_diffs(part, samples[r0:r1], a, b))
        return NgEstimate(-reduce.data_sum(hess), -grad)
    lam = part.inv_chols.mT @ part.inv_chols                      # [K, D, D]
    # the centroid of every active mean, whichever slots are estimated
    active = model.mask
    shift = torch.where(active[:, None], model.means, 0.0).sum(0) \
        / torch.clamp(active.sum(), min=1)
    lam_mu = torch.einsum("kde,ke->kd", lam, part.means - shift[None, :])
    # s_mom[k] = sum_n w[k, n] g_n (x_n - c)^T: kernel B7 where the JAX
    # package streams it through its kernel, the plain product elsewhere
    smom = stein_ops.stein_smom_plain
    if stein_ops.supports(model.num_dimensions, samples.shape[0]):
        smom = stein_ops.stein_smom
    s_mom = reduce.data_sum(smom(w, log_ratio_grads,
                                 samples - shift[None, :]))
    hess = s_mom @ lam - grad[:, :, None] * lam_mu[:, None, :]
    hess = 0.5 * (hess + hess.mT)
    return NgEstimate(-hess, -grad)


def more_estimate(
    model: GmmState,
    samples: torch.Tensor,         # [N, D]
    sample_mask: torch.Tensor,     # [N] bool
    mapping: torch.Tensor,         # [N] generating slot
    background: torch.Tensor,      # [N] log density of the sampling mixture
    target_lnpdfs: torch.Tensor,   # [N]
    l2_regularizers: torch.Tensor,  # [Kmax]
    use_self_normalized_importance_weights: bool = True,
    only_use_own_samples: bool = False,
    pack: Optional[DensityPack] = None,
    newest_mask: Optional[torch.Tensor] = None,
    comp_slice: Optional[Tuple[int, int]] = None,
) -> NgEstimate:
    """Zero-order estimate through a quadratic surrogate of the log ratios
    ``log p(x) - log q(x)`` fitted per component: ``Hneg = quad``,
    ``gneg = quad mu - lin`` (diagonal model: ``Hneg = diag(quad)``,
    ``gneg = Hneg * mu - lin``).  Standard importance weights are the raw
    ``exp(log_iw)``, as in the reference (it overflows past about 88).  On
    a mesh the normal equations of this rank's rows are reduced over
    ``data``; ``comp_slice`` ``(lo, hi)`` fits slots ``lo:hi`` only, whose
    ``l2_regularizers`` are given."""
    if pack is None:
        model_densities, comp_log_densities = log_densities_also_individual(
            model, samples)
    else:
        model_densities = pack.model_log_densities
        comp_log_densities = pack.component_log_densities
    log_ratios = target_lnpdfs - model_densities
    lo, hi = comp_slice or (0, model.max_components)
    if comp_slice is not None:
        model = slice_components(model, lo, hi)
    log_iw, mask = _per_component_log_iw(
        comp_log_densities[lo:hi], background, sample_mask, mapping,
        only_use_own_samples, newest_mask, first=lo)
    if use_self_normalized_importance_weights:
        w = _self_normalized(log_iw, mask)
    else:
        w = torch.where(mask, torch.exp(log_iw), 0.0)
    if model.diagonal:
        gram, rhs = more_grams_plain(model.inv_chols, model.means, w,
                                     log_ratios, samples)
        quad, lin, _ = solve_quadratic_normal_eqs(
            reduce.data_sum(gram), reduce.data_sum(rhs), l2_regularizers,
            model.means, model.inv_chols, diagonal=True)
        hneg = torch.diagonal(quad, dim1=-2, dim2=-1)
        return NgEstimate(hneg, hneg * model.means - lin)
    # kernel B8 within its envelope (D <= 45); above it the plain version,
    # one component at a time, as the JAX package's lax.map fits it
    grams = (more_grams if model.num_dimensions <= MORE_MAX_D
             else more_grams_plain)
    gram, rhs = grams(model.inv_chols, model.means, w, log_ratios, samples)
    quad, lin, _ = solve_quadratic_normal_eqs(
        reduce.data_sum(gram), reduce.data_sum(rhs), l2_regularizers,
        model.means, model.inv_chols)
    gneg = torch.einsum("kij,kj->ki", quad, model.means) - lin
    return NgEstimate(quad, gneg)
