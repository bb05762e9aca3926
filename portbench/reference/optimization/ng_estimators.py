"""Natural-gradient estimation: the Stein (first-order) estimator.

(JAX counterpart: gmmvi_tpu/optimization/ng_estimators.py,
``stein_estimate``)

For every component o, the negated expected gradient and Hessian of the log
ratio ``log p(x) - log q(x)`` from one window of samples.  The Hessian is
always taken in moment form from the density pack's mixture gradients:

    H_o = E[g (Lam_o (x - mu_o))^T]
        = (sum_n w g (x - c)^T) Lam_o - (sum_n w g) (Lam_o (mu_o - c))^T,

centred on the active means' centroid ``c`` against float cancellation, so
the ``[Kmax, N, D]`` precision-times-difference array is never formed.  The
moments ``sum_n w g (x - c)^T`` are B7's plain product
(``ops/stein.py``).  With standard importance weights the
estimate is the reference's stable expectation instead: per output element
a signed log-sum-exp over the samples, one component at a time
(:func:`_stein_standard_iw`, plain torch, as in the JAX package).

A diagonal model keeps the diagonals only, in plain torch as in the JAX
package: the Stein Hessian is the elementwise ``E[g * Lam_o (x - mu_o)]``,
unsymmetrized.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from portbench.reference.models.gmm import (DensityPack, GmmState, density_pack,
                                        diag_blocks, slice_components)
from portbench.reference.ops import stein as stein_ops
from portbench.reference.ops.stable import (NEG_INF, masked_logsumexp,
                                            signed_weighted_logsumexp)

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
    log_w = log_iw - masked_logsumexp(log_iw, mask=mask, dim=1,
                                                  keepdim=True)
    w = torch.where(mask, torch.exp(log_w), 0.0)
    return w / torch.clamp(w.sum(dim=1, keepdim=True),
                           min=1e-38)


def _signed_lse_chunked(log_w: torch.Tensor, values_of, n: int,
                        chunk: int) -> torch.Tensor:
    """:func:`signed_weighted_logsumexp` over dim 0 of ``values_of(lo, hi)``
    (rows ``lo:hi`` of the values) weighted by ``log_w[lo:hi]``, in chunks
    of ``chunk`` rows: one pass for the maximum, one for the sum.  A single
    chunk is the one-shot computation."""
    if n <= chunk:
        vals = values_of(0, n)
        return signed_weighted_logsumexp(
            log_w.reshape((n,) + (1,) * (vals.ndim - 1)), vals, dim=0)

    def combined(lo, hi):
        vals = values_of(lo, hi)
        lw = log_w[lo:hi].reshape((hi - lo,) + (1,) * (vals.ndim - 1))
        comb = lw + torch.log(torch.abs(vals))
        return vals, torch.where(torch.isfinite(comb), comb, NEG_INF)

    spans = [(lo, min(lo + chunk, n)) for lo in range(0, n, chunk)]
    cmax = torch.stack([torch.amax(combined(lo, hi)[1],
                                                   dim=0)
                                        for lo, hi in spans]).amax(dim=0)
    cmax_safe = torch.where(torch.isfinite(cmax), cmax, 0.0)
    total = 0.0
    for lo, hi in spans:
        vals, comb = combined(lo, hi)
        total = total + torch.sum(torch.where(
            torch.isfinite(comb),
            torch.sign(vals) * torch.exp(comb - cmax_safe), 0.0), dim=0)
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
    counts = torch.clamp(mask.sum(dim=1, dtype=samples.dtype),
                         min=1.0)
    hess, grad = [], []
    if model.diagonal:
        # the elementwise terms g[n, d] ptd[n, d]
        for k in range(model.max_components):
            lw = torch.where(mask[k], log_iw[k], NEG_INF)[:, None]
            grad.append(signed_weighted_logsumexp(
                lw, log_ratio_grads, dim=0) / counts[k])
            vals = log_ratio_grads * _diag_prec_times_diffs(
                model, samples, k, k + 1)[0]
            hess.append(signed_weighted_logsumexp(lw, vals, dim=0)
                        / counts[k])
        return torch.stack(hess), torch.stack(grad)
    lam = model.inv_chols.mT @ model.inv_chols                   # [K, D, D]
    chunk = max(1, _STANDARD_IW_CHUNK // (d * d))
    for k in range(model.max_components):
        lw = torch.where(mask[k], log_iw[k], NEG_INF)
        grad.append(signed_weighted_logsumexp(
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

    grad = w @ log_ratio_grads                                    # [K, D]
    if model.diagonal:
        n, d = samples.shape
        hess = torch.zeros_like(grad)
        for (r0, r1), (a, b) in diag_blocks(part.max_components, n, d):
            hess[a:b] = hess[a:b] + torch.einsum(
                "kn,nd,knd->kd", w[a:b, r0:r1], log_ratio_grads[r0:r1],
                _diag_prec_times_diffs(part, samples[r0:r1], a, b))
        return NgEstimate(-hess, -grad)
    lam = part.inv_chols.mT @ part.inv_chols                      # [K, D, D]
    # the centroid of every active mean, whichever slots are estimated
    active = model.mask
    shift = torch.where(active[:, None], model.means, 0.0).sum(0) \
        / torch.clamp(active.sum(), min=1)
    lam_mu = torch.einsum("kde,ke->kd", lam, part.means - shift[None, :])
    # s_mom[k] = sum_n w[k, n] g_n (x_n - c)^T
    s_mom = stein_ops.stein_smom_plain(w, log_ratio_grads,
                                       samples - shift[None, :])
    hess = s_mom @ lam - grad[:, :, None] * lam_mu[:, None, :]
    hess = 0.5 * (hess + hess.mT)
    return NgEstimate(-hess, -grad)

