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
its plain version elsewhere.  The Stein estimator with standard importance
weights is not ported yet.

MORE fits every component's quadratic surrogate of the log ratios by
importance-weighted ridge regression: the weighted normal equations of all
components come from kernel B8 (``ops/more.py``) in one pass, then one
batched Cholesky solve and unwhitening (``ops/quadratic.py``).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from gmmvi_tpu_torch.models.gmm import (DensityPack, GmmState, density_pack,
                                        log_densities_also_individual)
from gmmvi_tpu_torch.ops import stein as stein_ops
from gmmvi_tpu_torch.ops.more import more_grams
from gmmvi_tpu_torch.ops.quadratic import solve_quadratic_normal_eqs
from gmmvi_tpu_torch.ops.stable import masked_logsumexp


class NgEstimate(NamedTuple):
    expected_hessians_neg: torch.Tensor   # [Kmax, D, D]
    expected_gradients_neg: torch.Tensor  # [Kmax, D]


def _per_component_log_iw(model, comp_log_densities, background, sample_mask,
                          mapping, only_use_own_samples, newest_mask):
    """Raw log importance weights ``log q(x|o) - log bg(x)`` ``[Kmax, N]``
    with their mask.  With ``only_use_own_samples`` each component sees only
    its own newest samples, with log IW = 0."""
    log_iw = comp_log_densities - background[None, :]
    mask = sample_mask[None, :].expand(log_iw.shape)
    if only_use_own_samples:
        own = mapping[None, :] == torch.arange(
            model.max_components, device=mapping.device)[:, None]
        if newest_mask is not None:
            own = own & newest_mask[None, :]
        log_iw = torch.zeros_like(log_iw)
        mask = mask & own
    return log_iw, mask


def _self_normalized(log_iw, mask):
    """Self-normalized weights, normalized twice as in the reference."""
    log_w = log_iw - masked_logsumexp(log_iw, mask=mask, dim=1, keepdim=True)
    w = torch.where(mask, torch.exp(log_w), 0.0)
    return w / torch.clamp(w.sum(dim=1, keepdim=True), min=1e-38)


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
) -> NgEstimate:
    """Stein's-lemma estimate with self-normalized importance weights (the
    weights are normalized twice, as in the reference); the Hessian is
    symmetrized."""
    if not use_self_normalized_importance_weights:
        raise NotImplementedError(
            "the Stein estimator with standard importance weights is not "
            "ported yet")
    if pack is None:
        pack = density_pack(model, samples)
    log_ratio_grads = target_grads - pack.model_grads             # [N, D]

    log_iw, mask = _per_component_log_iw(
        model, pack.component_log_densities, background, sample_mask,
        mapping, only_use_own_samples, newest_mask)
    w = _self_normalized(log_iw, mask)

    grad = w @ log_ratio_grads                                    # [K, D]
    lam = model.inv_chols.mT @ model.inv_chols                    # [K, D, D]
    active = model.mask
    shift = torch.where(active[:, None], model.means, 0.0).sum(0) \
        / torch.clamp(active.sum(), min=1)
    lam_mu = torch.einsum("kde,ke->kd", lam, model.means - shift[None, :])
    # s_mom[k] = sum_n w[k, n] g_n (x_n - c)^T: kernel B7 where the JAX
    # package streams it through its kernel, the plain product elsewhere
    smom = stein_ops.stein_smom_plain
    if stein_ops.supports(model.num_dimensions, samples.shape[0]):
        smom = stein_ops.stein_smom
    s_mom = smom(w, log_ratio_grads, samples - shift[None, :])
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
) -> NgEstimate:
    """Zero-order estimate through a quadratic surrogate of the log ratios
    ``log p(x) - log q(x)`` fitted per component: ``Hneg = quad``,
    ``gneg = quad mu - lin``.  Standard importance weights are the raw
    ``exp(log_iw)``, as in the reference (it overflows past about 88)."""
    if pack is None:
        model_densities, comp_log_densities = log_densities_also_individual(
            model, samples)
    else:
        model_densities = pack.model_log_densities
        comp_log_densities = pack.component_log_densities
    log_ratios = target_lnpdfs - model_densities
    log_iw, mask = _per_component_log_iw(
        model, comp_log_densities, background, sample_mask, mapping,
        only_use_own_samples, newest_mask)
    if use_self_normalized_importance_weights:
        w = _self_normalized(log_iw, mask)
    else:
        w = torch.where(mask, torch.exp(log_iw), 0.0)
    gram, rhs = more_grams(model.inv_chols, model.means, w, log_ratios,
                           samples)
    quad, lin, _ = solve_quadratic_normal_eqs(gram, rhs, l2_regularizers,
                                              model.means, model.inv_chols)
    gneg = torch.einsum("kij,kj->ki", quad, model.means) - lin
    return NgEstimate(quad, gneg)
