"""Natural-gradient estimation: the Stein (first-order) estimator.

(JAX counterpart: gmmvi_tpu/optimization/ng_estimators.py,
``stein_estimate`` with self-normalized importance weights)

For every component o, the negated expected gradient and Hessian of the log
ratio ``log p(x) - log q(x)`` from one window of samples.  The Hessian is
always taken in moment form from the density pack's mixture gradients:

    H_o = E[g (Lam_o (x - mu_o))^T]
        = (sum_n w g (x - c)^T) Lam_o - (sum_n w g) (Lam_o (mu_o - c))^T,

centred on the active means' centroid ``c`` against float cancellation, so
the ``[Kmax, N, D]`` precision-times-difference array is never formed.
Standard importance weights and the MORE estimator are not ported yet.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from gmmvi_tpu_torch.models.gmm import DensityPack, GmmState, density_pack
from gmmvi_tpu_torch.ops.stable import masked_logsumexp


class NgEstimate(NamedTuple):
    expected_hessians_neg: torch.Tensor   # [Kmax, D, D]
    expected_gradients_neg: torch.Tensor  # [Kmax, D]


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

    log_iw = pack.component_log_densities - background[None, :]
    mask = sample_mask[None, :].expand(log_iw.shape)
    if only_use_own_samples:
        # each component sees only its own newest samples, with log IW = 0
        own = mapping[None, :] == torch.arange(
            model.max_components, device=mapping.device)[:, None]
        if newest_mask is not None:
            own = own & newest_mask[None, :]
        log_iw = torch.zeros_like(log_iw)
        mask = mask & own

    log_w = log_iw - masked_logsumexp(log_iw, mask=mask, dim=1, keepdim=True)
    w = torch.where(mask, torch.exp(log_w), 0.0)
    w = w / torch.clamp(w.sum(dim=1, keepdim=True), min=1e-38)

    grad = w @ log_ratio_grads                                    # [K, D]
    lam = model.inv_chols.mT @ model.inv_chols                    # [K, D, D]
    active = model.mask
    shift = torch.where(active[:, None], model.means, 0.0).sum(0) \
        / torch.clamp(active.sum(), min=1)
    lam_mu = torch.einsum("kde,ke->kd", lam, model.means - shift[None, :])
    # s_mom[k] = sum_n w[k, n] g_n (x_n - c)^T, one [K, N] x [N, D*D] product
    d = model.num_dimensions
    outer = log_ratio_grads[:, :, None] * (samples - shift[None, :])[:, None]
    s_mom = (w @ outer.reshape(-1, d * d)).reshape(-1, d, d)
    hess = s_mom @ lam - grad[:, :, None] * lam_mu[:, None, :]
    hess = 0.5 * (hess + hess.mT)
    return NgEstimate(-hess, -grad)
