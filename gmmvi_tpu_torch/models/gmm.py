"""Padded Gaussian mixture state and batched mixture operations.

(JAX counterpart: gmmvi_tpu/models/gmm.py, full-covariance parts)

The mixture lives in fixed-capacity tensors ``[Kmax, ...]``; the active
components occupy the prefix ``[0, num_active)``.  Inactive slots carry
``log_weight = -inf``, zero means and identity Cholesky factors, so batched
linear algebra over the padded axis stays finite.  Inverse Cholesky factors
are cached beside the factors.  ``num_active`` stays a 0-d device tensor:
structural updates select with masks instead of reading it on the host.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Optional

import torch

from gmmvi_tpu_torch.device import resolve_device
from gmmvi_tpu_torch.ops import density as density_ops
from gmmvi_tpu_torch.ops import density_large as density_large_ops
from gmmvi_tpu_torch.ops.blocked_linalg import tril_inverse
from gmmvi_tpu_torch.ops.stable import NEG_INF, masked_logsumexp

LOG_2PI = math.log(2.0 * math.pi)


def _full_cov_only(diagonal: bool) -> None:
    if diagonal:
        raise NotImplementedError(
            "diagonal covariances are not ported yet (full covariances only)")


@dataclass
class GmmState:
    """Padded GMM parameters.

    log_weights ``[Kmax]`` (-inf inactive), means ``[Kmax, D]``, chols and
    inv_chols ``[Kmax, D, D]`` lower triangular, num_active 0-d int32."""

    log_weights: torch.Tensor
    means: torch.Tensor
    chols: torch.Tensor
    inv_chols: torch.Tensor
    num_active: torch.Tensor
    diagonal: bool = False

    @property
    def max_components(self) -> int:
        return self.log_weights.shape[0]

    @property
    def num_dimensions(self) -> int:
        return self.means.shape[1]

    @property
    def device(self) -> torch.device:
        return self.means.device

    @property
    def mask(self) -> torch.Tensor:
        """``[Kmax]`` bool mask of the active slots."""
        return torch.arange(self.max_components,
                            device=self.device) < self.num_active

    @property
    def weights(self) -> torch.Tensor:
        return torch.where(self.mask, torch.exp(self.log_weights), 0.0)

    def replace(self, **kw) -> "GmmState":
        return dataclasses.replace(self, **kw)


def safe_chol_pad(chols: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Identity factors in the inactive slots."""
    eye = torch.eye(chols.shape[-1], dtype=chols.dtype, device=chols.device)
    return torch.where(mask[:, None, None], chols, eye)


def create_gmm_state(weights, means, covs, max_components: Optional[int] = None,
                     diagonal: bool = False, device="cuda") -> GmmState:
    """Padded :class:`GmmState` from K initial components (numpy arrays or
    tensors); weights are normalized and covariances Cholesky-factored."""
    _full_cov_only(diagonal)
    device = resolve_device(device)
    f32 = dict(dtype=torch.float32, device=device)
    weights = torch.as_tensor(weights, **f32)
    means = torch.as_tensor(means, **f32)
    covs = torch.as_tensor(covs, **f32)
    k, d = means.shape
    kmax = max_components if max_components is not None else k
    if kmax < k:
        raise ValueError(f"max_components={kmax} < initial components {k}")
    log_w = torch.log(weights)
    log_w = log_w - torch.logsumexp(log_w, 0)
    chols = torch.linalg.cholesky(covs)
    pad_chol = torch.eye(d, **f32).expand(kmax - k, d, d)
    chols_p = torch.cat([chols, pad_chol])
    return GmmState(
        log_weights=torch.cat([log_w, torch.full((kmax - k,), NEG_INF, **f32)]),
        means=torch.cat([means, torch.zeros((kmax - k, d), **f32)]),
        chols=chols_p,
        inv_chols=tril_inverse(chols_p),
        num_active=torch.tensor(k, dtype=torch.int32, device=device),
    )


# ---------------------------------------------------------------------------
# Densities
# ---------------------------------------------------------------------------

def chol_log_det(chols: torch.Tensor) -> torch.Tensor:
    """log |L| per component."""
    return torch.sum(torch.log(torch.diagonal(chols, dim1=-2, dim2=-1)), -1)


def whitened_diffs(state: GmmState, samples: torch.Tensor) -> torch.Tensor:
    """``y[k, n] = L_k^{-1}(x_n - mu_k)``, ``[Kmax, N, D]``."""
    diffs = samples[None, :, :] - state.means[:, None, :]
    return torch.einsum("kij,knj->kni", state.inv_chols, diffs)


def component_log_densities(state: GmmState, samples: torch.Tensor
                            ) -> torch.Tensor:
    """``[Kmax, N]`` log N(x_n; mu_k, Sigma_k); inactive slots give values
    that must be masked."""
    y = whitened_diffs(state, samples)
    const = -chol_log_det(state.chols) - 0.5 * state.num_dimensions * LOG_2PI
    return -0.5 * torch.sum(y * y, dim=-1) + const[:, None]


def log_density(state: GmmState, samples: torch.Tensor) -> torch.Tensor:
    """``[N]`` mixture log density."""
    comp = component_log_densities(state, samples)
    return masked_logsumexp(comp + state.log_weights[:, None],
                            mask=state.mask[:, None], dim=0)


def _kernel_args(state: GmmState):
    logdets = torch.sum(torch.log(torch.abs(torch.diagonal(
        state.chols, dim1=-2, dim2=-1))), -1)
    logw = torch.where(state.mask, state.log_weights, NEG_INF)
    return state.means, state.inv_chols, logw, logdets


def _large_d(state: GmmState) -> bool:
    """D > 128 goes to the K-tiled kernels B5/B6, D <= 128 to B1/B2.  The
    JAX package also sends small D with Kmax * D > 2048 to its K-tiled
    kernels (the VMEM-resident ones cap K); the port's B1/B2 stage the
    factors in chunks and take any K, so they keep that case: a difference
    of route, not of value."""
    return state.num_dimensions > density_ops.MAX_D


def component_log_densities_fast(state: GmmState, samples: torch.Tensor
                                 ) -> torch.Tensor:
    """:func:`component_log_densities` in one pass through kernel B2 (B5 at
    D > 128) on the card (the sample selector's ESS pass)."""
    return log_densities_also_individual(state, samples)[1]


def log_densities_also_individual(state: GmmState, samples: torch.Tensor):
    """(model log densities ``[N]``, component log densities ``[Kmax, N]``)
    in one pass: kernel B2 (B5 at D > 128) on the card."""
    _full_cov_only(state.diagonal)
    fn = (density_large_ops.densities_large if _large_d(state)
          else density_ops.densities)
    comp, model = fn(*_kernel_args(state), samples)
    return model, comp


@dataclass
class DensityPack:
    """Density intermediates of one pass over samples.  The port never
    builds the ``[Kmax, N, D]`` precision-times-diff array: the Stein
    estimator uses its moment form."""

    component_log_densities: torch.Tensor  # [Kmax, N]
    model_log_densities: torch.Tensor      # [N]
    model_grads: torch.Tensor              # [N, D]


def density_pack(state: GmmState, samples: torch.Tensor) -> DensityPack:
    """Component densities, mixture density and analytic mixture gradient
    ``-sum_k r_k(x) Sigma_k^{-1}(x - mu_k)`` in one pass: kernel B1 on the
    card (B5 then B6 at D > 128)."""
    _full_cov_only(state.diagonal)
    fn = (density_large_ops.density_pack_large if _large_d(state)
          else density_ops.density_pack)
    comp, model, grads = fn(*_kernel_args(state), samples)
    return DensityPack(comp, model, grads)


# ---------------------------------------------------------------------------
# Entropies and sampling
# ---------------------------------------------------------------------------

def component_entropies(state: GmmState) -> torch.Tensor:
    """``[Kmax]`` Gaussian entropies 0.5 D (log 2pi + 1) + log|L|."""
    d = state.num_dimensions
    return 0.5 * d * (LOG_2PI + 1.0) + chol_log_det(state.chols)


def average_entropy(state: GmmState) -> torch.Tensor:
    """Weight-averaged component entropy."""
    return torch.sum(state.weights * torch.where(
        state.mask, component_entropies(state), 0.0))


def sample_from_components(state: GmmState, eps: torch.Tensor
                           ) -> torch.Tensor:
    """``[Kmax, n, D]`` draws mu_k + L_k eps from standard-normal ``eps``
    ``[Kmax, n, D]``; the caller masks draws of inactive slots."""
    return state.means[:, None, :] + torch.einsum("kij,knj->kni", state.chols,
                                                  eps)


# ---------------------------------------------------------------------------
# Structural updates (all statically shaped)
# ---------------------------------------------------------------------------

def normalize_log_weights(log_weights: torch.Tensor, mask: torch.Tensor
                          ) -> torch.Tensor:
    lw = torch.where(mask, log_weights, NEG_INF)
    return torch.where(mask, lw - masked_logsumexp(lw, mask=mask, dim=0),
                       NEG_INF)


def replace_weights(state: GmmState, new_log_weights: torch.Tensor
                    ) -> GmmState:
    """Overwrite and re-normalize the active log weights."""
    return state.replace(log_weights=normalize_log_weights(new_log_weights,
                                                           state.mask))


def replace_components(state: GmmState, new_means, new_chols,
                       new_inv_chols=None) -> GmmState:
    """Replace the active components' parameters; inactive slots keep
    identity factors.  ``new_inv_chols`` skips the re-inversion."""
    mask = state.mask
    means = torch.where(mask[:, None], new_means, state.means)
    chols = safe_chol_pad(new_chols, mask)
    if new_inv_chols is None:
        inv_chols = tril_inverse(chols)
    else:
        inv_chols = safe_chol_pad(new_inv_chols, mask)
    return state.replace(means=means, chols=chols, inv_chols=inv_chols)


def add_component(state: GmmState, initial_weight, initial_mean,
                  initial_cov) -> GmmState:
    """Write a component into slot ``num_active`` and renormalize; a no-op
    when the state is full."""
    _full_cov_only(state.diagonal)
    k = state.num_active
    kmax = state.max_components
    has_room = k < kmax
    slot = torch.clamp(k, max=kmax - 1)
    at_slot = (torch.arange(kmax, device=state.device) == slot) & has_room
    new_chol = torch.linalg.cholesky_ex(initial_cov)[0]
    initial_weight = torch.as_tensor(initial_weight, dtype=torch.float32,
                                     device=state.device)
    means = torch.where(at_slot[:, None], initial_mean[None, :], state.means)
    chols = torch.where(at_slot[:, None, None], new_chol[None], state.chols)
    log_w = torch.where(at_slot, torch.log(initial_weight),
                        state.log_weights)
    num_active = torch.where(has_room, k + 1, k).to(torch.int32)
    new_mask = torch.arange(kmax, device=state.device) < num_active
    return state.replace(
        log_weights=normalize_log_weights(log_w, new_mask), means=means,
        chols=chols, inv_chols=tril_inverse(chols), num_active=num_active)


def compaction_order(keep: torch.Tensor) -> torch.Tensor:
    """Stable permutation placing kept slots first."""
    return torch.argsort(torch.logical_not(keep).to(torch.int8), stable=True)


def remove_components(state: GmmState, keep: torch.Tensor) -> GmmState:
    """Remove the active components where ``keep`` is False (compacting
    gather) and renormalize."""
    keep = keep & state.mask
    order = compaction_order(keep)
    num_active = torch.sum(keep).to(torch.int32)
    new_mask = torch.arange(state.max_components,
                            device=state.device) < num_active
    chols = safe_chol_pad(state.chols[order], new_mask)
    return state.replace(
        log_weights=normalize_log_weights(state.log_weights[order], new_mask),
        means=torch.where(new_mask[:, None], state.means[order], 0.0),
        chols=chols,
        inv_chols=tril_inverse(chols),
        num_active=num_active,
    )
