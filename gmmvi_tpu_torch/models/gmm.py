"""Padded Gaussian mixture state and batched mixture operations.

(JAX counterpart: gmmvi_tpu/models/gmm.py)

The mixture lives in fixed-capacity tensors ``[Kmax, ...]``; the active
components occupy the prefix ``[0, num_active)``.  Inactive slots carry
``log_weight = -inf``, zero means and identity Cholesky factors, so batched
linear algebra over the padded axis stays finite.  Inverse Cholesky factors
are cached beside the factors.  ``num_active`` stays a 0-d device tensor:
structural updates select with masks instead of reading it on the host.

A diagonal model (``diagonal=True``) keeps square roots of the variances
``[Kmax, D]`` as its factors (ones in inactive slots) and their reciprocals
as the inverses.  Its densities and gradients are plain torch, as the JAX
package's are (its kernels take full covariances only), with the
``[Kmax, N, D]`` intermediates made a few components at a time.  So are a
full-covariance model's above D = 512, where the JAX package takes its XLA
chain (:func:`xla_densities`); below, the kernels B1/B2 (D <= 128) and
B5/B6 compute them on the card.
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
from gmmvi_tpu_torch.ops import mixture_logpdf as mixture_ops
from gmmvi_tpu_torch.ops.blocked_linalg import tril_inverse
from gmmvi_tpu_torch.ops.stable import NEG_INF, masked_logsumexp
from gmmvi_tpu_torch.utils.profiling import read

LOG_2PI = math.log(2.0 * math.pi)


# elements of one [k, N, D] slab of a diagonal model's intermediates
_DIAG_CHUNK = 1 << 25


@dataclass
class GmmState:
    """Padded GMM parameters.

    log_weights ``[Kmax]`` (-inf inactive), means ``[Kmax, D]``, chols and
    inv_chols ``[Kmax, D, D]`` lower triangular (``[Kmax, D]`` square roots
    of the variances and their reciprocals when ``diagonal``), num_active
    0-d int32."""

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

    @property
    def covs(self) -> torch.Tensor:
        """Covariances ``[Kmax, D, D]`` (variances ``[Kmax, D]`` when
        diagonal)."""
        if self.diagonal:
            return torch.square(self.chols)
        return self.chols @ self.chols.mT

    def replace(self, **kw) -> "GmmState":
        return dataclasses.replace(self, **kw)


def slice_components(state: GmmState, lo: int, hi: int) -> GmmState:
    """Slots ``lo:hi`` as a mixture of their own: its active slots are
    those of ``state`` (active slots are a prefix)."""
    return GmmState(
        log_weights=state.log_weights[lo:hi], means=state.means[lo:hi],
        chols=state.chols[lo:hi], inv_chols=state.inv_chols[lo:hi],
        num_active=torch.clamp(state.num_active - lo, 0, hi - lo),
        diagonal=state.diagonal)


def invert_chol(chols: torch.Tensor, diagonal: bool = False
                ) -> torch.Tensor:
    """Inverses of (batched) lower-triangular factors; reciprocals when
    diagonal."""
    return 1.0 / chols if diagonal else tril_inverse(chols)


def safe_chol_pad(chols: torch.Tensor, mask: torch.Tensor,
                  diagonal: bool = False) -> torch.Tensor:
    """Identity factors (ones when diagonal) in the inactive slots."""
    if diagonal:
        return torch.where(mask[:, None], chols, 1.0)
    eye = torch.eye(chols.shape[-1], dtype=chols.dtype, device=chols.device)
    return torch.where(mask[:, None, None], chols, eye)


def _pad_chols(n: int, d: int, diagonal: bool, **opts) -> torch.Tensor:
    """``n`` inactive slots' factors: identities, or ones when diagonal."""
    if diagonal:
        return torch.ones((n, d), **opts)
    return torch.eye(d, **opts).expand(n, d, d)


def create_gmm_state(weights, means, covs, max_components: Optional[int] = None,
                     diagonal: bool = False, device="cuda",
                     dtype=torch.float32) -> GmmState:
    """Padded :class:`GmmState` from K initial components (numpy arrays or
    tensors) in ``dtype``; weights are normalized and covariances
    Cholesky-factored.  ``covs`` is ``[K, D, D]``, or the variances ``[K,
    D]`` when ``diagonal``."""
    device = resolve_device(device)
    opts = dict(dtype=dtype, device=device)
    weights = torch.as_tensor(weights, **opts)
    means = torch.as_tensor(means, **opts)
    covs = torch.as_tensor(covs, **opts)
    k, d = means.shape
    kmax = max_components if max_components is not None else k
    if kmax < k:
        raise ValueError(f"max_components={kmax} < initial components {k}")
    log_w = torch.log(weights)
    log_w = log_w - torch.logsumexp(log_w, 0)
    chols = torch.sqrt(covs) if diagonal else torch.linalg.cholesky(covs)
    chols_p = torch.cat([chols, _pad_chols(kmax - k, d, diagonal, **opts)])
    return GmmState(
        log_weights=torch.cat([log_w,
                               torch.full((kmax - k,), NEG_INF, **opts)]),
        means=torch.cat([means, torch.zeros((kmax - k, d), **opts)]),
        chols=chols_p,
        inv_chols=invert_chol(chols_p, diagonal),
        num_active=torch.tensor(k, dtype=torch.int32, device=device),
        diagonal=diagonal,
    )


# ---------------------------------------------------------------------------
# Densities
# ---------------------------------------------------------------------------

def chol_log_det(chols: torch.Tensor, diagonal: bool = False
                 ) -> torch.Tensor:
    """log |L| per component."""
    if diagonal:
        return torch.sum(torch.log(chols), -1)
    return torch.sum(torch.log(torch.diagonal(chols, dim1=-2, dim2=-1)), -1)


def whitened_diffs(state: GmmState, samples: torch.Tensor) -> torch.Tensor:
    """``y[k, n] = L_k^{-1}(x_n - mu_k)``, ``[Kmax, N, D]``."""
    diffs = samples[None, :, :] - state.means[:, None, :]
    if state.diagonal:
        return state.inv_chols[:, None, :] * diffs
    return torch.einsum("kij,knj->kni", state.inv_chols, diffs)


def diag_chunks(k: int, n: int, d: int):
    """Component ranges whose ``[k, N, D]`` slabs hold at most
    ``_DIAG_CHUNK`` elements each (one component at least)."""
    step = max(1, _DIAG_CHUNK // max(1, n * d))
    return [(lo, min(lo + step, k)) for lo in range(0, k, step)]


def diag_blocks(k: int, n: int, d: int):
    """``(rows, components)`` ranges of a diagonal model's ``[k, N, D]``
    intermediates, each block at most ``_DIAG_CHUNK`` elements: all rows
    at once where one component's ``[N, D]`` fits (every D up to a few
    hundred), else blocks of ``_DIAG_CHUNK // D`` rows one component at a
    time (329 rows at MNIST's D = 101,770)."""
    step = max(1, _DIAG_CHUNK // max(1, d))
    return [((r0, min(r0 + step, n)), comps) for r0 in range(0, n, step)
            for comps in diag_chunks(k, min(step, n - r0), d)]


def diag_half_maha(means: torch.Tensor, inv_chols: torch.Tensor,
                   samples: torch.Tensor) -> torch.Tensor:
    """``[K, N]`` ``-0.5 ||inv_k (x_n - mu_k)||^2`` of diagonal components
    (``inv_chols`` ``[K, D]``), a block of :func:`diag_blocks` at a time."""
    k, d = means.shape
    out = samples.new_empty((k, samples.shape[0]))
    for (r0, r1), (lo, hi) in diag_blocks(k, samples.shape[0], d):
        y = inv_chols[lo:hi, None, :] * (samples[None, r0:r1, :]
                                         - means[lo:hi, None, :])
        out[lo:hi, r0:r1] = -0.5 * torch.sum(y * y, dim=-1)
    return out


def _log_normalizers(state: GmmState) -> torch.Tensor:
    """``[Kmax]`` -log|L_k| - D/2 log(2 pi)."""
    return -chol_log_det(state.chols, state.diagonal) \
        - 0.5 * state.num_dimensions * LOG_2PI


def component_log_densities_from_whitened(state: GmmState, y: torch.Tensor
                                          ) -> torch.Tensor:
    """``[Kmax, N]`` per-component Gaussian log densities given the
    whitened diffs ``y`` ``[Kmax, N, D]`` (:func:`whitened_diffs`), full or
    diagonal."""
    return -0.5 * torch.sum(y * y, dim=-1) + _log_normalizers(state)[:, None]


def component_log_densities(state: GmmState, samples: torch.Tensor
                            ) -> torch.Tensor:
    """``[Kmax, N]`` log N(x_n; mu_k, Sigma_k); inactive slots give values
    that must be masked."""
    if state.diagonal:
        maha = diag_half_maha(state.means, state.inv_chols, samples)
        return maha + _log_normalizers(state)[:, None]
    return component_log_densities_from_whitened(
        state, whitened_diffs(state, samples))


def _mixture_of(state: GmmState, comp: torch.Tensor) -> torch.Tensor:
    """``[N]`` mixture log density from component log densities."""
    return masked_logsumexp(comp + state.log_weights[:, None],
                            mask=state.mask[:, None], dim=0)


def xla_densities(means, inv_chols, log_weights, log_dets, samples,
                  want_grads: bool = False):
    """The JAX package's XLA chain for full covariances at any D (its route
    where no kernel takes D): ``(comp [K, N], model [N])``, with
    ``want_grads`` also the mixture gradient ``[N, D] = -sum_k r_k L_k^{-T}
    L_k^{-1} (x - mu_k)``, over the rows with a finite log weight.  The
    ``[k, N, D]`` whitened differences are made a few components at a time
    (:func:`diag_chunks`), twice with ``want_grads``, so no more than two
    slabs are alive at once."""
    k, d = means.shape
    n = samples.shape[0]
    chunks = diag_chunks(k, n, d)

    def whitened(lo, hi):
        return torch.einsum("kij,knj->kni", inv_chols[lo:hi],
                            samples[None, :, :] - means[lo:hi, None, :])

    maha = torch.cat([-0.5 * torch.sum(torch.square(whitened(lo, hi)), -1)
                      for lo, hi in chunks])
    comp = maha + (-log_dets - 0.5 * d * LOG_2PI)[:, None]
    mask = (log_weights > NEG_INF)[:, None]
    weighted = comp + log_weights[:, None]
    model = masked_logsumexp(weighted, mask=mask, dim=0)
    if not want_grads:
        return comp, model
    resp = torch.where(mask, torch.exp(weighted - model[None, :]), 0.0)
    grads = torch.zeros_like(samples)
    for lo, hi in chunks:
        ptd = torch.einsum("kji,knj->kni", inv_chols[lo:hi],
                           whitened(lo, hi))
        grads = grads - torch.einsum("kn,knd->nd", resp[lo:hi], ptd)
    return comp, model, grads


def log_density(state: GmmState, samples: torch.Tensor) -> torch.Tensor:
    """``[N]`` mixture log density: kernel B9 on the card (B5's mixture
    output at D > 128); on the CPU its plain version, the arithmetic of
    :func:`component_log_densities` and ``masked_logsumexp``.  Plain torch
    for a diagonal model and above D = 512."""
    if state.diagonal:
        return _mixture_of(state, component_log_densities(state, samples))
    if _xla_d(state):
        return xla_densities(*_kernel_args(state), samples)[1]
    return mixture_ops.mixture_logpdf(*_kernel_args(state), samples)


def density(state: GmmState, samples: torch.Tensor) -> torch.Tensor:
    """``exp`` of the mixture log density."""
    return torch.exp(log_density(state, samples))


def marginal_log_density(state: GmmState, samples: torch.Tensor, dim: int
                         ) -> torch.Tensor:
    """``[N]`` 1-D marginal mixture log density along ``dim``."""
    x = samples[:, dim]
    mu = state.means[:, dim]
    if state.diagonal:
        var = torch.square(state.chols[:, dim])
    else:
        var = torch.sum(torch.square(state.chols[:, dim, :]), dim=-1)
    comp = (-0.5 * torch.square(x[None, :] - mu[:, None]) / var[:, None]
            - 0.5 * torch.log(var)[:, None] - 0.5 * LOG_2PI)
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


def _xla_d(state: GmmState) -> bool:
    """D > 512: no kernel takes it, in the port as in the JAX package; the
    densities take the XLA chain (:func:`xla_densities`)."""
    return state.num_dimensions > density_large_ops.MAX_D


def component_log_densities_fast(state: GmmState, samples: torch.Tensor
                                 ) -> torch.Tensor:
    """:func:`component_log_densities` in one pass through kernel B2 (B5 at
    D > 128) on the card (the sample selector's ESS pass)."""
    return log_densities_also_individual(state, samples)[1]


def log_densities_also_individual(state: GmmState, samples: torch.Tensor):
    """(model log densities ``[N]``, component log densities ``[Kmax, N]``)
    in one pass: kernel B2 (B5 at D > 128) on the card; plain torch for a
    diagonal model and above D = 512."""
    if state.diagonal:
        comp = component_log_densities(state, samples)
        return _mixture_of(state, comp), comp
    fn = (xla_densities if _xla_d(state) else
          density_large_ops.densities_large if _large_d(state)
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
    card (B5 then B6 at D > 128); plain torch for a diagonal model and
    above D = 512."""
    if state.diagonal:
        return _diag_density_pack(state, samples)
    if _xla_d(state):
        comp, model, grads = xla_densities(*_kernel_args(state), samples,
                                           want_grads=True)
        return DensityPack(comp, model, grads)
    fn = (density_large_ops.density_pack_large if _large_d(state)
          else density_ops.density_pack)
    comp, model, grads = fn(*_kernel_args(state), samples)
    return DensityPack(comp, model, grads)


def log_density_and_grad(state: GmmState, samples: torch.Tensor):
    """(model log densities ``[N]``, their gradients ``[N, D]``, component
    log densities ``[Kmax, N]``) from one :func:`density_pack` (the
    reference's ``gmm.py`` ``log_density_and_grad``)."""
    pack = density_pack(state, samples)
    return (pack.model_log_densities, pack.model_grads,
            pack.component_log_densities)


def _diag_density_pack(state: GmmState, samples: torch.Tensor
                       ) -> DensityPack:
    """:func:`density_pack` of a diagonal model, as the JAX package's XLA
    path computes it: responsibilities ``r = exp(log w + comp - model)``
    over the active slots and ``grads = -sum_k r_k inv_k^2 (x - mu_k)``, the
    ``[k, N, D]`` products a block of :func:`diag_blocks` at a time."""
    comp = component_log_densities(state, samples)
    weighted = comp + state.log_weights[:, None]
    model = masked_logsumexp(weighted, mask=state.mask[:, None], dim=0)
    resp = torch.where(state.mask[:, None],
                       torch.exp(weighted - model[None, :]), 0.0)
    n, d = samples.shape
    grads = torch.zeros_like(samples)
    for (r0, r1), (lo, hi) in diag_blocks(state.max_components, n, d):
        inv = state.inv_chols[lo:hi, None, :]
        ptd = inv * (inv * (samples[None, r0:r1, :]
                            - state.means[lo:hi, None, :]))
        grads[r0:r1] = grads[r0:r1] - torch.einsum(
            "kn,knd->nd", resp[lo:hi, r0:r1], ptd)
    return DensityPack(comp, model, grads)


# ---------------------------------------------------------------------------
# Entropies and sampling
# ---------------------------------------------------------------------------

def component_entropies(state: GmmState) -> torch.Tensor:
    """``[Kmax]`` Gaussian entropies 0.5 D (log 2pi + 1) + log|L|."""
    d = state.num_dimensions
    return 0.5 * d * (LOG_2PI + 1.0) + chol_log_det(state.chols,
                                                    state.diagonal)


def average_entropy(state: GmmState) -> torch.Tensor:
    """Weight-averaged component entropy."""
    return torch.sum(state.weights * torch.where(
        state.mask, component_entropies(state), 0.0))


def sample_from_components(state: GmmState, eps: torch.Tensor,
                           samples_per_component: Optional[int] = None
                           ) -> torch.Tensor:
    """``[Kmax, n, D]`` draws mu_k + L_k eps from standard-normal ``eps``
    ``[Kmax, n, D]`` (``n`` is ``samples_per_component`` where given); the
    caller masks draws of inactive slots."""
    if samples_per_component is not None \
            and eps.shape[1] != samples_per_component:
        raise ValueError(f"eps holds {eps.shape[1]} draws per component, "
                         f"not {samples_per_component}")
    if state.diagonal:
        return state.means[:, None, :] + state.chols[:, None, :] * eps
    return state.means[:, None, :] + torch.einsum("kij,knj->kni", state.chols,
                                                  eps)


def sample_from_components_shuffled(
        state: GmmState, samples_per_component: int,
        generator: Optional[torch.Generator] = None,
        eps: Optional[torch.Tensor] = None,
        uniform: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``[Kmax n, D]`` draws, ``n = samples_per_component`` from every slot,
    flattened and shuffled: the active slots' draws first, in the stable
    order of ``uniform`` ``[Kmax n]`` (uniform in [0, 1)), then the
    inactive slots' in slot order.  ``eps`` (standard normal ``[Kmax, n,
    D]``) and ``uniform`` are drawn from ``generator`` unless given."""
    kmax, d = state.max_components, state.num_dimensions
    n = samples_per_component
    if eps is None:
        eps = torch.randn((kmax, n, d), generator=generator,
                          device=state.device)
    if uniform is None:
        uniform = torch.rand((kmax * n,), generator=generator,
                             device=state.device)
    flat = sample_from_components(state, eps).reshape(-1, d)
    valid = torch.repeat_interleave(state.mask, n)
    return flat[torch.argsort(torch.where(valid, uniform, 2.0), stable=True)]


def component_log_density_and_grad(state: GmmState, index: int,
                                   samples: torch.Tensor):
    """(log density ``[N]``, gradient ``[N, D] = -Sigma_i^{-1}(x -
    mu_i)``) of component ``index`` alone, analytically."""
    diffs = samples - state.means[index][None, :]
    inv = state.inv_chols[index]
    if state.diagonal:
        y = inv[None, :] * diffs
        ptd = inv[None, :] * y
    else:
        y = diffs @ inv.mT
        ptd = y @ inv
    d = state.num_dimensions
    ld = -0.5 * torch.sum(y * y, -1) \
        - chol_log_det(state.chols[index], state.diagonal) - 0.5 * d * LOG_2PI
    return ld, -ptd


def sample_categorical(state: GmmState, num_samples: int,
                       generator: Optional[torch.Generator] = None
                       ) -> torch.Tensor:
    """``[num_samples]`` component indices drawn by the active weights."""
    return torch.multinomial(state.weights, num_samples, replacement=True,
                             generator=generator)


def sample(state: GmmState, num_samples: int,
           generator: Optional[torch.Generator] = None,
           comp: Optional[torch.Tensor] = None,
           eps: Optional[torch.Tensor] = None):
    """(samples ``[n, D]``, mapping ``[n]``) drawn from the mixture.

    The mapping is sorted, so draws of one component are contiguous and the
    i-th mapping entry is the component of the i-th sample, as in the JAX
    package.  ``comp`` (unsorted component indices) and ``eps`` (standard
    normal ``[n, D]``) are drawn from ``generator`` unless given, so a test
    can inject the JAX package's draws."""
    if comp is None:
        comp = sample_categorical(state, num_samples, generator)
    if eps is None:
        eps = torch.randn((num_samples, state.num_dimensions),
                          generator=generator, device=state.device)
    mapping = torch.sort(comp.long()).values
    return draw_at(state, mapping, eps), mapping


def draw_at(state: GmmState, mapping: torch.Tensor, eps: torch.Tensor
            ) -> torch.Tensor:
    """``[n, D]`` draws ``mu_m + L_m eps`` of the components ``mapping``
    ``[n]`` from standard-normal ``eps`` ``[n, D]``."""
    if state.diagonal:
        return state.means[mapping] + state.chols[mapping] * eps
    return state.means[mapping] + torch.einsum("nij,nj->ni",
                                               state.chols[mapping], eps)


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
    mask, diag = state.mask, state.diagonal
    means = torch.where(mask[:, None], new_means, state.means)
    chols = safe_chol_pad(new_chols, mask, diag)
    if new_inv_chols is None:
        inv_chols = invert_chol(chols, diag)
    else:
        inv_chols = safe_chol_pad(new_inv_chols, mask, diag)
    return state.replace(means=means, chols=chols, inv_chols=inv_chols)


def add_component(state: GmmState, initial_weight, initial_mean,
                  initial_cov) -> GmmState:
    """Write a component into slot ``num_active`` and renormalize; a no-op
    when the state is full.  ``initial_cov`` is ``[D, D]``, or the
    variances ``[D]`` of a diagonal model.  A host ``initial_weight`` is
    copied to the card, which waits for the card (the read ``add``)."""
    k = state.num_active
    kmax = state.max_components
    has_room = k < kmax
    slot = torch.clamp(k, max=kmax - 1)
    at_slot = (torch.arange(kmax, device=state.device) == slot) & has_room
    if state.diagonal:
        new_chol = torch.sqrt(initial_cov)
    else:
        new_chol = torch.linalg.cholesky_ex(initial_cov)[0]
    def put():
        return torch.as_tensor(initial_weight, dtype=torch.float32,
                               device=state.device)

    initial_weight = (put() if isinstance(initial_weight, torch.Tensor)
                      else read(put, "add"))
    means = torch.where(at_slot[:, None], initial_mean[None, :], state.means)
    sel = at_slot.reshape((kmax,) + (1,) * (state.chols.ndim - 1))
    chols = torch.where(sel, new_chol[None], state.chols)
    log_w = torch.where(at_slot, torch.log(initial_weight),
                        state.log_weights)
    num_active = torch.where(has_room, k + 1, k).to(torch.int32)
    new_mask = torch.arange(kmax, device=state.device) < num_active
    return state.replace(
        log_weights=normalize_log_weights(log_w, new_mask), means=means,
        chols=chols, inv_chols=invert_chol(chols, state.diagonal),
        num_active=num_active)


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
    chols = safe_chol_pad(state.chols[order], new_mask, state.diagonal)
    return state.replace(
        log_weights=normalize_log_weights(state.log_weights[order], new_mask),
        means=torch.where(new_mask[:, None], state.means[order], 0.0),
        chols=chols,
        inv_chols=invert_chol(chols, state.diagonal),
        num_active=num_active,
    )


def repad(state: GmmState, new_max_components: int) -> GmmState:
    """Grow the padded capacity to ``new_max_components`` slots (inactive:
    log weight -inf, zero mean, identity factors); no-op if not larger."""
    kmax, d = state.max_components, state.num_dimensions
    extra = new_max_components - kmax
    if extra <= 0:
        return state
    f32 = dict(dtype=torch.float32, device=state.device)
    pad_chol = _pad_chols(extra, d, state.diagonal, **f32)
    return state.replace(
        log_weights=torch.cat([state.log_weights,
                               torch.full((extra,), NEG_INF, **f32)]),
        means=torch.cat([state.means, torch.zeros((extra, d), **f32)]),
        chols=torch.cat([state.chols, pad_chol]),
        inv_chols=torch.cat([state.inv_chols, pad_chol]),
    )
