"""K-tiled mixture density passes for large D: kernels B5 (component
densities and the mixture logsumexp) and B6 (the analytic mixture
gradient).

(JAX counterpart: gmmvi_tpu/ops/pallas_density_large.py, ``_density_kernel``
behind ``fused_component_densities_large`` and ``_grad_kernel``, the second
pass of ``fused_density_pack_large``; CUDA source:
gmmvi_tpu_torch/csrc/density_large.cu)

The functions of B2 and B1 (``ops/density.py``) for 1 <= D <= 512 and any
K, over a padded mixture (``means [K, D]``, lower-triangular
``inv_chols [K, D, D]``, ``log_weights [K]`` with -inf for a masked slot,
``log_dets [K]`` = log |L_k|) and samples ``x [N, D]``:

* :func:`densities_large` (B5): ``comp [K, N]`` for every slot and the
  mixture ``model [N]`` over the unmasked ones (-inf where there is none);
* :func:`mixture_logpdf_large` (B5 without ``comp``): ``model [N]`` alone,
  the slots with a -inf log weight skipped outright, for the count-weighted
  background over the distribution ring (``ops/background.py`` at D > 128);
* :func:`density_grads_large` (B6): ``grads [N, D] = -sum_k r_k(x)
  Lambda_k (x - mu_k)`` with ``r_k = exp(comp_k + log_weights_k - model)``
  from B5's outputs;
* :func:`density_pack_large`: B5 then B6, ``(comp, model, grads)``.

B6 takes ``Lambda_k = L_k^{-T} L_k^{-1}`` formed once per call outside the
kernel, as the JAX package forms its precision rows in ``_pack``; here in
float64, rounded once to float32, so the precisions carry no error of a
float32 product that cancellation in ``Lambda_k (x - mu_k)`` would magnify.

On a CPU tensor the wrappers run the plain PyTorch versions below; on a
CUDA tensor they launch the kernel or raise.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

from gmmvi_tpu_torch.ops import cuda
from gmmvi_tpu_torch.ops.density import check_inputs, densities_plain

MAX_D = 512


def densities_large_plain(means, inv_chols, log_weights, log_dets, samples
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of B5: (comp [K, N], model [N])."""
    return densities_plain(means, inv_chols, log_weights, log_dets, samples)


def mixture_logpdf_large_plain(means, inv_chols, log_weights, log_dets,
                               samples) -> torch.Tensor:
    """Plain PyTorch version of B5's mixture output, ``[N]``."""
    return densities_plain(means, inv_chols, log_weights, log_dets,
                           samples)[1]


def density_grads_large_plain(means, inv_chols, log_weights, comp, model,
                              samples) -> torch.Tensor:
    """Plain PyTorch version of B6: ``-sum_k r_k L_k^{-T} L_k^{-1}(x -
    mu_k)``, ``[N, D]``."""
    diffs = samples[None, :, :] - means[:, None, :]                 # [K,N,D]
    y = torch.einsum("kij,knj->kni", inv_chols, diffs)
    ptd = torch.einsum("kji,knj->kni", inv_chols, y)
    mask = (log_weights > -math.inf)[:, None] & (model > -math.inf)[None, :]
    resp = torch.where(mask, torch.exp(comp + log_weights[:, None]
                                       - model[None, :]), 0.0)
    return -torch.einsum("kn,knd->nd", resp, ptd)


def density_pack_large_plain(means, inv_chols, log_weights, log_dets, samples
                             ) -> Tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    """Plain PyTorch version of B5 then B6: (comp, model, grads)."""
    comp, model = densities_large_plain(means, inv_chols, log_weights,
                                        log_dets, samples)
    return comp, model, density_grads_large_plain(
        means, inv_chols, log_weights, comp, model, samples)


def precisions(inv_chols: torch.Tensor) -> torch.Tensor:
    """``Lambda_k = L_k^{-T} L_k^{-1}`` ``[K, D, D]``, formed in float64,
    symmetrized and rounded once to float32 (exactly symmetric)."""
    l64 = inv_chols.to(torch.float64)
    lam = l64.mT @ l64
    return (0.5 * (lam + lam.mT)).to(torch.float32).contiguous()


def _densities(means, inv_chols, log_weights, log_dets, samples,
               skip_masked: bool):
    k, d = means.shape
    n = samples.shape[0]
    opts = dict(dtype=torch.float32, device=samples.device)
    comp = torch.empty((k, n), **opts)
    model = torch.empty((n,), **opts)
    rc = cuda.library("density_large.cu").gmmvi_densities_large(
        *[t.data_ptr() for t in (means, inv_chols, log_weights, log_dets,
                                 samples, comp, model)],
        k, n, d, int(skip_masked), cuda.stream_ptr(samples.device))
    cuda.check(rc, "densities_large")
    cuda.LAUNCHES["densities_large"] += 1
    return comp, model


def densities_large(means, inv_chols, log_weights, log_dets, samples):
    """B5: (comp [K, N], model [N])."""
    check_inputs(means, inv_chols, log_weights, log_dets, samples,
                 what="the large-D density kernel (B5)", max_d=MAX_D)
    if samples.device.type == "cpu":
        return densities_large_plain(means, inv_chols, log_weights, log_dets,
                                     samples)
    return _densities(means, inv_chols, log_weights, log_dets, samples, False)


def mixture_logpdf_large(means, inv_chols, log_weights, log_dets, samples
                         ) -> torch.Tensor:
    """B5's mixture output ``[N]`` alone; rows with a -inf log weight are
    skipped (their ``comp`` rows are neither computed nor returned)."""
    check_inputs(means, inv_chols, log_weights, log_dets, samples,
                 what="the large-D density kernel (B5)", max_d=MAX_D)
    if samples.device.type == "cpu":
        return mixture_logpdf_large_plain(means, inv_chols, log_weights,
                                          log_dets, samples)
    return _densities(means, inv_chols, log_weights, log_dets, samples,
                      True)[1]


def density_grads_large(means, inv_chols, log_weights, comp, model, samples
                        ) -> torch.Tensor:
    """B6: the mixture gradient ``[N, D]`` from B5's ``comp`` and
    ``model``."""
    k, d = means.shape
    n = samples.shape[0]
    cuda.check_tensors({
        "means": (means, (k, d)), "inv_chols": (inv_chols, (k, d, d)),
        "log_weights": (log_weights, (k,)), "comp": (comp, (k, n)),
        "model": (model, (n,)), "samples": (samples, (n, d))},
        samples.device)
    if d > MAX_D:
        raise NotImplementedError(
            f"the large-D gradient kernel (B6): D <= {MAX_D} only (got {d})")
    if samples.device.type == "cpu":
        return density_grads_large_plain(means, inv_chols, log_weights, comp,
                                         model, samples)
    lam = precisions(inv_chols)
    grads = torch.empty((n, d), dtype=torch.float32, device=samples.device)
    rc = cuda.library("density_large.cu").gmmvi_density_grads_large(
        *[t.data_ptr() for t in (lam, means, log_weights, comp, model,
                                 samples, grads)],
        k, n, d, cuda.stream_ptr(samples.device))
    cuda.check(rc, "density_grads_large")
    cuda.LAUNCHES["density_grads_large"] += 1
    return grads


def density_pack_large(means, inv_chols, log_weights, log_dets, samples):
    """B5 then B6: (comp [K, N], model [N], grads [N, D])."""
    comp, model = densities_large(means, inv_chols, log_weights, log_dets,
                                  samples)
    return comp, model, density_grads_large(means, inv_chols, log_weights,
                                            comp, model, samples)
