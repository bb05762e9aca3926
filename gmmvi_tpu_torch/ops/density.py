"""Fused mixture density passes: kernels B1 (density pack) and B2
(densities only).

(JAX counterpart: gmmvi_tpu/ops/pallas_density.py, ``_density_pack_kernel``
and ``_densities_kernel``; CUDA source: gmmvi_tpu_torch/csrc/density.cu)

Both compute, for a padded mixture of K full-covariance Gaussians given by
``means [K, D]``, lower-triangular inverse Cholesky factors
``inv_chols [K, D, D]``, ``log_weights [K]`` (-inf marks a masked slot) and
``log_dets [K]`` (log |L_k|), over samples ``x [N, D]``:

* ``comp [K, N]``: log N(x_n; mu_k, Sigma_k) for every slot, masked or not;
* ``model [N]``: logsumexp_k(comp + log_weights) over the unmasked slots
  (-inf where every slot is masked, as ``masked_logsumexp`` gives);
* B1 only, ``grads [N, D]``: the analytic mixture gradient
  ``-sum_k r_k(x) Lambda_k (x - mu_k)`` with responsibilities
  ``r_k = exp(comp_k + log_weights_k - model)``.

On a CPU tensor the wrappers run the plain PyTorch version below; on a CUDA
tensor they launch the kernel or raise.  D <= 128; larger D goes to the
K-tiled kernels B5/B6 (``ops/density_large.py``), by the dispatch in
``models/gmm.py``.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

from gmmvi_tpu_torch.ops import cuda
from gmmvi_tpu_torch.ops.stable import masked_logsumexp

LOG_2PI = math.log(2.0 * math.pi)
MAX_D = 128


def check_inputs(means, inv_chols, log_weights, log_dets, samples,
                 what: str = "the density kernels B1/B2 (the K-tiled B5/B6 "
                             "take larger D)", max_d: int = MAX_D):
    """Shapes, float32, one device, row-major, and D <= ``max_d``; shared
    with the background kernel (B4) and the large-D kernels (B5/B6)."""
    k, d = means.shape
    n = samples.shape[0]
    cuda.check_tensors({
        "means": (means, (k, d)), "inv_chols": (inv_chols, (k, d, d)),
        "log_weights": (log_weights, (k,)), "log_dets": (log_dets, (k,)),
        "samples": (samples, (n, d))}, samples.device)
    if d > max_d:
        raise NotImplementedError(f"{what}: D <= {max_d} only (got {d})")


def _plain(means, inv_chols, log_weights, log_dets, samples, want_grads):
    d = means.shape[1]
    diffs = samples[None, :, :] - means[:, None, :]                 # [K,N,D]
    y = torch.einsum("kij,knj->kni", inv_chols, diffs)
    comp = -0.5 * torch.sum(y * y, dim=-1) \
        + (-log_dets - 0.5 * d * LOG_2PI)[:, None]
    mask = (log_weights > -math.inf)[:, None]
    weighted = comp + log_weights[:, None]
    model = masked_logsumexp(weighted, mask=mask, dim=0)
    if not want_grads:
        return comp, model
    resp = torch.where(mask, torch.exp(weighted - model[None, :]), 0.0)
    ptd = torch.einsum("kji,knj->kni", inv_chols, y)
    grads = -torch.einsum("kn,knd->nd", resp, ptd)
    return comp, model, grads


def density_pack_plain(means, inv_chols, log_weights, log_dets, samples
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of B1: (comp [K, N], model [N], grads [N, D])."""
    return _plain(means, inv_chols, log_weights, log_dets, samples, True)


def densities_plain(means, inv_chols, log_weights, log_dets, samples
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of B2: (comp [K, N], model [N])."""
    return _plain(means, inv_chols, log_weights, log_dets, samples, False)


def _launch(means, inv_chols, log_weights, log_dets, samples, want_grads):
    k, d = means.shape
    n = samples.shape[0]
    ins = (means, inv_chols, log_weights, log_dets, samples)
    opts = dict(dtype=torch.float32, device=samples.device)
    comp = torch.empty((k, n), **opts)
    model = torch.empty((n,), **opts)
    grads = torch.empty((n, d), **opts) if want_grads else None
    lib = cuda.library("density.cu")
    rc = lib.gmmvi_density(
        *[t.data_ptr() for t in ins], comp.data_ptr(), model.data_ptr(),
        grads.data_ptr() if want_grads else None, k, n, d,
        cuda.stream_ptr(samples.device))
    cuda.check(rc, "density_pack" if want_grads else "densities")
    cuda.LAUNCHES["density_pack" if want_grads else "densities"] += 1
    return (comp, model, grads) if want_grads else (comp, model)


def density_pack(means, inv_chols, log_weights, log_dets, samples):
    """B1: (comp [K, N], model [N], grads [N, D])."""
    check_inputs(means, inv_chols, log_weights, log_dets, samples)
    if samples.device.type == "cpu":
        return density_pack_plain(means, inv_chols, log_weights, log_dets,
                                  samples)
    return _launch(means, inv_chols, log_weights, log_dets, samples, True)


def densities(means, inv_chols, log_weights, log_dets, samples):
    """B2: (comp [K, N], model [N])."""
    check_inputs(means, inv_chols, log_weights, log_dets, samples)
    if samples.device.type == "cpu":
        return densities_plain(means, inv_chols, log_weights, log_dets,
                               samples)
    return _launch(means, inv_chols, log_weights, log_dets, samples, False)
