"""Fused mixture density passes: kernels B1 (density pack) and B2
(densities only).

(JAX counterpart: gmmvi_tpu/ops/pallas_density.py, ``_density_pack_kernel``
and ``_densities_kernel``; CUDA source: portbench.reference/csrc/density.cu)

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
tensor they launch the kernel or raise.  D <= 128; larger D takes the
XLA chain, by the dispatch in ``models/gmm.py``.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

from portbench.reference.ops import cuda
from portbench.reference.ops.stable import masked_logsumexp

LOG_2PI = math.log(2.0 * math.pi)
MAX_D = 128


def check_inputs(means, inv_chols, log_weights, log_dets, samples,
                 what: str = "the density kernels B1/B2",
                 max_d: int = MAX_D):
    """Shapes, float32, one device, row-major, and D <= ``max_d``; shared
    with the background kernel (B4)."""
    k, d = means.shape
    n = samples.shape[0]
    cuda.check_tensors({
        "means": (means, (k, d)), "inv_chols": (inv_chols, (k, d, d)),
        "log_weights": (log_weights, (k,)), "log_dets": (log_dets, (k,)),
        "samples": (samples, (n, d))}, samples.device)
    if d > max_d:
        raise NotImplementedError(f"{what}: D <= {max_d} only (got {d})")


# the reference evaluates at most this many [K, N, D] elements at once
MAX_ELEMENTS = 1 << 27


def row_blocks(k: int, n: int, d: int):
    """``(lo, hi)`` blocks of the ``n`` rows with at most
    :data:`MAX_ELEMENTS` elements of a ``[k, rows, d]`` slab each: every
    row's result is computed alone, so blocks change nothing but the
    memory the reference takes."""
    step = max(1, MAX_ELEMENTS // max(1, k * d))
    return [(lo, min(n, lo + step)) for lo in range(0, n, step)] or [(0, 0)]


def _plain(means, inv_chols, log_weights, log_dets, samples, want_grads):
    k, d = means.shape
    blocks = row_blocks(k, samples.shape[0], d)
    if len(blocks) > 1:
        parts = [_plain(means, inv_chols, log_weights, log_dets,
                        samples[lo:hi], want_grads) for lo, hi in blocks]
        return tuple(torch.cat(p, dim=1 if i == 0 else 0)
                     for i, p in enumerate(zip(*parts)))
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


def density_pack(means, inv_chols, log_weights, log_dets, samples):
    """B1: (comp [K, N], model [N], grads [N, D])."""
    check_inputs(means, inv_chols, log_weights, log_dets, samples)
    return density_pack_plain(means, inv_chols, log_weights, log_dets,
                              samples)


def densities(means, inv_chols, log_weights, log_dets, samples):
    """B2: (comp [K, N], model [N])."""
    check_inputs(means, inv_chols, log_weights, log_dets, samples)
    return densities_plain(means, inv_chols, log_weights, log_dets,
                           samples)
