"""Weighted normal equations of the MORE quadratic fit: kernel B8.

(JAX counterpart: gmmvi_tpu/ops/pallas_more.py, ``_more_gram_kernel`` behind
``fused_more_grams``; CUDA source: gmmvi_tpu_torch/csrc/more.cu)

For every component k, with the samples whitened by it,
``z = L_k^{-1}(x - mu_k)``, and their F = 1 + D + D(D+1)/2 quadratic
features in the reference's order (upper triangle by rows, then z, then 1):

    gram[k] = X_k^T W_k X_k  [F, F]        rhs[k] = X_k^T W_k y  [F]

from ``inv_chols [K, D, D]``, ``means [K, D]``, weights ``[K, N]`` (zero for
samples to ignore), outputs ``y [N]`` and samples ``x [N, D]``.  On a CPU
tensor the wrapper runs the plain PyTorch version below; on a CUDA tensor it
launches the kernel or raises.  D <= 45, the JAX kernel's envelope.
"""
from __future__ import annotations

from typing import Tuple

import torch

from gmmvi_tpu_torch.ops import cuda
from gmmvi_tpu_torch.ops.quadratic import (num_features, weighted_normal_eqs,
                                           whiten)

MAX_D = 45


def _check_inputs(inv_chols, means, weights, outputs, samples):
    k, d = means.shape
    n = samples.shape[0]
    cuda.check_tensors({
        "inv_chols": (inv_chols, (k, d, d)), "means": (means, (k, d)),
        "weights": (weights, (k, n)), "outputs": (outputs, (n,)),
        "samples": (samples, (n, d))}, samples.device)
    if d > MAX_D:
        raise NotImplementedError(
            f"the MORE Gram kernel (B8): D <= {MAX_D} only (got {d}), the "
            "JAX kernel's envelope")


def more_grams_plain(inv_chols, means, weights, outputs, samples
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of B8: ``fit_quadratic``'s features and Gram,
    one component at a time (bounded ``[N, F]`` memory, like the JAX
    package's ``lax.map``)."""
    grams, rhss = [], []
    for k in range(means.shape[0]):
        gram, rhs = weighted_normal_eqs(
            whiten(samples, means[k], inv_chols[k]), outputs, weights[k])
        grams.append(gram)
        rhss.append(rhs)
    return torch.stack(grams), torch.stack(rhss)


def more_grams(inv_chols, means, weights, outputs, samples
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """B8: ``(gram [K, F, F], rhs [K, F])``."""
    _check_inputs(inv_chols, means, weights, outputs, samples)
    if samples.device.type == "cpu":
        return more_grams_plain(inv_chols, means, weights, outputs, samples)
    k, d = means.shape
    n = samples.shape[0]
    f = num_features(d)
    opts = dict(dtype=torch.float32, device=samples.device)
    gram = torch.empty((k, f, f), **opts)
    rhs = torch.empty((k, f), **opts)
    rc = cuda.library("more.cu").gmmvi_more_grams(
        inv_chols.data_ptr(), means.data_ptr(), weights.data_ptr(),
        outputs.data_ptr(), samples.data_ptr(), gram.data_ptr(),
        rhs.data_ptr(), k, n, d, cuda.stream_ptr(samples.device))
    cuda.check(rc, "more_grams")
    cuda.LAUNCHES["more_grams"] += 1
    return gram, rhs
