"""Mixture log-density of a padded model: kernel B9.

(JAX counterpart: gmmvi_tpu/ops/pallas_kernels.py, ``_mixture_logpdf_kernel``
behind ``fused_mixture_logpdf``, and its XLA path ``_plain_mixture_logpdf``;
called by ``models/gmm.py`` ``log_density``; CUDA source: the entry
``gmmvi_mixture_logpdf`` of gmmvi_tpu_torch/csrc/background.cu)

For a mixture given by ``means [K, D]``, lower-triangular inverse Cholesky
factors ``inv_chols [K, D, D]``, ``log_weights [K]`` (-inf masks a slot) and
``log_dets [K]`` (log |L_k|), over samples ``x [N, D]``::

    out[n] = logsumexp_k(log w_k + log N(x_n; mu_k, Sigma_k))

over the slots with a finite log weight; -inf where there is none.  This is
the function of the background kernel B4 over a model's own components, so
B9 launches B4's kernel through an entry and a launch count of its own.  On
a CPU tensor the wrapper runs the plain PyTorch version below; on a CUDA
tensor it launches the kernel or raises.  D <= 128; for 128 < D <= 512 it
takes the mixture output of the K-tiled kernel B5 with the masked slots
skipped (``ops/density_large.py``), and above 512 it raises (the JAX kernel
pads any D).
"""
from __future__ import annotations

import torch

from gmmvi_tpu_torch.ops import cuda, density_large
from gmmvi_tpu_torch.ops.density import MAX_D, check_inputs, densities_plain


def mixture_logpdf_plain(means, inv_chols, log_weights, log_dets, samples
                         ) -> torch.Tensor:
    """Plain PyTorch version of B9, ``[N]``: the XLA path of the JAX package
    (``_plain_mixture_logpdf``), with the arithmetic of the port's
    ``component_log_densities`` and ``masked_logsumexp`` (B2's plain
    version), so the CPU path gives the same bits as before the kernel."""
    return densities_plain(means, inv_chols, log_weights, log_dets,
                           samples)[1]


def mixture_logpdf(means, inv_chols, log_weights, log_dets, samples
                   ) -> torch.Tensor:
    """B9 (B5's mixture output at D > 128): the mixture log-density
    ``[N]``."""
    if means.shape[1] > MAX_D:
        return density_large.mixture_logpdf_large(
            means, inv_chols, log_weights, log_dets, samples)
    check_inputs(means, inv_chols, log_weights, log_dets, samples,
                 what="the mixture log-density kernel (B9)")
    if samples.device.type == "cpu":
        return mixture_logpdf_plain(means, inv_chols, log_weights, log_dets,
                                    samples)
    k, d = means.shape
    n = samples.shape[0]
    out = torch.empty((n,), dtype=torch.float32, device=samples.device)
    lib = cuda.library("background.cu")
    ws = cuda.workspace(lib, "gmmvi_background", samples.device, k, n, d)
    rc = lib.gmmvi_mixture_logpdf(
        means.data_ptr(), inv_chols.data_ptr(), log_weights.data_ptr(),
        log_dets.data_ptr(), samples.data_ptr(), out.data_ptr(),
        ws.data_ptr(), k, n, d, cuda.stream_ptr(samples.device))
    cuda.check(rc, "mixture_logpdf")
    cuda.LAUNCHES["mixture_logpdf"] += 1
    return out
