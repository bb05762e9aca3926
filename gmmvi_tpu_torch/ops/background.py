"""Count-weighted background mixture density: kernel B4.

(JAX counterpart: gmmvi_tpu/ops/pallas_density.py, ``_background_kernel``
behind ``fused_background_logpdf``, and the XLA chain of
``sample_db._background_logsumexp``; called directly from the port's
``sample_db``; CUDA source: gmmvi_tpu_torch/csrc/background.cu)

For U generating distributions given by ``means [U, D]``, lower-triangular
inverse Cholesky factors ``inv_chols [U, D, D]``, ``log_weights [U]`` (-inf
marks a row that is not selected) and ``log_dets [U]`` (log |L_u|), over
samples ``x [N, D]``::

    bg[n] = logsumexp_u(log N(x_n; mu_u, Sigma_u) + log_weights[u])

over the rows with a finite log weight; -inf where there is none, as
``masked_logsumexp`` gives.  On a CPU tensor the wrapper runs the plain
PyTorch version below; on a CUDA tensor it launches the kernel or raises.
D <= 128; for 128 < D <= 512 it takes the mixture output of the K-tiled
kernel B5 with the -inf rows skipped (``ops/density_large.py``), as the
JAX package does at D = 300.
"""
from __future__ import annotations

import math

import torch

from gmmvi_tpu_torch.ops import cuda, density_large
from gmmvi_tpu_torch.ops.density import MAX_D, check_inputs
from gmmvi_tpu_torch.ops.stable import masked_logsumexp

LOG_2PI = math.log(2.0 * math.pi)


def background_logpdf_plain(means, inv_chols, log_weights, log_dets,
                            samples) -> torch.Tensor:
    """Plain PyTorch version of B4: the XLA chain of the JAX package
    (``_dist_log_pdfs`` then ``masked_logsumexp``), ``[N]``."""
    d = means.shape[1]
    diffs = samples[None, :, :] - means[:, None, :]                 # [U,N,D]
    y = torch.einsum("uij,unj->uni", inv_chols, diffs)
    log_pdfs = -0.5 * torch.sum(y * y, dim=-1) - log_dets[:, None] \
        - 0.5 * d * LOG_2PI
    return masked_logsumexp(log_pdfs + log_weights[:, None],
                            mask=(log_weights > -math.inf)[:, None], dim=0)


def background_logpdf(means, inv_chols, log_weights, log_dets, samples
                      ) -> torch.Tensor:
    """B4 (B5's mixture output at D > 128): the background log-density
    ``[N]``."""
    if means.shape[1] > MAX_D:
        return density_large.mixture_logpdf_large(
            means, inv_chols, log_weights, log_dets, samples)
    check_inputs(means, inv_chols, log_weights, log_dets, samples,
                 what="the background kernel (B4)")
    if samples.device.type == "cpu":
        return background_logpdf_plain(means, inv_chols, log_weights,
                                       log_dets, samples)
    u, d = means.shape
    n = samples.shape[0]
    out = torch.empty((n,), dtype=torch.float32, device=samples.device)
    lib = cuda.library("background.cu")
    ws = cuda.workspace(lib, "gmmvi_background", samples.device, u, n, d)
    rc = lib.gmmvi_background(
        means.data_ptr(), inv_chols.data_ptr(), log_weights.data_ptr(),
        log_dets.data_ptr(), samples.data_ptr(), out.data_ptr(),
        ws.data_ptr(), u, n, d, cuda.stream_ptr(samples.device))
    cuda.check(rc, "background_logpdf")
    cuda.LAUNCHES["background_logpdf"] += 1
    return out
