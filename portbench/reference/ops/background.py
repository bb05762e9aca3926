"""Count-weighted background mixture density: kernel B4.

(JAX counterpart: gmmvi_tpu/ops/pallas_density.py, ``_background_kernel``
behind ``fused_background_logpdf``, and the XLA chain of
``sample_db._background_logsumexp``; called directly from the port's
``sample_db``; CUDA source: portbench.reference/csrc/background.cu)

For U generating distributions given by ``means [U, D]``, lower-triangular
inverse Cholesky factors ``inv_chols [U, D, D]``, ``log_weights [U]`` (-inf
marks a row that is not selected) and ``log_dets [U]`` (log |L_u|), over
samples ``x [N, D]``::

    bg[n] = logsumexp_u(log N(x_n; mu_u, Sigma_u) + log_weights[u])

over the rows with a finite log weight; -inf where there is none, as
``masked_logsumexp`` gives.  On a CPU tensor the wrapper runs the plain
PyTorch version below; on a CUDA tensor it launches the kernel or raises.
D <= 128.
"""
from __future__ import annotations

import math

import torch

from portbench.reference.ops.density import check_inputs, row_blocks
from portbench.reference.ops.stable import masked_logsumexp

LOG_2PI = math.log(2.0 * math.pi)


def background_logpdf_plain(means, inv_chols, log_weights, log_dets,
                            samples) -> torch.Tensor:
    """Plain PyTorch version of B4: the XLA chain of the JAX package
    (``_dist_log_pdfs`` then ``masked_logsumexp``), ``[N]``; in blocks of
    rows (``row_blocks``)."""
    u, d = means.shape
    blocks = row_blocks(u, samples.shape[0], d)
    if len(blocks) > 1:
        return torch.cat([background_logpdf_plain(
            means, inv_chols, log_weights, log_dets, samples[lo:hi])
            for lo, hi in blocks])
    diffs = samples[None, :, :] - means[:, None, :]                 # [U,N,D]
    y = torch.einsum("uij,unj->uni", inv_chols, diffs)
    log_pdfs = -0.5 * torch.sum(y * y, dim=-1) - log_dets[:, None] \
        - 0.5 * d * LOG_2PI
    return masked_logsumexp(log_pdfs + log_weights[:, None],
                            mask=(log_weights > -math.inf)[:, None], dim=0)


def background_logpdf(means, inv_chols, log_weights, log_dets, samples
                      ) -> torch.Tensor:
    """B4: the background log-density ``[N]``."""
    check_inputs(means, inv_chols, log_weights, log_dets, samples,
                 what="the background kernel (B4)")
    return background_logpdf_plain(means, inv_chols, log_weights,
                                   log_dets, samples)
