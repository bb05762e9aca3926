"""Streamed Stein second moments: kernel B7.

(JAX counterpart: gmmvi_tpu/ops/pallas_stein.py, ``_smom_kernel`` behind
``fused_stein_smom``; CUDA source: portbench.reference/csrc/stein.cu)

The moment form of the self-normalized Stein estimator needs, for every
component k,

    s_mom[k] = sum_n w[k, n] g[n, :] xc[n, :]^T        [K, D, D]

from weights ``w [K, N]`` (zero for samples to ignore), log-ratio gradients
``g [N, D]`` and centred samples ``xc [N, D]``: the kernel's plain
version.
"""
from __future__ import annotations

import torch

N_CHUNK = 4096


def stein_smom_plain(w, g, xc) -> torch.Tensor:
    """Plain PyTorch version of B7: ``(w_k o g)^T xc`` per component, summed
    over chunks of N_CHUNK samples, so no ``[K, N, D]`` array is larger
    than ``[K, N_CHUNK, D]`` (and no ``[N, D, D]`` outer product is
    formed)."""
    k, n = w.shape
    d = g.shape[1]
    out = torch.zeros((k, d, d), dtype=g.dtype, device=g.device)
    for s in range(0, n, N_CHUNK):
        a = w[:, s:s + N_CHUNK, None] * g[None, s:s + N_CHUNK, :]
        out += a.mT @ xc[s:s + N_CHUNK]
    return out

