"""Streamed Stein second moments: kernel B7.

(JAX counterpart: gmmvi_tpu/ops/pallas_stein.py, ``_smom_kernel`` behind
``fused_stein_smom``; CUDA source: gmmvi_tpu_torch/csrc/stein.cu)

The moment form of the self-normalized Stein estimator needs, for every
component k,

    s_mom[k] = sum_n w[k, n] g[n, :] xc[n, :]^T        [K, D, D]

from weights ``w [K, N]`` (zero for samples to ignore), log-ratio gradients
``g [N, D]`` and centred samples ``xc [N, D]``.  The estimator calls the
kernel where the JAX package calls its own (:func:`supports`: 64 < D <= 512
and N >= 512) and the plain version elsewhere.  On a CPU tensor
:func:`stein_smom` runs the plain version; on a CUDA tensor it launches the
kernel or raises.
"""
from __future__ import annotations

import torch

from gmmvi_tpu_torch.ops import cuda

MAX_D = 512
N_CHUNK = 4096


def supports(d: int, n: int) -> bool:
    """Where the JAX package streams the moments through its kernel
    (``pallas_stein.supports``)."""
    return 64 < d <= MAX_D and n >= 512


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


def stein_smom(w, g, xc) -> torch.Tensor:
    """B7: ``s_mom [K, D, D]``."""
    k, n = w.shape
    d = g.shape[1]
    cuda.check_tensors({"w": (w, (k, n)), "g": (g, (n, d)),
                        "xc": (xc, (n, d))}, g.device)
    if d > MAX_D:
        raise NotImplementedError(
            f"the Stein moment kernel (B7): D <= {MAX_D} only (got {d})")
    if g.device.type == "cpu":
        return stein_smom_plain(w, g, xc)
    out = torch.empty((k, d, d), dtype=torch.float32, device=g.device)
    rc = cuda.library("stein.cu").gmmvi_stein_smom(
        w.data_ptr(), g.data_ptr(), xc.data_ptr(), out.data_ptr(), k, n, d,
        cuda.stream_ptr(g.device))
    cuda.check(rc, "stein_smom")
    cuda.LAUNCHES["stein_smom"] += 1
    return out
