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
from gmmvi_tpu_torch.utils import profiling

# B7 runs for MIN_D < D <= MAX_D; at D <= MIN_D the plain moments contract
# the outer products
MIN_D = 64
MAX_D = 512
N_CHUNK = 4096


def supports(d: int, n: int) -> bool:
    """Where the JAX package streams the moments through its kernel
    (``pallas_stein.supports``)."""
    return MIN_D < d <= MAX_D and n >= 512


def stein_smom_plain(w, g, xc) -> torch.Tensor:
    """Plain PyTorch version of B7, summed over slabs of rows of the window.

    For D <= MIN_D, where the kernel does not run, each slab's outer
    products ``g_n xc_n^T`` are formed once as ``[rows, D*D]`` and contracted
    with the slab's weights in one fp32 product ``[K, rows] @ [rows, D*D]``,
    whose K x D^2 output fills the card's tiles (a per-component ``[D, D]``
    product pads them tenfold at D = 10).  A slab holds at most
    ``K * N_CHUNK // D`` rows (at least one), so no ``[rows, D*D]`` array
    has more elements than ``[K, N_CHUNK, D]``: one slab at the planar
    robot's window.  Above MIN_D (the CPU, windows under 512 rows,
    D > 512) the D^2 outer products cost more than they save (at K = 40,
    D = 1,024 four times the broadcast's time on an H100), so each slab of
    N_CHUNK rows forms ``w_k o g`` as ``[K, rows, D]`` and multiplies it by
    ``xc``.  The slab count goes to the counter ``stein.moment_slabs``."""
    k, n = w.shape
    d = g.shape[1]
    outer = d <= MIN_D
    rows = max(1, k * N_CHUNK // d) if outer else N_CHUNK
    profiling.count("stein.moment_slabs", -(-n // rows))
    out = torch.zeros((k, d, d), dtype=g.dtype, device=g.device)
    for s in range(0, n, rows):
        ws, gs, xs = w[:, s:s + rows], g[s:s + rows], xc[s:s + rows]
        if outer:
            out += (ws @ (gs[:, :, None] * xs[:, None, :]).flatten(1)).view(
                k, d, d)
        else:
            out += (ws[:, :, None] * gs[None]).mT @ xs
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
    lib = cuda.library("stein.cu")
    ws = cuda.workspace(lib, "gmmvi_stein_smom", g.device, k, n, d)
    rc = lib.gmmvi_stein_smom(
        w.data_ptr(), g.data_ptr(), xc.data_ptr(), out.data_ptr(),
        ws.data_ptr(), k, n, d, cuda.stream_ptr(g.device))
    cuda.check(rc, "stein_smom")
    cuda.LAUNCHES["stein_smom"] += 1
    return out
