"""Batched trust-region KL evaluation: kernel B3.

(JAX counterpart: gmmvi_tpu/ops/pallas_trust_region.py ``_tr_kl_kernel``;
CUDA source: gmmvi_tpu_torch/csrc/trust_region.cu)

For every component k at its own stepsize eta_k, with the interpolated
canonical parameters

    P_k = old_prec_k + reward_quad_k / eta_k,
    l_k = old_lin_k + reward_lin_k / eta_k,

computes KL(N(P_k^{-1} l_k, P_k^{-1}) || N(mean_k, Sigma_old_k)):

    0.5 * (kl_const_k + log|P_k| + ||L_k^{-1} O_k^T||_F^2
           + ||O_k (mean_k - P_k^{-1} l_k)||^2)

with L_k = chol(P_k), O_k the old inverse Cholesky factor and kl_const_k =
log|Sigma_old_k| - D.  Components with eta_k <= 0 or a non-positive-definite
P_k get F32_MAX, the rejection signal the bracket search expects.

On a CPU tensor :func:`tr_kl` runs the plain PyTorch version; on a CUDA
tensor it launches the kernel or raises.  D <= 64.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from gmmvi_tpu_torch.ops import cuda
from gmmvi_tpu_torch.ops.stable import F32_MAX

MAX_D = 64


class TrKlInputs(NamedTuple):
    """Per-component, eta-independent inputs of :func:`tr_kl`."""

    prec: torch.Tensor           # [K, D, D] old precision
    reward_quad: torch.Tensor    # [K, D, D]
    lin: torch.Tensor            # [K, D] old precision @ old mean
    reward_lin: torch.Tensor     # [K, D]
    old_inv_chols: torch.Tensor  # [K, D, D] lower triangular
    means: torch.Tensor          # [K, D] old means
    kl_const: torch.Tensor       # [K] old log-det of the covariance - D


def prepare_tr_kl_inputs(means, chols, inv_chols, reward_lin, reward_quad
                         ) -> TrKlInputs:
    """Inputs for :func:`tr_kl` from the old components and the rewards,
    made contiguous once here rather than on every bisection trip."""
    d = means.shape[1]
    prec = torch.einsum("kji,kjl->kil", inv_chols, inv_chols)
    lin = torch.einsum("kij,kj->ki", prec, means)
    old_logdet = 2.0 * torch.sum(
        torch.log(torch.abs(torch.diagonal(chols, dim1=-2, dim2=-1))), -1)
    return TrKlInputs(*[t.contiguous() for t in (
        prec, reward_quad, lin, reward_lin, inv_chols, means,
        old_logdet - d)])


def _check(etas: torch.Tensor, inp: TrKlInputs):
    k, d = inp.means.shape
    shapes = {"prec": (k, d, d), "reward_quad": (k, d, d), "lin": (k, d),
              "reward_lin": (k, d), "old_inv_chols": (k, d, d),
              "means": (k, d), "kl_const": (k,)}
    cuda.check_tensors(
        {"etas": (etas, (k,)),
         **{name: (t, shapes[name]) for name, t in zip(inp._fields, inp)}},
        etas.device)
    if d > MAX_D:
        raise NotImplementedError(
            f"the trust-region KL kernel takes D <= {MAX_D} (got {d})")


def tr_kl_plain(etas: torch.Tensor, inp: TrKlInputs) -> torch.Tensor:
    """Plain PyTorch version of B3: KL [K], F32_MAX where infeasible."""
    d = inp.means.shape[1]
    inv_eta = 1.0 / etas
    a = inp.prec + inp.reward_quad * inv_eta[:, None, None]
    y = inp.lin + inp.reward_lin * inv_eta[:, None]
    l, info = torch.linalg.cholesky_ex(a)
    bad = (etas <= 0.0) | (info != 0)
    eye = torch.eye(d, dtype=a.dtype, device=a.device)
    l = torch.where(bad[:, None, None], eye, l)
    logdiag = torch.sum(torch.log(torch.diagonal(l, dim1=-2, dim2=-1)), -1)
    z = torch.linalg.solve_triangular(l, y[:, :, None], upper=False)
    new_mean = torch.linalg.solve_triangular(l.mT, z, upper=True)[:, :, 0]
    half = torch.linalg.solve_triangular(l, inp.old_inv_chols.mT,
                                         upper=False)
    trace = torch.sum(half * half, dim=(-2, -1))
    od = torch.einsum("kij,kj->ki", inp.old_inv_chols, inp.means - new_mean)
    kl = 0.5 * (inp.kl_const + 2.0 * logdiag + trace
                + torch.sum(od * od, dim=-1))
    return torch.where(bad, F32_MAX, kl)


def tr_kl(etas: torch.Tensor, inp: TrKlInputs) -> torch.Tensor:
    """B3: KL(new_k(eta_k) || old_k) for all K components in one call."""
    _check(etas, inp)
    if etas.device.type == "cpu":
        return tr_kl_plain(etas, inp)
    k, d = inp.means.shape
    kl = torch.empty((k,), dtype=torch.float32, device=etas.device)
    lib = cuda.library("trust_region.cu")
    rc = lib.gmmvi_tr_kl(*[t.data_ptr() for t in (etas, *inp)],
                         kl.data_ptr(), k, d,
                         cuda.stream_ptr(etas.device))
    cuda.check(rc, "tr_kl")
    cuda.LAUNCHES["tr_kl"] += 1
    return kl
