"""Mixture of multivariate Student-T target distributions.

(JAX counterpart: gmmvi_tpu/experiments/targets/student_t_mixture.py)

log St(x; nu, mu, L) = lgamma((nu+D)/2) - lgamma(nu/2) - D/2 log(nu*pi)
                       - log|L| - (nu+D)/2 log(1 + m/nu),
with m the squared Mahalanobis distance under the scale matrix L L^T.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from gmmvi_tpu_torch.device import resolve_device
from gmmvi_tpu_torch.experiments.targets.lnpdf import LNPDF


class StudentTMixture_LNPDF(LNPDF):
    """Student-T mixture with analytic log density and gradient."""

    def __init__(self, target_weights, target_means, target_covs, alpha=2,
                 device="cuda"):
        dev = resolve_device(device)
        self.alpha = float(alpha)
        self.target_weights = np.asarray(target_weights, np.float32)
        self.target_means = np.asarray(target_means, np.float32)
        self.target_covs = np.asarray(target_covs, np.float32)
        # factor in float64 on the host, like the JAX package, then store f32
        chols = np.linalg.cholesky(self.target_covs.astype(np.float64))
        f32 = dict(dtype=torch.float32, device=dev)
        self._means = torch.as_tensor(self.target_means, **f32)
        self._inv_chols = torch.as_tensor(np.linalg.inv(chols), **f32)
        self._log_dets = torch.as_tensor(
            np.sum(np.log(np.diagonal(chols, axis1=-2, axis2=-1)), axis=-1),
            **f32)
        self._log_w = torch.as_tensor(
            np.log(self.target_weights / self.target_weights.sum()), **f32)
        nu, d = self.alpha, self.get_num_dimensions()
        self._const = (math.lgamma(0.5 * (nu + d)) - math.lgamma(0.5 * nu)
                       - 0.5 * d * math.log(nu * math.pi))

    def _whiten(self, x):
        """([K, N, D] whitened diffs, [K, N] Mahalanobis distances)."""
        diffs = x[None, :, :] - self._means[:, None, :]
        y = torch.einsum("kij,knj->kni", self._inv_chols, diffs)
        return y, torch.sum(y * y, dim=-1)

    def _log_probs_from_maha(self, maha):
        nu, d = self.alpha, self.get_num_dimensions()
        return (self._const - self._log_dets[:, None]
                - 0.5 * (nu + d) * torch.log1p(maha / nu))

    def log_density(self, x):
        comp = self._log_probs_from_maha(self._whiten(x)[1])
        return torch.logsumexp(comp + self._log_w[:, None], dim=0)

    def log_density_and_grad(self, x):
        """grad log p(x) = -sum_k r_k(x) (nu+D)/(nu+maha_k) L_k^{-T} y_k with
        responsibilities r_k and y_k = L_k^{-1}(x - mu_k)."""
        nu, d = self.alpha, self.get_num_dimensions()
        y, maha = self._whiten(x)
        weighted = self._log_probs_from_maha(maha) + self._log_w[:, None]
        ld = torch.logsumexp(weighted, dim=0)
        scale = torch.exp(weighted - ld[None, :]) * (nu + d) / (nu + maha)
        grads = -torch.einsum("kij,kni,kn->nj", self._inv_chols, y, scale)
        return ld, grads

    def get_num_dimensions(self):
        return self.target_means.shape[1]


def make_target(num_dimensions: int, harder_setting: bool,
                use_matlab_target: bool = False, seed: int = None,
                device="cuda") -> StudentTMixture_LNPDF:
    """Random Student-T mixture (Lin et al., 2020): 20-D -> 10 components
    spread s=20, harder -> 20 components spread s=25; covariances are
    inverses of A^T A + I with A ~ 0.1 D N(0, 1).  Draws from
    ``np.random.RandomState(seed)`` exactly as the JAX package does, so the
    same seed gives the same target."""
    if use_matlab_target:
        raise NotImplementedError(
            "MATLAB ground-truth targets are not bundled")
    if harder_setting:
        s, num_components = 25, 20
    else:
        s, num_components = 20, 10
    rng = np.random.RandomState(seed)
    weights = np.ones(num_components) / num_components
    means = rng.uniform(0, 1, (num_components, num_dimensions)) * (2 * s) - s
    covs = np.empty((num_components, num_dimensions, num_dimensions))
    for i in range(num_components):
        a = 0.1 * num_dimensions * rng.normal(
            0, 1, (num_dimensions, num_dimensions))
        covs[i] = np.linalg.inv(a.T @ a + np.eye(num_dimensions))
    return StudentTMixture_LNPDF(weights, means, covs, device=device)
