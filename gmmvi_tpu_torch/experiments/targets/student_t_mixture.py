"""Mixture of multivariate Student-T target distributions.

(JAX counterpart: gmmvi_tpu/experiments/targets/student_t_mixture.py)

log St(x; nu, mu, L) = lgamma((nu+D)/2) - lgamma(nu/2) - D/2 log(nu*pi)
                       - log|L| - (nu+D)/2 log(1 + m/nu),
with m the squared Mahalanobis distance under the scale matrix L L^T.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from gmmvi_tpu_torch.device import resolve_device
from gmmvi_tpu_torch.experiments.targets.lnpdf import (LNPDF,
                                                       detected_modes_metrics)


class StudentTMixture_LNPDF(LNPDF):
    """Student-T mixture with analytic log density and gradient."""

    def __init__(self, target_weights, target_means, target_covs, alpha=2,
                 make_plots=True, device="cuda"):
        super().__init__(use_log_density_and_grad=True, safe_for_jit=True)
        dev = resolve_device(device)
        self.make_plots = make_plots
        self.alpha = float(alpha)
        self.target_weights = np.asarray(target_weights, np.float32)
        self.target_means = np.asarray(target_means, np.float32)
        self.target_covs = np.asarray(target_covs, np.float32)
        # factor in float64 on the host, like the JAX package, then store f32
        chols = np.linalg.cholesky(self.target_covs.astype(np.float64))
        f32 = dict(dtype=torch.float32, device=dev)
        self._means = torch.as_tensor(self.target_means, **f32)
        self._chols = torch.as_tensor(chols, **f32)
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

    def marginal_log_density(self, x, dim):
        """1-D marginal mixture of Student-Ts along ``dim``."""
        nu = self.alpha
        x = torch.as_tensor(x, dtype=torch.float32,
                            device=self._means.device)[:, dim]
        mu = self._means[:, dim]
        scale = torch.sqrt(torch.as_tensor(self.target_covs[:, dim, dim],
                                           device=self._means.device))
        z = (x[None, :] - mu[:, None]) / scale[:, None]
        const = (math.lgamma(0.5 * (nu + 1)) - math.lgamma(0.5 * nu)
                 - 0.5 * math.log(nu * math.pi))
        comp = const - torch.log(scale)[:, None] \
            - 0.5 * (nu + 1) * torch.log1p(torch.square(z) / nu)
        return torch.logsumexp(comp + self._log_w[:, None], dim=0)

    def get_num_dimensions(self):
        return self.target_means.shape[1]

    def can_sample(self):
        return True

    def sample(self, n: int, generator: Optional[torch.Generator] = None):
        """``x = mu_k + L_k z sqrt(nu / chi2_nu)`` with k drawn by the
        weights."""
        dev, d = self._means.device, self.get_num_dimensions()
        comp = torch.multinomial(torch.exp(self._log_w), n, replacement=True,
                                 generator=generator)
        z = torch.randn((n, d), generator=generator, device=dev)
        chi2 = 2.0 * torch._standard_gamma(
            torch.full((n,), 0.5 * self.alpha, device=dev),
            generator=generator)
        lz = torch.einsum("nij,nj->ni", self._chols[comp], z)
        return self._means[comp] + lz * torch.sqrt(self.alpha / chi2)[:, None]

    def expensive_metrics(self, model_state, samples) -> dict:
        return detected_modes_metrics(self, model_state, (-25, 25),
                                      grid=(5, 4))


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
