"""GMM target distributions, full and diagonal covariance.

(JAX counterpart: gmmvi_tpu/experiments/targets/gmm.py)

The target is a padded :class:`~gmmvi_tpu_torch.models.gmm.GmmState`, so a
full-covariance target's log-density runs through the mixture log-density
kernel B9 and its density and analytic gradient through the density-pack
kernel B1 (B5/B6 at D > 128); a diagonal one's are plain torch, as the
model's are.  The random targets draw from ``np.random.RandomState(seed)``
exactly as the JAX package does, so one seed gives the same target in both.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from gmmvi_tpu_torch.device import resolve_device
from gmmvi_tpu_torch.experiments.targets.lnpdf import (LNPDF,
                                                       detected_modes_metrics)
from gmmvi_tpu_torch.models import gmm as gmm_ops
from gmmvi_tpu_torch.models.gmm import create_gmm_state


class GMM_LNPDF(LNPDF):
    """Target given by a GMM: covariances ``[K, D, D]``, or variances
    ``[K, D]`` with ``diagonal``."""

    def __init__(self, target_weights, target_means, target_covs,
                 make_plots=True, device="cuda", diagonal=False):
        self.target_weights = np.asarray(target_weights, np.float32)
        self.target_means = np.asarray(target_means, np.float32)
        self.target_covs = np.asarray(target_covs, np.float32)
        self.make_plots = make_plots
        self._state = create_gmm_state(self.target_weights, self.target_means,
                                       self.target_covs, diagonal=diagonal,
                                       device=resolve_device(device))

    def _x(self, x) -> torch.Tensor:
        """Samples in the parameters' float type (float32 unless a caller
        cast them) on their device."""
        return torch.as_tensor(x, dtype=self._state.means.dtype,
                               device=self._state.device).contiguous()

    def log_density(self, x):
        return gmm_ops.log_density(self._state, self._x(x))

    def log_density_and_grad(self, x):
        """Analytic mixture gradient from one density pass."""
        pack = gmm_ops.density_pack(self._state, self._x(x))
        return pack.model_log_densities, pack.model_grads

    def marginal_log_density(self, x, dim):
        return gmm_ops.marginal_log_density(self._state, self._x(x), dim)

    def get_num_dimensions(self):
        return self.target_means.shape[1]

    def can_sample(self):
        return True

    def sample(self, n: int, generator: Optional[torch.Generator] = None):
        return gmm_ops.sample(self._state, n, generator)[0]

    def expensive_metrics(self, model_state, samples) -> dict:
        return detected_modes_metrics(self, model_state, (-70, 70),
                                      grid=(4, 5))


class DIAGGMM_LNPDF(GMM_LNPDF):
    """Target given by a diagonal-covariance GMM (variances ``[K, D]``);
    no metrics of its own."""

    def __init__(self, target_weights, target_means, target_covs,
                 device="cuda"):
        super().__init__(target_weights, target_means, target_covs,
                         device=device, diagonal=True)

    def expensive_metrics(self, model_state, samples) -> dict:
        return {}


def make_target(num_dimensions: int, seed: int = None, device="cuda"
                ) -> GMM_LNPDF:
    """Random 10-component GMM: means ~ 100 (U - 0.5), covariances
    A^T A + I with A ~ 0.1 N(0, D) (scale D, as the reference draws it)."""
    rng = np.random.RandomState(seed)
    num_true_components = 10
    weights = np.ones(num_true_components) / num_true_components
    means = 100.0 * (rng.random((num_true_components, num_dimensions)) - 0.5)
    covs = np.empty((num_true_components, num_dimensions, num_dimensions))
    for i in range(num_true_components):
        a = 0.1 * rng.normal(0, num_dimensions,
                             (num_dimensions, num_dimensions))
        covs[i] = a.T @ a + np.eye(num_dimensions)
    return GMM_LNPDF(weights, means, covs, device=device)


def make_target_with_scale(num_dimensions: int, num_components: int,
                           scale: float, seed: int = None, device="cuda"
                           ) -> GMM_LNPDF:
    """Random GMM with a given component count and covariance scale:
    covariances A^T A + I with A ~ N(0, sqrt(scale))."""
    rng = np.random.RandomState(seed)
    weights = np.ones(num_components) / num_components
    means = 100.0 * (rng.random((num_components, num_dimensions)) - 0.5)
    covs = np.empty((num_components, num_dimensions, num_dimensions))
    for i in range(num_components):
        a = rng.normal(0, math.sqrt(scale), (num_dimensions, num_dimensions))
        covs[i] = a.T @ a + np.eye(num_dimensions)
    return GMM_LNPDF(weights, means, covs, device=device)


def make_diag_target(num_dimensions: int, seed: int = None, device="cuda"
                     ) -> DIAGGMM_LNPDF:
    """Random 10-component diagonal GMM: means ~ 100 (U - 0.5), variances
    10 U."""
    rng = np.random.RandomState(seed)
    k = 10
    weights = np.ones(k) / k
    means = 100.0 * (rng.random((k, num_dimensions)) - 0.5)
    covs = 10.0 * rng.random((k, num_dimensions))
    return DIAGGMM_LNPDF(weights, means, covs, device=device)


def _rot(theta):
    return np.array([[math.cos(theta), math.sin(theta)],
                     [-math.sin(theta), math.cos(theta)]])


def make_simple_target(device="cuda") -> GMM_LNPDF:
    """3-component 2-D mixture."""
    w = np.array([0.5, 0.3, 0.2])
    mu = np.array([[-2.0, -2.0], [2.0, -2.0], [0.0, 2.0]])
    c1 = _rot(math.pi / 4) @ np.diag([0.5, 1.0]) @ _rot(math.pi / 4).T
    c2 = _rot(-math.pi / 4) @ np.diag([0.5, 1.0]) @ _rot(-math.pi / 4).T
    c3 = _rot(math.pi / 2) @ np.diag([1.0, 2.0]) @ _rot(math.pi / 2).T
    return GMM_LNPDF(w, mu, np.stack([c1, c2, c3]), device=device)


def make_star_target(num_components: int, device="cuda") -> GMM_LNPDF:
    """Lin et al.'s star target: rotated anisotropic components."""
    k = num_components
    w = np.ones(k) / k
    mus = [np.array([1.5, 0.0])]
    precs = [np.diag([1.0, 100.0])]
    u = _rot(2 * math.pi / k)
    for _ in range(k - 1):
        mus.append(u @ mus[-1])
        precs.append(u @ precs[-1] @ u.T)
    covs = np.linalg.inv(np.stack(precs))
    return GMM_LNPDF(w, np.stack(mus), covs, device=device)
