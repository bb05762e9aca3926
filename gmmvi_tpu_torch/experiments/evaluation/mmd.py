"""Maximum Mean Discrepancy against a ground-truth sample.

(JAX counterpart: gmmvi_tpu/experiments/evaluation/mmd.py)

Bandwidth by the median trick over <= 1000 ground-truth points, a diagonal
kernel scaled by alpha; MMD^2 = U1/n1^2 + U2/n2^2 - 2 mix/(n1 n2), each
kernel sum one batched product and reduction.
"""
from __future__ import annotations

import numpy as np
import torch

from gmmvi_tpu_torch.device import resolve_device


class MMD:
    def __init__(self, groundtruth, alpha: float, device="cuda"):
        self.device = resolve_device(device)
        self.groundtruth = torch.as_tensor(np.asarray(groundtruth),
                                           dtype=torch.float32,
                                           device=self.device)
        self.num_groundtruth = int(self.groundtruth.shape[0])
        self.sigma = self._compute_sigma()
        self.set_alpha(alpha)

    def _compute_sigma(self, max_points_for_median: int = 1000
                       ) -> torch.Tensor:
        """Per-dimension median of the squared pairwise differences (pairs
        i <= j, the diagonal included)."""
        n = min(max_points_for_median, self.num_groundtruth)
        g = self.groundtruth[:n].cpu().numpy()
        iu, ju = np.triu_indices(n)
        sq = np.square(g[iu] - g[ju])
        return torch.as_tensor(np.median(sq, axis=0), dtype=torch.float32,
                               device=self.device)

    @staticmethod
    def _kernel_sum(a, b, inv_diag) -> torch.Tensor:
        """sum_{i,j} exp(-(a_i - b_j)^T K (a_i - b_j)) with diagonal K."""
        aw = a * inv_diag[None, :]
        a2 = torch.sum(aw * a, dim=1)
        b2 = torch.sum((b * inv_diag[None, :]) * b, dim=1)
        d2 = a2[:, None] + b2[None, :] - 2.0 * (aw @ b.T)
        return torch.sum(torch.exp(-d2))

    def set_alpha(self, alpha: float) -> None:
        self._alpha = float(alpha)
        self._inv_diag = 1.0 / (self._alpha * self.sigma)
        self.ustat1 = self._kernel_sum(self.groundtruth, self.groundtruth,
                                       self._inv_diag)

    def compute_MMD(self, model_sample) -> float:
        sample = torch.as_tensor(model_sample, dtype=torch.float32,
                                 device=self.device)
        n1, n2 = self.num_groundtruth, sample.shape[0]
        u2 = self._kernel_sum(sample, sample, self._inv_diag)
        mix = self._kernel_sum(self.groundtruth, sample, self._inv_diag)
        return float(self.ustat1 / n1 ** 2 + u2 / n2 ** 2
                     - 2.0 * mix / (n1 * n2))
