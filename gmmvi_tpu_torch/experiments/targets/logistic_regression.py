"""Bayesian logistic-regression posteriors (breast cancer, german credit).

(JAX counterpart: gmmvi_tpu/experiments/targets/logistic_regression.py)

A N(0, 10^2) prior over the weights of the standardized features with a
bias column prepended.  The likelihood takes the stable log-sigmoid form:
for z = -X theta, ``log sigma(z)`` where the label is 1 and ``log sigma(z)
- z`` where it is 0.  The full-batch target's gradient is analytic, two
large products (``X^T (sigma(z) - y)`` and the prior's term).

The minibatch variant is not ``safe_for_jit`` (its shuffled order is
host state), so a step gives it the proposal's valid rows in a
power-of-two bucket, as the JAX package does.  It reshuffles the training
data on every call to
:meth:`LogisticRegression_minibatch.log_density` with a host-side
``np.random.RandomState(seed)``, so both packages see the same batches
call for call; with ``use_own_batch_per_sample`` parameter sample i takes
the i-th of consecutive batches that wrap around the data.  Its
:meth:`~LogisticRegression_minibatch.log_density_and_grad`, the
optimizer's call, is autograd as the JAX package's default takes it, one
sample at a time within one trace: one shuffle, and every sample on the
first batch.  The data stay on the device; only the shuffled order and the
batch starts are made on the host.
"""
from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from gmmvi_tpu_torch.device import resolve_device
from gmmvi_tpu_torch.experiments.targets import datasets as data_lib
from gmmvi_tpu_torch.experiments.targets.lnpdf import LNPDF

LOG_2PI = math.log(2.0 * math.pi)


def _stable_loglik_terms(z: torch.Tensor, labels: torch.Tensor
                         ) -> torch.Tensor:
    """Per-datum log likelihoods given ``z = -X theta`` (labels broadcast
    against ``z``)."""
    logsig = F.logsigmoid(z)
    return torch.where(labels == 1, logsig, logsig - z)


class LogisticRegression(LNPDF):
    """Full-batch Bayesian logistic regression; D = features + 1."""

    def __init__(self, dataset_id: str, device="cuda"):
        if dataset_id == "breast_cancer":
            x, labels = data_lib.load_breast_cancer()
        elif dataset_id == "german_credit":
            x, labels = data_lib.load_german_credit()
        else:
            raise ValueError(f"unknown dataset_id {dataset_id}")
        x = x / np.std(x, 0)[None, :]
        x = np.hstack((np.ones((len(x), 1)), x))
        self.device = resolve_device(device)
        self.data = torch.as_tensor(x, dtype=torch.float32,
                                    device=self.device)
        self.labels = torch.as_tensor(labels, dtype=torch.float32,
                                      device=self.device)
        self.num_dimensions = x.shape[1]
        self.prior_std = 10.0
        self.prior_mean = 0.0

    def get_num_dimensions(self) -> int:
        return self.num_dimensions

    def _theta(self, theta) -> torch.Tensor:
        """Parameters in the data's float type (float32 unless a caller
        cast the data) on its device."""
        return torch.as_tensor(theta, dtype=self.data.dtype,
                               device=self.device)

    def log_prior(self, theta: torch.Tensor) -> torch.Tensor:
        return torch.sum(
            -math.log(self.prior_std) - 0.5 * LOG_2PI
            - 0.5 * torch.square((theta - self.prior_mean) / self.prior_std),
            dim=1)

    def log_likelihood(self, theta: torch.Tensor) -> torch.Tensor:
        z = -(self.data @ theta.mT)                           # [N, P]
        return torch.sum(_stable_loglik_terms(z, self.labels[:, None]), 0)

    def log_density(self, theta) -> torch.Tensor:
        theta = self._theta(theta)
        return self.log_likelihood(theta) + self.log_prior(theta)

    def log_density_and_grad(self, theta):
        """The posterior and its analytic gradient
        ``X^T (sigma(z) - y) - (theta - mu) / std^2`` with z = -X theta."""
        theta = self._theta(theta)
        z = -(self.data @ theta.mT)                           # [N, P]
        ld = torch.sum(_stable_loglik_terms(z, self.labels[:, None]), 0) \
            + self.log_prior(theta)
        coeff = torch.sigmoid(z) - self.labels[:, None]       # [N, P]
        grad = coeff.mT @ self.data \
            - (theta - self.prior_mean) / self.prior_std ** 2
        return ld, grad


class LogisticRegression_minibatch(LogisticRegression):
    """Minibatches reshuffled on every call; ``size_test_set`` rows at the
    end of the data are held out for testing."""

    def __init__(self, dataset_id: str, batchsize: int, size_test_set: int,
                 use_own_batch_per_sample: bool, seed: int = 0,
                 device="cuda"):
        super().__init__(dataset_id, device=device)
        # host state (the shuffled order): the host-target path, as in the
        # JAX package; no analytic gradient (autograd, below)
        self._safe_for_jit = False
        data, labels = self.data, self.labels
        if size_test_set > 0:
            self.data_test = data[-size_test_set:]
            self.labels_test = labels[-size_test_set:]
            data, labels = data[:-size_test_set], labels[:-size_test_set]
        self._train_data, self._train_labels = data, labels
        self.num_data = data.shape[0]
        self.batchsize = int(batchsize)
        self.use_own_batch_per_sample = bool(use_own_batch_per_sample)
        self._rng = np.random.RandomState(seed)
        # the training rows in their current shuffled order
        self._order = np.arange(self.num_data)

    def _shuffle(self) -> torch.Tensor:
        self._order = self._order[self._rng.permutation(self.num_data)]
        return torch.as_tensor(self._order, device=self.device)

    def log_density_and_grad(self, x: torch.Tensor
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Values and autograd gradients as the JAX package's default
        takes them, each sample through its own one-sample call within one
        trace: one shuffle a call, and every sample on its first batch of
        ``batchsize`` rows (with ``use_own_batch_per_sample`` too, as a
        call of one sample takes the first batch)."""
        with torch.enable_grad():
            theta = self._theta(x).detach().requires_grad_(True)
            ld = self._on_rows(theta, self._shuffle()[:self.batchsize])
            (grads,) = torch.autograd.grad(ld.sum(), theta)
        return ld.detach(), grads

    def log_density_fb(self, theta) -> torch.Tensor:
        """Full-batch log density over the training rows, in their current
        order (the runner's evaluation)."""
        theta = self._theta(theta)
        order = torch.as_tensor(self._order, device=self.device)
        z = -(self._train_data[order] @ theta.mT)
        ll = torch.sum(_stable_loglik_terms(
            z, self._train_labels[order][:, None]), 0)
        return ll + self.log_prior(theta)

    def log_density(self, theta) -> torch.Tensor:
        theta = self._theta(theta)
        order = self._shuffle()
        p, b = theta.shape[0], self.batchsize
        if self.use_own_batch_per_sample:
            # consecutive batches of b rows, starting over at the front when
            # the next would run past the end: sample i takes batch
            # i mod (N // b)
            starts = (np.arange(p) % (self.num_data // b)) * b
            idx = order[torch.as_tensor(starts, device=self.device)[:, None]
                        + torch.arange(b, device=self.device)[None, :]]
            data = self._train_data[idx]                      # [P, B, F]
            labels = self._train_labels[idx]                  # [P, B]
            z = -torch.einsum("pbf,pf->pb", data, theta)
            ll = torch.mean(_stable_loglik_terms(z, labels), dim=1)
            return self.num_data * ll + self.log_prior(theta)
        return self._on_rows(theta, order[:b])

    def _on_rows(self, theta, rows) -> torch.Tensor:
        """The log density of every sample on the one batch ``rows``."""
        z = -(self._train_data[rows] @ theta.mT)              # [B, P]
        ll = torch.mean(_stable_loglik_terms(
            z, self._train_labels[rows][:, None]), dim=0)
        return self.num_data * ll + self.log_prior(theta)

    def expensive_metrics(self, model_state, samples) -> dict:
        """The full-batch ELBO from the evaluation's draws."""
        from gmmvi_tpu_torch.models import gmm as gmm_ops

        entropy = -torch.mean(gmm_ops.log_density(model_state, samples))
        mean_reward = torch.mean(self.log_density_fb(samples))
        return {"elbo_fb": float(mean_reward + entropy)}


def make_breast_cancer(device="cuda") -> LogisticRegression:
    return LogisticRegression("breast_cancer", device=device)


def make_german_credit(device="cuda") -> LogisticRegression:
    return LogisticRegression("german_credit", device=device)


def make_breast_cancer_mb(batch_size, size_test_set,
                          use_own_batch_per_sample, device="cuda"
                          ) -> LogisticRegression_minibatch:
    return LogisticRegression_minibatch(
        "breast_cancer", batch_size, size_test_set,
        use_own_batch_per_sample, device=device)


def make_german_credit_mb(batch_size, size_test_set,
                          use_own_batch_per_sample, device="cuda"
                          ) -> LogisticRegression_minibatch:
    return LogisticRegression_minibatch(
        "german_credit", batch_size, size_test_set,
        use_own_batch_per_sample, device=device)
