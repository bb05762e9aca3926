"""Bayesian neural-network posterior targets (the wine regressor).

(JAX counterpart: gmmvi_tpu/experiments/targets/bnn.py)

The network is an MLP evaluated from a flat weight vector; the minibatch
log-likelihood is scaled by the training-set size and the prior is a
zero-mean Gaussian.  Every parameter sample takes its own minibatch: a call
on N samples takes the next N batches of a host-side shuffled order (a
``np.random.RandomState`` seeded from ``hash(("bnn", dataset_seed))``, as
in the JAX package; the order reshuffles when the next batch would run past
the end of the data).  That cursor is host state, so the target is not
``safe_for_jit``: a step gives it the proposal's valid rows in a
power-of-two bucket, as the JAX package does, and both packages see the
same batches call for call within one process.

The forward pass runs batched over samples, ``[N, B, 11]`` inputs against
``[N, 11, 8]`` weights, in plain torch products (the JAX package computes
it outside any kernel too); gradients are autograd of the summed per-sample
posteriors.  The data and each call's batch indices live on the target's
device; only the shuffled order is made on the host.

The MNIST classifier (``BNN_MNIST``) is not ported: its data are not in the
repository.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from gmmvi_tpu_torch.device import resolve_device
from gmmvi_tpu_torch.experiments.targets import datasets as data_lib
from gmmvi_tpu_torch.experiments.targets.lnpdf import LNPDF


def _mlp_shapes(input_dim: int, hidden_units: Sequence[int], output_dim: int):
    shapes = []
    last = input_dim
    for width in hidden_units:
        shapes.append((last, width))
        shapes.append((width,))
        last = width
    shapes.append((last, output_dim))
    shapes.append((output_dim,))
    return shapes


def mlp_forward(weights: torch.Tensor, inputs: torch.Tensor, shapes,
                activations) -> torch.Tensor:
    """The MLP of every parameter sample: flat ``weights [N, P]`` (weight
    matrix then bias, layer by layer) on ``inputs`` ``[N, B, F]`` (a batch
    per sample) or ``[B, F]`` (one batch for all): ``[N, B, out]``."""
    n = weights.shape[0]
    out = inputs
    start = 0
    for layer, i in enumerate(range(0, len(shapes), 2)):
        w_shape, b_shape = shapes[i], shapes[i + 1]
        w_size = int(np.prod(w_shape))
        w = weights[:, start:start + w_size].reshape(n, *w_shape)
        start += w_size
        b = weights[:, start:start + b_shape[0]]
        start += b_shape[0]
        out = activations[layer](torch.matmul(out, w) + b[:, None, :])
    return out


def _identity(x):
    return x


class BNN_LNPDF(LNPDF):
    """A BNN posterior over the flat weights of an MLP regressing one
    output with a mean-squared-error loss (the JAX package's ``loss="mse"``;
    its cross-entropy classifier is MNIST's, not ported)."""

    def __init__(self, likelihood_scaling, dataset_seed, prior_std,
                 batch_size, hidden_units, activations, device="cuda"):
        super().__init__(safe_for_jit=False)
        self.device = resolve_device(device)
        self.likelihood_scaling = float(likelihood_scaling)
        self.dataset_seed = dataset_seed
        self.hidden_units = list(hidden_units)
        self.activations = activations
        self.batch_size = int(batch_size)

        (x_tr, y_tr), (x_te, y_te), (x_va, y_va), in_dim, out_dim = (
            self.prepare_data())

        def dev(a):
            return torch.as_tensor(a, device=self.device)

        self._x_tr, self._y_tr = dev(x_tr), dev(y_tr)
        self._x_te, self._y_te = dev(x_te), dev(y_te)
        self._x_va, self._y_va = dev(x_va), dev(y_va)
        self.train_size = len(x_tr)
        self.input_dim, self.output_dim = in_dim, out_dim
        self.shapes = _mlp_shapes(in_dim, self.hidden_units, out_dim)
        self._num_dimensions = int(sum(np.prod(s) for s in self.shapes))
        self.prior_std = float(prior_std)
        self._rng = np.random.RandomState(
            abs(hash(("bnn", dataset_seed))) % (2 ** 31))
        self._cursor = 0
        self._order = self._rng.permutation(self.train_size)

    def prepare_data(self):
        raise NotImplementedError

    def get_num_dimensions(self) -> int:
        return self._num_dimensions

    def _next_batches(self, n: int) -> np.ndarray:
        """``[n, batch_size]`` training rows: n consecutive batches of the
        shuffled order, one per parameter sample."""
        idx = np.empty((n, self.batch_size), np.int64)
        for i in range(n):
            if self._cursor + self.batch_size > self.train_size:
                self._order = self._rng.permutation(self.train_size)
                self._cursor = 0
            idx[i] = self._order[self._cursor:self._cursor + self.batch_size]
            self._cursor += self.batch_size
        return idx

    def _log_prior(self, x: torch.Tensor) -> torch.Tensor:
        return -0.5 * torch.sum(torch.square(x / self.prior_std), dim=-1)

    def _posterior(self, x: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
        """Each sample's posterior on its batch ``rows [N, B]``."""
        feats = self._x_tr[rows].to(x.dtype)
        labels = self._y_tr[rows].to(x.dtype)
        out = mlp_forward(x, feats, self.shapes, self.activations)
        loss = torch.mean(torch.square(out[..., 0] - labels), dim=-1)
        return self.likelihood_scaling * (-self.train_size * loss
                                          + self._log_prior(x))

    def log_density_and_grad(self, x: torch.Tensor
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
        rows = torch.as_tensor(self._next_batches(x.shape[0]),
                               device=self._x_tr.device)
        with torch.enable_grad():
            x = x.detach().requires_grad_(True)
            ld = self._posterior(x, rows)
            (grads,) = torch.autograd.grad(ld.sum(), x)
        return ld.detach(), grads

    def log_density(self, x: torch.Tensor) -> torch.Tensor:
        return self.log_density_and_grad(x)[0]

    def _bayesian_ensemble_loss(self, x, features, labels):
        """The network's output averaged over the parameter samples ``x``,
        then its loss and metric (RMSE) on ``features``/``labels``."""
        with torch.no_grad():
            out = torch.mean(mlp_forward(x, features.to(x.dtype),
                                         self.shapes, self.activations), 0)
            loss = torch.mean(torch.square(out[:, 0] - labels.to(x.dtype)))
        return float(loss), float(torch.sqrt(loss))

    def expensive_metrics(self, model_state, samples) -> dict:
        """Ensemble loss and metric of the first 64 samples on the test and
        the validation split."""
        x = samples[:min(64, samples.shape[0])]
        te_loss, te_metric = self._bayesian_ensemble_loss(x, self._x_te,
                                                          self._y_te)
        va_loss, va_metric = self._bayesian_ensemble_loss(x, self._x_va,
                                                          self._y_va)
        return {"bi_test_loss": te_loss, "bi_test_accuracy": te_metric,
                "bi_vali_loss": va_loss, "bi_vali_accuracy": va_metric}


class BNN_WINE(BNN_LNPDF):
    """11-8-8-1 sigmoid regressor, MSE loss; D = 177."""

    def __init__(self, dataset_seed, likelihood_scaling, prior_std,
                 batch_size, device="cuda"):
        super().__init__(
            likelihood_scaling=likelihood_scaling, prior_std=prior_std,
            batch_size=batch_size, dataset_seed=dataset_seed,
            hidden_units=[8, 8],
            activations=[torch.sigmoid, torch.sigmoid, _identity],
            device=device)

    def prepare_data(self):
        d = data_lib.load_wine_split(self.dataset_seed)
        return (
            (d["features_train"].astype(np.float32),
             d["labels_train"].astype(np.float32)),
            (d["features_test"].astype(np.float32),
             d["labels_test"].astype(np.float32)),
            (d["features_vali"].astype(np.float32),
             d["labels_vali"].astype(np.float32)),
            11, 1)

    def expensive_metrics(self, model_state, samples) -> dict:
        m = super().expensive_metrics(model_state, samples)
        m["bi_vali_rmse"] = m.pop("bi_vali_accuracy")
        return m


def make_WINE_target(likelihood_scaling, dataset_seed, prior_std,
                     batch_size, device="cuda") -> BNN_WINE:
    return BNN_WINE(dataset_seed, likelihood_scaling, prior_std, batch_size,
                    device=device)
