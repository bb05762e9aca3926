"""Target distribution interface.

(JAX counterpart: gmmvi_tpu/experiments/targets/lnpdf.py)

A target is called between the propose and update phases of a step.  Its
``safe_for_jit`` flag (the JAX package's name, the reference's
``safe_for_tf_graph``) decides which rows it sees: a target that is safe
(True, the default) is evaluated on every padded row of the proposal, as in
the JAX package's compiled step; one that is not (a target with host state,
such as a minibatch cursor, or a Python callable outside torch) is given only
the valid rows, compacted into a power-of-two bucket padded with row 0
(``GMMVI.train_iter``), so it sees the rows, in the order, that the JAX
package gives it.  A target with an analytic gradient overrides
:meth:`LNPDF.log_density_and_grad`; the default differentiates
:meth:`LNPDF.log_density` with autograd.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


class LNPDF:
    """Unnormalized target log-density interface."""

    _safe_for_jit = True

    def __init__(self, safe_for_jit: bool = True):
        self._safe_for_jit = safe_for_jit

    def log_density(self, x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def get_num_dimensions(self) -> int:
        raise NotImplementedError

    def log_density_and_grad(self, x: torch.Tensor
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Default: autograd through :meth:`log_density` (each sample's
        density depends on that sample alone, so the gradient of the sum is
        the per-sample gradient)."""
        with torch.enable_grad():
            x = x.detach().requires_grad_(True)
            ld = self.log_density(x)
            (grads,) = torch.autograd.grad(ld.sum(), x)
        return ld.detach(), grads

    def expensive_metrics(self, model_state, samples) -> dict:
        """Task-specific metrics for the runner's evaluations; none by
        default."""
        return {}

    @property
    def safe_for_jit(self) -> bool:
        return self._safe_for_jit


def detected_modes_metrics(target, model_state, x_range, grid) -> dict:
    """The runner metrics of a mixture target with modes at
    ``target.target_means``: the number of modes whose nearest learned mean
    lies within ||6 * 1||_2 and, with ``target.make_plots``, the figure of
    the marginals over ``x_range`` on a ``grid`` of axes."""
    active = int(model_state.num_active)
    means = model_state.means[:active].detach().cpu().numpy()
    dists = np.linalg.norm(
        target.target_means[:, None, :] - means[None, :, :], axis=2
    ).min(axis=1)
    threshold = np.linalg.norm(6.0 * np.ones(target.get_num_dimensions()))
    metrics = {"num_detected_modes": int(np.sum(dists < threshold))}
    if target.make_plots and target.get_num_dimensions() >= 2:
        from gmmvi_tpu_torch.experiments.evaluation.plotting import \
            marginal_comparison_figure

        metrics["marginals"] = marginal_comparison_figure(
            target, model_state, x_range, grid=grid)
    return metrics
