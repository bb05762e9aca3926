"""Marginal-comparison figures for mixture targets.

(JAX counterpart: gmmvi_tpu/experiments/evaluation/plotting.py)

A grid of per-dimension marginal densities: the target in blue, the learned
model in red.  matplotlib is imported inside the function only.
"""
from __future__ import annotations

import numpy as np
import torch


def marginal_comparison_figure(target, model_state, x_range, num_dims=20,
                               grid=(5, 4)):
    """Figure comparing the target's marginals with the model's on the
    first ``num_dims`` dimensions; ``target`` provides
    ``marginal_log_density(x, dim)``."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from gmmvi_tpu_torch.models import gmm as gmm_ops

    d = target.get_num_dimensions()
    num_dims = min(num_dims, d, grid[0] * grid[1])
    lo, hi = x_range
    x_vals = np.linspace(lo, hi, 1000).astype(np.float32)
    x_full = torch.as_tensor(np.tile(x_vals[:, None], (1, d)),
                             device=model_state.device)

    fig, axs = plt.subplots(*grid, sharex=True)
    fig.tight_layout(pad=0.2)
    axs = np.atleast_2d(axs)
    for dim in range(num_dims):
        true_d = torch.exp(target.marginal_log_density(x_full, dim)).cpu(
            ).numpy()
        vis = np.where(true_d > 1e-4)[0]
        if len(vis) == 0:
            continue
        start, end = vis.min(), vis.max()
        model_d = torch.exp(gmm_ops.marginal_log_density(
            model_state, x_full[start:end], dim)).cpu().numpy()
        ax = axs[dim // grid[1], dim % grid[1]]
        ax.plot(x_vals[start:end], true_d[start:end], color="b",
                linewidth=0.5)
        ax.plot(x_vals[start:end], model_d, color="r", linewidth=0.5)
        ax.tick_params(axis="y", direction="inout", pad=2, labelsize=5.0)
        ax.tick_params(axis="x", labelsize=5.0)
    return fig
