"""Planar-robot inverse-kinematics target.

(JAX counterpart: gmmvi_tpu/experiments/targets/planar_robot.py)

A 10-link planar arm of unit links; prior N(0, diag(1, 0.2^2, ...)) over
the joint angles; likelihood the largest over the goals of the Gaussian
density (sigma 1e-2) of the end effector's position.  Forward kinematics
is a cumulative sum of the angles and a sum of their cosines and sines.
The gradient is autograd through :meth:`PlanarRobot.log_density` (the
default of ``LNPDF``).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from gmmvi_tpu_torch.device import resolve_device
from gmmvi_tpu_torch.experiments.targets.lnpdf import LNPDF

LOG_2PI = math.log(2.0 * math.pi)


class PlanarRobot(LNPDF):
    """``num_links`` links reaching for 1 or 4 goals at distance 7."""

    def __init__(self, num_links: int, num_goals: int,
                 prior_std: float = 2e-1, likelihood_std: float = 1e-2,
                 device="cuda"):
        self.device = resolve_device(device)
        f32 = dict(dtype=torch.float32, device=self.device)
        self._num_dimensions = num_links
        prior_stds = prior_std * np.ones(num_links, np.float32)
        prior_stds[0] = 1.0
        self.prior_stds = torch.as_tensor(prior_stds, **f32)
        self.link_lengths = torch.ones(num_links, **f32)
        if num_goals == 1:
            goals = [[7.0, 0.0]]
        elif num_goals == 4:
            goals = [[7.0, 0.0], [-7.0, 0.0], [0.0, 7.0], [0.0, -7.0]]
        else:
            raise ValueError("num_goals must be 1 or 4")
        self.goals = torch.as_tensor(goals, **f32)
        self.likelihood_std = float(likelihood_std)

    def get_num_dimensions(self) -> int:
        return self._num_dimensions

    def forward_kinematics(self, theta: torch.Tensor) -> torch.Tensor:
        """End-effector positions ``[N, 2]`` from the joint angles."""
        angles = torch.cumsum(theta, dim=1)
        x = torch.sum(self.link_lengths * torch.cos(angles), dim=1)
        y = torch.sum(self.link_lengths * torch.sin(angles), dim=1)
        return torch.stack((x, y), dim=1)

    def _log_prior(self, theta: torch.Tensor) -> torch.Tensor:
        return torch.sum(-torch.log(self.prior_stds) - 0.5 * LOG_2PI
                         - 0.5 * torch.square(theta / self.prior_stds), dim=1)

    def likelihood(self, pos: torch.Tensor) -> torch.Tensor:
        """The largest over the goals of log N(pos; goal, sigma^2 I)."""
        s = self.likelihood_std
        d2 = torch.sum(torch.square(pos[:, None, :] - self.goals[None, :, :]),
                       dim=2)
        log_probs = -LOG_2PI - 2.0 * math.log(s) - 0.5 * d2 / (s * s)
        return torch.amax(log_probs, dim=1)

    def log_density(self, theta) -> torch.Tensor:
        theta = torch.as_tensor(theta, dtype=torch.float32,
                                device=self.device)
        return self._log_prior(theta) + self.likelihood(
            self.forward_kinematics(theta))

    def expensive_metrics(self, model_state, samples) -> dict:
        """Per goal, the modes found: the components whose mean puts the end
        effector within 0.05 of the goal with log density above -7,
        clustered by their first joint angle (a gap above 0.4 starts a new
        mode).  With matplotlib, also the figure of the arms."""
        active = int(model_state.num_active)
        means_t = model_state.means[:active].to(self.device)
        means = means_t.detach().cpu().numpy()
        pos = self.forward_kinematics(means_t).detach().cpu().numpy()
        good = self.log_density(means_t).detach().cpu().numpy() > -7.0
        goals = self.goals.cpu().numpy()
        metrics = {}
        for g in goals:
            err = np.linalg.norm(pos - g, axis=1)
            first_links = np.sort(means[(err < 0.05) & good, 0])
            n_modes = (0 if first_links.size == 0 else
                       1 + int(np.sum(np.diff(first_links) > 0.4)))
            metrics[f"num_detected_modes_[{g[0]}, {g[1]}]"] = n_modes
        try:
            import matplotlib
        except ImportError:   # metrics only
            return metrics
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        from gmmvi_tpu_torch.experiments.evaluation.visualize_planar_robot \
            import visualize_mixture

        fig = plt.figure()
        weights = model_state.weights[:active].detach().cpu().numpy()
        visualize_mixture(weights, means, goals=goals, ax=fig.gca())
        fig.tight_layout()
        metrics["mixture_plot"] = fig
        return metrics


def make_single_goal(device="cuda") -> PlanarRobot:
    return PlanarRobot(10, 1, device=device)


def make_four_goal(device="cuda") -> PlanarRobot:
    return PlanarRobot(10, 4, device=device)
