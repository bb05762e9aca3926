"""Planar-robot inverse-kinematics target.

(JAX counterpart: gmmvi_tpu/experiments/targets/planar_robot.py)

A 10-link planar arm of unit links; prior N(0, diag(1, 0.2^2, ...)) over
the joint angles; likelihood the largest over the goals of the Gaussian
density (sigma 1e-2) of the end effector's position.  Forward kinematics
is a cumulative sum of the angles and a sum of their cosines and sines.
Its ``use_log_density_and_grad`` is False, as in the JAX package: the
gradient is autograd through :meth:`PlanarRobot.log_density`
(``LNPDF.log_density_and_autograd``).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from portbench.reference.device import resolve_device
from portbench.reference.experiments.targets.lnpdf import LNPDF

LOG_2PI = math.log(2.0 * math.pi)


class PlanarRobot(LNPDF):
    """``num_links`` links reaching for 1 or 4 goals at distance 7."""

    def __init__(self, num_links: int, num_goals: int,
                 prior_std: float = 2e-1, likelihood_std: float = 1e-2,
                 device="cuda", dtype=torch.float32):
        super().__init__(use_log_density_and_grad=False, safe_for_jit=True)
        self.device = resolve_device(device)
        self.dtype = dtype
        f32 = dict(dtype=dtype, device=self.device)
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
        theta = torch.as_tensor(theta, dtype=self.dtype,
                                device=self.device)
        return self._log_prior(theta) + self.likelihood(
            self.forward_kinematics(theta))


def make_single_goal(device="cuda", dtype=torch.float32) -> PlanarRobot:
    return PlanarRobot(10, 1, device=device, dtype=dtype)


def make_four_goal(device="cuda", dtype=torch.float32) -> PlanarRobot:
    return PlanarRobot(10, 4, device=device, dtype=dtype)
