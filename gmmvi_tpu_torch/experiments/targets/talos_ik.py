"""The Talos humanoid inverse-kinematics target, and the host-target wrapper.

(JAX counterpart: gmmvi_tpu/experiments/targets/talos_ik.py)

:class:`HostLNPDF` makes a target of numpy callables: a target outside
torch (a robotics stack, a simulator), evaluated on the host.  It is not
``safe_for_jit``, so a step gives it only the proposal's valid rows, in a
power-of-two bucket (``GMMVI._eval_valid_rows``); its rows go to the host
as float32 numpy and its results come back as float32 tensors on the
samples' device.  That round trip is what a host target is.

:class:`Talos` is the 34-dimensional posterior over the robot's 28 joint
angles and its floating base (position and roll-pitch-yaw), from the
forward kinematics of ``talos_reduced.urdf`` (``urdf.py``) in torch.  It
supplies no gradient of its own (``use_log_density_and_grad`` False, as
in the JAX package): the optimizer differentiates its log density by
autograd (``LNPDF.log_density_and_autograd``).
"""
from __future__ import annotations

import math
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from gmmvi_tpu_torch.device import resolve_device
from gmmvi_tpu_torch.experiments.targets import datasets as data_lib
from gmmvi_tpu_torch.experiments.targets.lnpdf import LNPDF
from gmmvi_tpu_torch.experiments.targets.urdf import (KinematicTree,
                                                      rpy_matrix_batched)


class HostLNPDF(LNPDF):
    """A target of numpy callables.

    Parameters:
        num_dimensions: dimensionality of the target.
        log_density_fn: maps a numpy ``[N, D]`` array to ``[N]`` log
            densities.
        log_density_and_grad_fn: optionally maps ``[N, D]`` to ``([N],
            [N, D])``; required when a first-order estimator is used.
    """

    def __init__(
        self,
        num_dimensions: int,
        log_density_fn: Callable[[np.ndarray], np.ndarray],
        log_density_and_grad_fn: Optional[
            Callable[[np.ndarray], Tuple[np.ndarray, np.ndarray]]] = None,
    ):
        super().__init__(
            use_log_density_and_grad=log_density_and_grad_fn is not None,
            safe_for_jit=False)
        self._dims = int(num_dimensions)
        self._fn = log_density_fn
        self._grad_fn = log_density_and_grad_fn

    def get_num_dimensions(self) -> int:
        return self._dims

    @staticmethod
    def _to_host(x: torch.Tensor) -> np.ndarray:
        return x.detach().to(torch.float32).cpu().numpy()

    @staticmethod
    def _from_host(a, like: torch.Tensor) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, np.float32), device=like.device)

    def log_density(self, x: torch.Tensor) -> torch.Tensor:
        return self._from_host(self._fn(self._to_host(x)), x)

    def log_density_and_grad(self, x: torch.Tensor
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
        if self._grad_fn is None:
            raise NotImplementedError(
                "this host target supplies no gradients; use a zero-order "
                "estimator (MORE) or provide log_density_and_grad_fn")
        ld, grad = self._grad_fn(self._to_host(x))
        return self._from_host(ld, x), self._from_host(grad, x)

    # numpy callables have no autograd: a first-order estimator needs the
    # gradient callable (its flag is then True)
    log_density_and_autograd = log_density_and_grad


class Talos(LNPDF):
    """The 34-DoF Talos inverse-kinematics posterior.

    For a sample ``x = [q (28 joints), base position (3), base roll, pitch,
    yaw (3)]`` the log density is the sum of five experts: a soft-uniform
    prior within the joint limits (std 0.05), a soft-uniform bound on the
    xy offset of the centre of mass from the left foot (|.| < 0.14, std
    0.01), Gaussian pose rewards for both feet (position std 0.02, rotation
    entries std 0.1) and a Gaussian reward for the left gripper's position
    at ``context`` (std 0.02).
    """

    JOINT_LIMITS_STD = 0.05
    COM_LIMIT = 0.14
    COM_STD = 0.01
    GRIPPER_STD = 0.02
    FOOT_STD = [0.02] * 3 + [0.1] * 9
    LEFT_FOOT_TARGET = [-0.02, 0.09, -0.0,
                        1.0, 0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0, 1.0]
    RIGHT_FOOT_TARGET = [-0.02, -0.09, -0.0,
                         1.0, 0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0, 1.0]

    def __init__(self, context, device="cuda"):
        super().__init__(use_log_density_and_grad=False, safe_for_jit=True)
        self.device = resolve_device(device)
        self.tree = KinematicTree(
            str(data_lib.find("talos_reduced.urdf")), root="base_link",
            tips={"r_gripper": "gripper_right_base_link",
                  "l_gripper": "gripper_left_base_link",
                  "r_foot": "right_sole_link",
                  "l_foot": "left_sole_link"},
            device=self.device)
        assert self.tree.nb_joint == 28, self.tree.nb_joint
        self._dims = self.tree.nb_joint + 6
        # neutral configuration: the limits' midpoints, standing base height
        self.mean_joints = np.concatenate([
            self.tree.mean_pose, [0.0, 0.0, 1.08, 0.0, 0.0, 0.0]
        ]).astype(np.float32)

        def f32(a):
            return torch.as_tensor(np.asarray(a, np.float32),
                                   device=self.device)

        self.context = f32(context)
        self._limits = f32(self.tree.joint_limits)
        self._foot_std = f32(self.FOOT_STD)
        self._l_foot_t = f32(self.LEFT_FOOT_TARGET)
        self._r_foot_t = f32(self.RIGHT_FOOT_TARGET)

    def get_num_dimensions(self) -> int:
        return self._dims

    @staticmethod
    def _soft_uniform_log_prob(x, low, high, std, temp=1.0):
        """Sum over the last axis of log Phi((x - low) / std) + log
        Phi((high - x) / std): near 0 inside [low, high], falling smoothly
        outside."""
        lp = torch.special.log_ndtr((x - low) / std) \
            + torch.special.log_ndtr((high - x) / std)
        return temp * torch.sum(lp, dim=-1)

    @staticmethod
    def _diag_normal_log_prob(x, mean, std):
        """Normalized diagonal-Gaussian log density over the last axis."""
        z = (x - mean) / std
        return -0.5 * torch.sum(z * z, dim=-1) - torch.sum(torch.log(std)) \
            - 0.5 * x.shape[-1] * math.log(2.0 * math.pi)

    def _forward(self, x: torch.Tensor):
        nb = self.tree.nb_joint
        q = x[:, :nb]
        positions, rotations = self.tree.fk(q, x[:, nb:nb + 3],
                                            rpy_matrix_batched(x[:, -3:]))
        return q, positions, rotations

    def log_density(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of the five experts' log densities."""
        dt = x.dtype
        q, positions, rotations = self._forward(x)
        limits = self._limits.to(dt)
        rew = self._soft_uniform_log_prob(q, limits[:, 0], limits[:, 1],
                                          self.JOINT_LIMITS_STD)
        com_xy = self.tree.com(positions, rotations)[:, :2]
        l_foot = self.tree.tip_pose(positions, rotations, "l_foot")
        r_foot = self.tree.tip_pose(positions, rotations, "r_foot")
        l_gripper = self.tree.tip_pose(positions, rotations, "l_gripper")
        foot_std = self._foot_std.to(dt)
        rew = rew + self._soft_uniform_log_prob(
            com_xy - l_foot[:, :2], -self.COM_LIMIT, self.COM_LIMIT,
            self.COM_STD)
        rew = rew + self._diag_normal_log_prob(r_foot, self._r_foot_t.to(dt),
                                               foot_std)
        rew = rew + self._diag_normal_log_prob(l_foot, self._l_foot_t.to(dt),
                                               foot_std)
        rew = rew + self._diag_normal_log_prob(
            l_gripper[:, :3], self.context.to(dt),
            torch.tensor(self.GRIPPER_STD, dtype=dt, device=x.device))
        return rew

    def expensive_metrics(self, model_state, samples: torch.Tensor) -> dict:
        """Stick figures of up to 100 sampled configurations on the (x, z)
        and (y, z) planes, with the centres of mass, the feet's targets and
        the gripper's; ``{}`` where matplotlib does not import."""
        try:
            import matplotlib
            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
        except ImportError:
            return {}

        with torch.no_grad():
            _, positions, rotations = self._forward(samples[:100])
            coms = self.tree.com(positions, rotations).cpu().numpy()
        pos = positions.cpu().numpy()                    # [B, S+1, 3]
        parents = [s.parent_idx for s in self.tree.segments]
        ctx = self.context.cpu().numpy()
        fig, ax = plt.subplots(ncols=2, sharex=True, figsize=(15, 10))
        for i, dim in enumerate(([0, 2], [1, 2])):
            for b in range(pos.shape[0]):
                for child, par in enumerate(parents, start=1):
                    ax[i].plot(
                        [pos[b, par, dim[0]], pos[b, child, dim[0]]],
                        [pos[b, par, dim[1]], pos[b, child, dim[1]]],
                        color="k", alpha=0.2)
            ax[i].plot(coms[:, dim[0]], coms[:, dim[1]], "yx")
            ax[i].plot(self.LEFT_FOOT_TARGET[dim[0]],
                       self.LEFT_FOOT_TARGET[dim[1]], ls=" ", marker="s",
                       label="left_foot_target", color="red")
            ax[i].plot(self.RIGHT_FOOT_TARGET[dim[0]],
                       self.RIGHT_FOOT_TARGET[dim[1]], ls=" ", marker="s",
                       label="right_foot_target", color="green")
            ax[i].plot(ctx[dim[0]], ctx[dim[1]], ls=" ", marker="o",
                       markersize=6, label="left_gripper_target",
                       color="orange")
            ax[i].legend()
        return {"plot": fig}


class TalosLeftGripperTargetPdf:
    """Prior over reachable left-gripper targets in spherical coordinates,
    to sample IK contexts.  The polar angle's upper end is ``rad2deg(170)``
    radians, as in the reference."""

    def __init__(self):
        self.radius_low, self.radius_high = 0.2, 1.0
        self.xy_low, self.xy_high = -np.pi / 2, np.pi / 2
        self.z_low = float(np.deg2rad(10))
        self.z_high = float(np.rad2deg(170))

    def transform(self, u_xy: torch.Tensor, u_rad: torch.Tensor,
                  u_z: torch.Tensor) -> torch.Tensor:
        """``[n, 3]`` targets from three ``[n]`` uniforms in [0, 1): each
        range's ends in the uniforms' float type, ``u (high - low) + low``
        rounded once (a fused multiply-add) and at least ``low``, as
        ``jax.random.uniform`` maps them on the CPU (the polar angle
        reaches ~1e4 radians, where one rounding more moves its sine by
        1e-3)."""
        def scaled(u, low, high):
            low, high = (torch.tensor(v, dtype=u.dtype, device=u.device)
                         for v in (low, high))
            wide = u.double() * (high - low).double() + low.double()
            return torch.maximum(low, wide.to(u.dtype))

        xy_ang = scaled(u_xy, self.xy_low, self.xy_high)
        rad = scaled(u_rad, self.radius_low, self.radius_high)
        z_ang = scaled(u_z, self.z_low, self.z_high)
        x = rad * torch.sin(z_ang) * torch.cos(xy_ang)
        y = rad * torch.sin(z_ang) * torch.sin(xy_ang)
        z = rad * torch.cos(z_ang)
        return torch.stack([x, y, z], dim=-1)

    def sample(self, generator: torch.Generator, n: int) -> torch.Tensor:
        dev = generator.device
        u = torch.rand((3, n), generator=generator, device=dev)
        return self.transform(u[0], u[1], u[2])


def make_talos_target(context, device="cuda") -> Talos:
    """The Talos IK posterior with the left gripper's target ``context``
    (x, y, z)."""
    return Talos(context, device=device)
