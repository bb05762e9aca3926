"""Minimal URDF parsing and batched forward kinematics in torch.

(JAX counterpart: gmmvi_tpu/experiments/targets/urdf.py)

The URDF is parsed once on the host (``xml`` and numpy) into per-segment
fixed transforms, joint axes as skew matrices for Rodrigues' formula, the
actuated joints' indices and the links' masses and centres of mass.  The
forward pass is a chain of small batched ``[B, 3, 3]`` products over the
segments, differentiable by autograd; its constants are tensors on the
device the tree was built for (in the samples' float type at each call).

Supports the URDF subset the Talos model uses: ``revolute`` (also treated
as ``continuous``) and ``fixed`` joints, ``<origin xyz rpy>``, ``<axis>``,
``<limit lower upper>`` and ``<inertial><origin xyz/><mass/></inertial>``.
"""
from __future__ import annotations

import xml.etree.ElementTree as ET
from typing import Dict, List, NamedTuple, Tuple

import numpy as np
import torch

from gmmvi_tpu_torch.device import resolve_device


def _floats(s: str | None, default=(0.0, 0.0, 0.0)) -> np.ndarray:
    if s is None:
        return np.asarray(default, np.float64)
    return np.asarray([float(v) for v in s.split()], np.float64)


def rpy_matrix(rpy: np.ndarray) -> np.ndarray:
    """URDF fixed-axis roll-pitch-yaw: R = Rz(y) @ Ry(p) @ Rx(r)."""
    r, p, y = rpy
    cr, sr = np.cos(r), np.sin(r)
    cp, sp = np.cos(p), np.sin(p)
    cy, sy = np.cos(y), np.sin(y)
    rx = np.array([[1, 0, 0], [0, cr, -sr], [0, sr, cr]])
    ry = np.array([[cp, 0, sp], [0, 1, 0], [-sp, 0, cp]])
    rz = np.array([[cy, -sy, 0], [sy, cy, 0], [0, 0, 1]])
    return rz @ ry @ rx


class Segment(NamedTuple):
    """One edge of the kinematic tree (joint + child link)."""

    joint_name: str
    child_link: str
    parent_idx: int          # node index of the parent link
    origin_rot: np.ndarray   # [3, 3] fixed rotation (joint <origin rpy>)
    origin_pos: np.ndarray   # [3]    fixed translation (joint <origin xyz>)
    axis: np.ndarray         # [3]    rotation axis (unit), zeros if fixed
    q_index: int             # index into the actuated-joint vector, -1 = fixed
    mass: float              # child-link mass (0 when no inertial)
    com: np.ndarray          # [3] child-link CoM offset in the link frame


class KinematicTree:
    """A rooted tree of :class:`Segment` s covering the paths from ``root``
    to the named ``tips``, in chain order (the tips' paths one after the
    other, each joint on its first visit; actuated joints numbered in that
    order)."""

    def __init__(self, urdf_path: str, root: str, tips: Dict[str, str],
                 device="cuda"):
        xml_root = ET.parse(urdf_path).getroot()

        joints = {}
        child_to_joint = {}
        for j in xml_root.findall("joint"):
            name = j.get("name")
            child = j.find("child").get("link")
            origin = j.find("origin")
            limit = j.find("limit")
            joints[name] = {
                "type": j.get("type"),
                "parent": j.find("parent").get("link"),
                "child": child,
                "xyz": _floats(origin.get("xyz") if origin is not None
                               else None),
                "rpy": _floats(origin.get("rpy") if origin is not None
                               else None),
                "axis": _floats(
                    j.find("axis").get("xyz") if j.find("axis") is not None
                    else None, (1.0, 0.0, 0.0)),
                "limits": (
                    (float(limit.get("lower", "0")),
                     float(limit.get("upper", "0")))
                    if limit is not None else (0.0, 0.0)),
            }
            child_to_joint[child] = name

        link_inertia = {}
        for link in xml_root.findall("link"):
            inertial = link.find("inertial")
            if inertial is None:
                link_inertia[link.get("name")] = (0.0, np.zeros(3))
            else:
                mass = float(inertial.find("mass").get("value"))
                io = inertial.find("origin")
                com = _floats(io.get("xyz") if io is not None else None)
                link_inertia[link.get("name")] = (mass, com)

        paths: Dict[str, List[str]] = {}
        for tip_name, tip_link in tips.items():
            path = []
            cur = tip_link
            while cur != root:
                jn = child_to_joint[cur]
                path.append(jn)
                cur = joints[jn]["parent"]
            paths[tip_name] = list(reversed(path))

        self.root = root
        self.segments: List[Segment] = []
        self.node_index: Dict[str, int] = {root: 0}
        self.actuated_joint_names: List[str] = []
        self.joint_limits_list: List[Tuple[float, float]] = []
        seen_joints = set()
        for tip_name in tips:
            for jn in paths[tip_name]:
                if jn in seen_joints:
                    continue
                seen_joints.add(jn)
                info = joints[jn]
                kind = info["type"]
                if kind in ("revolute", "continuous"):
                    q_index = len(self.actuated_joint_names)
                    self.actuated_joint_names.append(jn)
                    self.joint_limits_list.append(info["limits"])
                    axis = info["axis"] / np.linalg.norm(info["axis"])
                elif kind == "fixed":
                    q_index = -1
                    axis = np.zeros(3)
                else:
                    raise ValueError(
                        f"unsupported joint type {kind!r} for {jn!r} "
                        "(only revolute/continuous/fixed)")
                mass, com = link_inertia.get(info["child"],
                                             (0.0, np.zeros(3)))
                self.segments.append(Segment(
                    joint_name=jn, child_link=info["child"],
                    parent_idx=self.node_index[info["parent"]],
                    origin_rot=rpy_matrix(info["rpy"]),
                    origin_pos=info["xyz"], axis=axis, q_index=q_index,
                    mass=mass, com=com))
                self.node_index[info["child"]] = len(self.segments)

        self.tip_nodes = {n: self.node_index[l] for n, l in tips.items()}
        self.nb_joint = len(self.actuated_joint_names)
        root_mass, root_com = link_inertia.get(root, (0.0, np.zeros(3)))
        self.root_mass = root_mass
        self.root_com = root_com
        self.joint_limits = np.asarray(self.joint_limits_list, np.float32)

        skews = []
        for s in self.segments:
            ax, ay, az = s.axis
            skews.append(np.array([[0, -az, ay], [az, 0, -ax],
                                   [-ay, ax, 0]]))
        consts = {
            "origin_rot": np.stack([s.origin_rot for s in self.segments]),
            "origin_pos": np.stack([s.origin_pos for s in self.segments]),
            "masses": [s.mass for s in self.segments],
            "coms": np.stack([s.com for s in self.segments]),
            "skew": np.stack(skews),
            "skew2": np.stack([k @ k for k in skews]),
            "root_com": root_com,
        }
        self.device = resolve_device(device)
        # float32 constants, as the JAX package keeps them
        self._consts = {
            k: torch.as_tensor(np.asarray(v, np.float32), device=self.device)
            for k, v in consts.items()}
        self._total_mass = float(root_mass + sum(s.mass
                                                 for s in self.segments))

    def constants(self, dtype: torch.dtype) -> dict:
        """The forward pass's constants in ``dtype`` (the float32 values,
        cast exactly)."""
        return {k: v.to(dtype) for k, v in self._consts.items()}

    @property
    def mean_pose(self) -> np.ndarray:
        """Midpoint of the joint limits per actuated joint."""
        return self.joint_limits.mean(axis=1)

    def fk(self, q: torch.Tensor, base_pos: torch.Tensor,
           base_rot: torch.Tensor):
        """Batched forward kinematics from ``q [B, nb_joint]``, the
        floating base's position ``[B, 3]`` and rotation ``[B, 3, 3]``:
        ``(positions [B, S+1, 3], rotations [B, S+1, 3, 3])`` of every link
        frame in world coordinates, node 0 the root.  Each actuated joint
        turns by Rodrigues' formula R = I + sin(t) K + (1 - cos(t)) K^2."""
        c = self.constants(q.dtype)
        eye = torch.eye(3, dtype=q.dtype, device=q.device)
        pos = [base_pos]
        rot = [base_rot]
        for i, seg in enumerate(self.segments):
            p_par, r_par = pos[seg.parent_idx], rot[seg.parent_idx]
            p = p_par + r_par @ c["origin_pos"][i]
            r = r_par @ c["origin_rot"][i]
            if seg.q_index >= 0:
                theta = q[:, seg.q_index, None, None]
                r = r @ (eye + torch.sin(theta) * c["skew"][i]
                         + (1.0 - torch.cos(theta)) * c["skew2"][i])
            pos.append(p)
            rot.append(r)
        return torch.stack(pos, dim=1), torch.stack(rot, dim=1)

    def tip_pose(self, positions, rotations, name: str) -> torch.Tensor:
        """``[B, 12]`` pose ``[x y z, R.flatten()]`` of a named tip."""
        i = self.tip_nodes[name]
        return torch.cat([positions[:, i],
                          rotations[:, i].reshape(-1, 9)], dim=-1)

    def com(self, positions, rotations) -> torch.Tensor:
        """``[B, 3]`` mass-weighted centre of mass over the tree's links,
        each counted once, the root link included."""
        c = self.constants(positions.dtype)
        link_coms = positions[:, 1:] + torch.einsum(
            "bsij,sj->bsi", rotations[:, 1:], c["coms"])
        weighted = torch.einsum("bsi,s->bi", link_coms, c["masses"])
        root_com = positions[:, 0] + rotations[:, 0] @ c["root_com"]
        weighted = weighted + self.root_mass * root_com
        return weighted / self._total_mass


def rpy_matrix_batched(rpy: torch.Tensor) -> torch.Tensor:
    """:func:`rpy_matrix` over a batch: ``[B, 3] -> [B, 3, 3]``."""
    r, p, y = rpy[:, 0], rpy[:, 1], rpy[:, 2]
    cr, sr = torch.cos(r), torch.sin(r)
    cp, sp = torch.cos(p), torch.sin(p)
    cy, sy = torch.cos(y), torch.sin(y)
    row0 = torch.stack([cy * cp, cy * sp * sr - sy * cr,
                        cy * sp * cr + sy * sr], -1)
    row1 = torch.stack([sy * cp, sy * sp * sr + cy * cr,
                        sy * sp * cr - cy * sr], -1)
    row2 = torch.stack([-sp, cp * sr, cp * cr], -1)
    return torch.stack([row0, row1, row2], dim=-2)
