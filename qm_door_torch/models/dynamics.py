"""Centroidal quantities of the rigid-body model (port of the CMM part of
qm_door_tpu/models/dynamics.py).

Centroidal momentum matrix (CMM) about the robot com, world axes
(Orin/Wensing construction, assembled from subtree aggregates):
    A_lin = sum_i m_i Jc_i,
    A_ang = sum_i [ I_i^w Jw_i + m_i skew(c_i - c) Jc_i ].
Functions take q with any leading batch dims.
"""
from __future__ import annotations

import numpy as np
import torch

from . import spatial
from .kinematics import fk, joint_world_axes, point_jacobian
from .model import RobotModel


def body_com_kinematics(model: RobotModel, q):
    """World com positions (...,19,3), world inertias about com (...,19,3,3),
    and com-point Jacobians (...,19,6,24)."""
    axes, origins, (R, p) = joint_world_axes(model, q)
    coms = spatial.fmv(R, model.body_com) + p
    Iw = spatial.fmm(spatial.fmm(R, model.body_inertia), R.transpose(-1, -2))
    Js = [point_jacobian(model, q, b, coms[..., b, :], (axes, origins))
          for b in range(model.nj + 1)]
    return coms, Iw, torch.stack(Js, dim=-3)


def com_position(model: RobotModel, q):
    R, p = fk(model, q)
    coms = spatial.fmv(R, model.body_com) + p
    m = model.body_mass
    return torch.sum(m[:, None] * coms, dim=-2) / torch.sum(m)


def _subtree_table(joint_parent) -> np.ndarray:
    """(nj, nb) static 0/1 table: body b is in the subtree of joint j."""
    nj = len(joint_parent)
    table = np.zeros((nj, nj + 1), dtype=bool)
    for i in range(nj):
        j = i
        while True:
            table[j, 1 + i] = True
            parent_body = joint_parent[j]
            if parent_body == 0:
                break
            j = parent_body - 1
    return table


def _reverse_topological(joint_parent) -> tuple:
    """Body indices 1..nb-1 ordered leaves-first (child before parent).

    URDF joint order places parent_body < child_body, so descending index is
    a valid reverse-topological order; the invariant is checked."""
    nj = len(joint_parent)
    for i in range(nj):
        if joint_parent[i] >= 1 + i:
            raise ValueError("joint order must place parents first")
    return tuple(range(nj, 0, -1))


def centroidal_momentum_matrix(model: RobotModel, q):
    """(...,6,24) CMM A(q): h = A v, h = [linear momentum; angular momentum
    about the com], world axes (pinocchio ccrba equivalent)."""
    axes, origins, (R, p) = joint_world_axes(model, q)
    return cmm_from_fk(model, q, axes, origins, R, p)


def cmm_from_fk(model: RobotModel, q, axes, origins, R, p):
    """CMM assembly from precomputed FK."""
    m = model.body_mass
    coms = spatial.fmv(R, model.body_com) + p                       # (...,19,3)
    Iw = spatial.fmm(spatial.fmm(R, model.body_inertia), R.transpose(-1, -2))
    eye = torch.eye(3, dtype=q.dtype, device=q.device)
    # per-body inertia about the world origin
    cc = torch.sum(coms * coms, dim=-1)
    I_origin = Iw + m[:, None, None] * (
        cc[..., None, None] * eye - coms[..., :, None] * coms[..., None, :])
    s_body = m[:, None] * coms                                      # (...,19,3)

    # subtree aggregates by suffix accumulation along the tree (leaves first)
    parents = tuple(model.joint_parent)
    nj = len(parents)
    sub_m = [m[b] for b in range(nj + 1)]
    sub_s = [s_body[..., b, :] for b in range(nj + 1)]
    sub_J = [I_origin[..., b, :, :] for b in range(nj + 1)]
    for b in _reverse_topological(parents):
        pb = parents[b - 1]  # parent body of body b
        if pb != 0:          # joint aggregates never need the base body's row
            sub_m[pb] = sub_m[pb] + sub_m[b]
            sub_s[pb] = sub_s[pb] + sub_s[b]
            sub_J[pb] = sub_J[pb] + sub_J[b]
    M_sub = torch.stack([sub_m[1 + j] for j in range(nj)])           # (18,)
    s_sub = torch.stack([sub_s[1 + j] for j in range(nj)], dim=-2)   # (...,18,3)
    J_sub = torch.stack([sub_J[1 + j] for j in range(nj)], dim=-3)   # (...,18,3,3)

    # joint columns about the origin
    lever = s_sub - M_sub[:, None] * origins
    P_cols = spatial.cross(axes, lever)                 # (...,18,3)
    so = torch.sum(s_sub * origins, dim=-1)
    L_cols = (
        spatial.fmv(J_sub, axes)
        - so[..., None] * axes
        + origins * torch.sum(s_sub * axes, dim=-1)[..., None]
    )

    # base columns: translation then euler-rate rotation about base origin
    M_tot = torch.sum(m)
    s_tot = torch.sum(s_body, dim=-2)
    J_tot = torch.sum(I_origin, dim=-3)
    ET = spatial.zyx_rates_to_world_angvel_matrix(q[..., 3:6]).transpose(-1, -2)
    base_p = q[..., 0:3]
    P_rot = spatial.cross(
        ET, (s_tot - M_tot * base_p)[..., None, :])           # rows per col
    so_b = torch.sum(s_tot * base_p, dim=-1)
    L_rot = (
        spatial.fmm(ET, J_tot.transpose(-1, -2))
        - so_b[..., None, None] * ET
        + base_p[..., None, :] * spatial.fmv(ET, s_tot)[..., :, None]
    )

    P = torch.cat([(M_tot * eye).expand_as(P_rot), P_rot.transpose(-1, -2),
                   P_cols.transpose(-1, -2)], dim=-1)                 # (...,3,24)
    L_O = torch.cat([spatial.skew(s_tot), L_rot.transpose(-1, -2),
                     L_cols.transpose(-1, -2)], dim=-1)
    # shift the momentum reference from the world origin to the com
    com = s_tot / M_tot
    L = L_O - spatial.fmm(spatial.skew(com), P)
    return torch.cat([P, L], dim=-2)
