"""Centroidal model: state/input layout, pinocchio-chart mapping, flow map
(port of qm_door_tpu/models/centroidal.py for the 30-input problem).

State x (30): [ h_com/m : vcom(3), L/m(3) ;  base pose: pos(3), zyx(3) ; q_j(18) ]
Input u (30): [ contact forces LF,RF,LH,RH (12) ; joint velocities (18) ]

Functions take (x, u) with any leading batch dims.
"""
from __future__ import annotations

import torch

from . import spatial
from .dynamics import centroidal_momentum_matrix, com_position
from .kinematics import contact_positions
from .model import GRAVITY, RobotModel


def normalized_momentum(x):
    return x[..., 0:6]


def base_pose(x):
    return x[..., 6:12]


def joint_angles(x):
    return x[..., 12:30]


def contact_forces(u):
    return u[..., 0:12].reshape(*u.shape[:-1], 4, 3)


def joint_velocities(u):
    return u[..., 12:30]


def pinocchio_q(x):
    """Centroidal state -> generalized coordinates q (24)."""
    return x[..., 6:30]


def _base_velocity_from_cmm(model: RobotModel, A, x, u):
    m = torch.sum(model.body_mass)
    rhs = m * normalized_momentum(x) - spatial.fmv(A[..., :, 6:], joint_velocities(u))
    return spatial.solve6_block(A[..., :, :6], rhs)


def base_velocity(model: RobotModel, x, u):
    """Floating-base generalized velocity [v_world; zyx rates] from momentum:
    v_b = A_b^{-1} (m h_norm - A_j v_j)."""
    A = centroidal_momentum_matrix(model, pinocchio_q(x))
    return _base_velocity_from_cmm(model, A, x, u)


def pinocchio_v(model: RobotModel, x, u):
    """Centroidal (state, input) -> generalized velocity v (24)."""
    return torch.cat([base_velocity(model, x, u), joint_velocities(u)], dim=-1)


def flow_map(model: RobotModel, x, u):
    """xdot = f(x, u): the centroidal dynamics flow map."""
    q = pinocchio_q(x)
    m = torch.sum(model.body_mass)
    F = contact_forces(u)
    p_c = contact_positions(model, q)
    com = com_position(model, q)
    lin = torch.sum(F, dim=-2) / m
    # + gravity (0, 0, -g): only the z row changes
    hdot_lin = torch.cat([lin[..., :2], lin[..., 2:] - GRAVITY], dim=-1)
    hdot_ang = torch.sum(
        spatial.cross(p_c - com[..., None, :], F), dim=-2) / m
    v_b = base_velocity(model, x, u)
    return torch.cat([hdot_lin, hdot_ang, v_b, joint_velocities(u)], dim=-1)


def flow_map_any(model: RobotModel, x, u):
    """Dispatch on the input width: 30 -> nominal. The 36-input
    force-tracking flow map is not ported yet."""
    if u.shape[-1] != 30:
        raise NotImplementedError(
            f"input width {u.shape[-1]}: only the 30-input problem is ported")
    return flow_map(model, x, u)


def weight_compensating_input(model: RobotModel, contact_flags, dtype=None):
    """Nominal input (..., 30): gravity split equally among stance feet, zero
    joint velocity (ocs2_legged_robot weightCompensatingInput)."""
    if dtype is None:
        dtype = model.dtype
    flags = torch.as_tensor(contact_flags, dtype=dtype, device=model.device)
    n_stance = torch.clamp(torch.sum(flags, dim=-1, keepdim=True), min=1.0)
    fz = torch.sum(model.body_mass) * GRAVITY / n_stance
    zeros = torch.zeros_like(flags)
    F = torch.stack([zeros, zeros, flags * fz], dim=-1)   # (...,4,3)
    return torch.cat([F.reshape(*flags.shape[:-1], 12),
                      torch.zeros(*flags.shape[:-1], 18, dtype=dtype,
                                  device=flags.device)], dim=-1)
