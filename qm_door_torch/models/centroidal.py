"""Centroidal model: state/input layout, pinocchio-chart mapping, flow map
(port of qm_door_tpu/models/centroidal.py).

State x (30): [ h_com/m : vcom(3), L/m(3) ;  base pose: pos(3), zyx(3) ; q_j(18) ]
Input u (30): [ contact forces LF,RF,LH,RH (12) ; joint velocities (18) ]
Force-tracking input u (36): the 30 above, then the EE wrench (6).

rbdState (55): [ zyx euler(3); base pos(3); q_j(18); omega_world(3);
  v_base world(3); qdot_j(18); ee pos(3); ee quat xyzw(4) ].

Functions take (x, u) with any leading batch dims.
"""
from __future__ import annotations

import torch

from . import spatial
from .dynamics import centroidal_momentum_matrix, com_position
from .kinematics import contact_positions, ee_pose
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


def ee_wrench(u):
    """Force-tracking input extension: EE wrench [force(3); torque(3)],
    appended to the 30 inputs so every 30-dim accessor stays valid."""
    return u[..., 30:36]


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


def flow_map_ft(model: RobotModel, x, u):
    """Force-tracking flow map: the EE wrench [F_ee; tau_ee] (u (36)) acts at
    the arm EE frame as a 5th contact, adding F_ee/m to the linear momentum
    rate and (cross(p_ee - com, F_ee) + tau_ee)/m to the angular rate."""
    q = pinocchio_q(x)
    m = torch.sum(model.body_mass)
    F = contact_forces(u)
    W = ee_wrench(u)
    p_c = contact_positions(model, q)
    com = com_position(model, q)
    _, p_ee = ee_pose(model, q)
    lin = (torch.sum(F, dim=-2) + W[..., 0:3]) / m
    hdot_lin = torch.cat([lin[..., :2], lin[..., 2:] - GRAVITY], dim=-1)
    hdot_ang = (torch.sum(spatial.cross(p_c - com[..., None, :], F), dim=-2)
                + spatial.cross(p_ee - com, W[..., 0:3]) + W[..., 3:6]) / m
    v_b = base_velocity(model, x, u)
    return torch.cat([hdot_lin, hdot_ang, v_b, joint_velocities(u)], dim=-1)


def flow_map_any(model: RobotModel, x, u):
    """Dispatch on the input width: 30 -> nominal, 36 -> with the EE wrench."""
    return flow_map_ft(model, x, u) if u.shape[-1] == 36 else flow_map(model, x, u)


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


# --- rbd state conversions ------------------------------------------------

def rbd_to_generalized(rbd):
    """rbdState (...,55) -> (q (...,24), v (...,24)) in the model chart
    (WbcBase::updateMeasured)."""
    zyx = rbd[..., 0:3]
    q = torch.cat([rbd[..., 3:6], zyx, rbd[..., 6:24]], dim=-1)
    euler_rates = spatial.world_angvel_to_zyx_rates(zyx, rbd[..., 24:27])
    v = torch.cat([rbd[..., 27:30], euler_rates, rbd[..., 30:48]], dim=-1)
    return q, v


def centroidal_state_from_rbd(model: RobotModel, rbd):
    """rbdState (...,55) -> centroidal state x (...,30)
    (CentroidalModelRbdConversions::computeCentroidalStateFromRbdModel)."""
    q, v = rbd_to_generalized(rbd)
    h_norm = spatial.fmv(centroidal_momentum_matrix(model, q), v) / torch.sum(model.body_mass)
    return torch.cat([h_norm, q], dim=-1)


def rbd_from_generalized(model: RobotModel, q, v):
    """(q, v) -> rbdState (...,55) including the FK'd EE pose
    (StateEstimateBase::updateArmEE)."""
    zyx = q[..., 3:6]
    omega_w = spatial.zyx_rates_to_world_angvel(zyx, v[..., 3:6])
    R_ee, p_ee = ee_pose(model, q)
    quat = spatial.rot_to_quat(R_ee)
    return torch.cat([zyx, q[..., 0:3], q[..., 6:24], omega_w, v[..., 0:3], v[..., 6:24],
                      p_ee, quat], dim=-1)
