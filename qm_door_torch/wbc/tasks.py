"""WBC task formulations (port of qm_door_tpu/wbc/tasks.py;
qm_wbc/src/WbcBase.cpp replacement).

Decision variables x = [qddot (24); F (12)], n = 36. Every task is a pure
function of a :class:`WbcData`; contact-dependent rows are masked, never
reshaped. Everything is batch-native: the data's fields and the tasks'
leaves carry the same leading batch dims (none for one robot), and the
task build has no data-dependent Python branch, so it also runs under
``torch.func.vmap``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from ..models import centroidal, dynamics, kinematics, spatial
from ..models.model import RobotModel
from .hoqp import Task

N_DEC = 36
NQ = 24


@dataclass(frozen=True)
class WbcData:
    """Everything the task formulations need (one WBC tick); each field
    carries the batch dims first."""

    contact_flags: torch.Tensor    # (4,)
    # measured
    q_meas: torch.Tensor           # (24,)
    v_meas: torch.Tensor           # (24,)
    M: torch.Tensor                # (24,24) mass matrix
    nle: torch.Tensor              # (24,)
    Jc: torch.Tensor               # (12,24) stacked foot linear Jacobians
    dJc: torch.Tensor              # (12,24)
    base_J: torch.Tensor           # (6,24)
    base_dJ: torch.Tensor          # (6,24)
    arm_J: torch.Tensor            # (6,24) EE frame
    arm_dJ: torch.Tensor           # (6,24)
    foot_pos_meas: torch.Tensor    # (4,3)
    foot_vel_meas: torch.Tensor    # (4,3)
    ee_pos_meas: torch.Tensor      # (3,)
    ee_vel_meas: torch.Tensor      # (6,) [lin; ang]
    ee_rot_meas: torch.Tensor      # (3,3)
    # desired
    q_des: torch.Tensor            # (24,)
    v_des: torch.Tensor            # (24,)
    base_acc_des: torch.Tensor     # (6,) [lin; euler-rate dot]
    foot_pos_des: torch.Tensor     # (4,3)
    foot_vel_des: torch.Tensor     # (4,3)
    ee_pos_des: torch.Tensor
    ee_vel_des: torch.Tensor       # (6,)
    ee_rot_des: torch.Tensor
    force_des: torch.Tensor        # (12,) MPC contact forces
    torque_limits: torch.Tensor    # (18,)
    wrench_des: Optional[torch.Tensor] = None  # (6,) MPC EE wrench (force tracking)


def build_wbc_data(model: RobotModel, state_desired, input_desired, rbd_measured,
                   contact_flags, input_last, period) -> WbcData:
    """updateMeasured + updateDesired (WbcBase.cpp:146-238): state_desired
    (...,30), input_desired and input_last (...,nu) with nu 30 or 36,
    rbd_measured (...,55), contact_flags (...,4)."""
    q_meas, v_meas = centroidal.rbd_to_generalized(rbd_measured)
    batch = q_meas.shape[:-1]

    M = dynamics.mass_matrix(model, q_meas)
    nle = dynamics.nonlinear_effects(model, q_meas, v_meas)

    foot_ids = model.contact_frame_ids
    Jfeet = kinematics.frame_jacobians(model, q_meas, foot_ids)      # (...,4,6,24)
    dJfeet = kinematics.frame_jacobians_dot(model, q_meas, v_meas, foot_ids)
    Jc = Jfeet[..., :3, :].reshape(*batch, 12, NQ)
    dJc = dJfeet[..., :3, :].reshape(*batch, 12, NQ)

    ba_ids = (model.base_frame_id, model.ee_frame_id)
    Jba = kinematics.frame_jacobians(model, q_meas, ba_ids)
    dJba = kinematics.frame_jacobians_dot(model, q_meas, v_meas, ba_ids)

    Rf_m, pf_m = kinematics.frame_placements(model, q_meas)
    foot_pos_meas = torch.stack([pf_m[..., i, :] for i in foot_ids], dim=-2)
    foot_vel_meas = spatial.fmv(Jfeet[..., :3, :], v_meas[..., None, :])
    ee = model.ee_frame_id
    arm_J = Jba[..., 1, :, :]

    # desired side (FK at the MPC optimal state/input)
    q_des = centroidal.pinocchio_q(state_desired)
    v_des = centroidal.pinocchio_v(model, state_desired, input_desired)
    Rf_d, pf_d = kinematics.frame_placements(model, q_des)
    Jfeet_d = kinematics.frame_jacobians(model, q_des, foot_ids)
    Jee_d = kinematics.frame_jacobians(model, q_des, (ee,))[..., 0, :, :]

    # desired base acceleration from the centroidal momentum rate
    # (WbcBase::updateDesired, WbcBase.cpp:225-238)
    m_tot = torch.sum(model.body_mass)
    joint_acc = (input_desired[..., 12:30] - input_last[..., 12:30]) / period
    A = dynamics.centroidal_momentum_matrix(model, q_des)
    Adot = dynamics.centroidal_momentum_matrix_dot(model, q_des, v_des)
    h_norm_rate = centroidal.flow_map_any(model, state_desired, input_desired)[..., 0:6]
    rate = m_tot * h_norm_rate - spatial.fmv(Adot, v_des) - spatial.fmv(A[..., :, 6:], joint_acc)
    base_acc_des = spatial.solve6_block(A[..., :, :6], rate)

    if input_desired.shape[-1] == 36:
        wrench_des = input_desired[..., 30:36]
    else:
        wrench_des = torch.zeros(*batch, 6, dtype=q_meas.dtype, device=q_meas.device)
    return WbcData(
        contact_flags=contact_flags,
        q_meas=q_meas, v_meas=v_meas, M=M, nle=nle, Jc=Jc, dJc=dJc,
        base_J=Jba[..., 0, :, :], base_dJ=dJba[..., 0, :, :], arm_J=arm_J,
        arm_dJ=dJba[..., 1, :, :],
        foot_pos_meas=foot_pos_meas, foot_vel_meas=foot_vel_meas,
        ee_pos_meas=pf_m[..., ee, :], ee_vel_meas=spatial.fmv(arm_J, v_meas),
        ee_rot_meas=Rf_m[..., ee, :, :],
        q_des=q_des, v_des=v_des, base_acc_des=base_acc_des,
        foot_pos_des=torch.stack([pf_d[..., i, :] for i in foot_ids], dim=-2),
        foot_vel_des=spatial.fmv(Jfeet_d[..., :3, :], v_des[..., None, :]),
        ee_pos_des=pf_d[..., ee, :], ee_vel_des=spatial.fmv(Jee_d, v_des),
        ee_rot_des=Rf_d[..., ee, :, :],
        force_des=input_desired[..., 0:12],
        torque_limits=model.effort_limit.expand(*batch, model.nj),
        wrench_des=wrench_des,
    )


def _batch(d: WbcData):
    return d.M.shape[:-2]


def _zeros(d: WbcData, *shape):
    return torch.zeros(*_batch(d), *shape, dtype=d.M.dtype, device=d.M.device)


def _eye(d: WbcData, n):
    return torch.eye(n, dtype=d.M.dtype, device=d.M.device).expand(*_batch(d), n, n)


def _eq(d: WbcData, A, b) -> Task:
    """An equality-only task (no inequality rows)."""
    return Task(A, b, _zeros(d, 0, A.shape[-1]), _zeros(d, 0))


def _cols(d: WbcData, block, start):
    """block (...,r,k) placed at columns start:start+k of an (...,r,36) zero matrix."""
    r, k = block.shape[-2:]
    return torch.cat([_zeros(d, r, start), block, _zeros(d, r, N_DEC - start - k)], dim=-1)


def floating_base_eom_task(d: WbcData) -> Task:
    """[M_b, -J_b^T] x = -h_b (WbcBase.cpp:370-388)."""
    A = torch.cat([d.M[..., :6, :], -d.Jc.transpose(-1, -2)[..., :6, :]], dim=-1)
    return _eq(d, A, -d.nle[..., :6])


def torque_limits_task(d: WbcData) -> Task:
    """|M_j x_qdd - J_j^T F + h_j| <= tau_lim (WbcBase.cpp:392-415)."""
    hj = d.nle[..., 6:]
    row = torch.cat([d.M[..., 6:, :], -d.Jc.transpose(-1, -2)[..., 6:, :]], dim=-1)
    D = torch.cat([row, -row], dim=-2)
    f = torch.cat([d.torque_limits - hj, d.torque_limits + hj], dim=-1)
    return Task(_zeros(d, 0, N_DEC), _zeros(d, 0), D, f)


def no_contact_motion_task(d: WbcData) -> Task:
    """J_c x_qdd = -dJ_c v for stance feet (masked rows; WbcBase.cpp:418-433)."""
    mask = torch.repeat_interleave(d.contact_flags, 3, dim=-1)[..., None]
    A = mask * _cols(d, d.Jc, 0)
    b = mask[..., 0] * (-spatial.fmv(d.dJc, d.v_meas))
    return _eq(d, A, b)


def friction_cone_task(d: WbcData, friction_coeff) -> Task:
    """Swing feet: F = 0 (equality). Stance feet: pyramid D F <= 0
    (WbcBase.cpp:439-469). Masked fixed-shape encoding: 12 eq rows + 20 ineq."""
    dtype, dev = d.M.dtype, d.M.device
    swing = torch.repeat_interleave(1.0 - d.contact_flags, 3, dim=-1)
    A = swing[..., None] * _cols(d, _eye(d, 12), NQ)
    mu = torch.as_tensor(friction_coeff, dtype=dtype, device=dev)
    one, zero = torch.ones_like(mu), torch.zeros_like(mu)
    pyramid = torch.stack([
        torch.stack([zero, zero, -one]),
        torch.stack([one, zero, -mu]),
        torch.stack([-one, zero, -mu]),
        torch.stack([zero, one, -mu]),
        torch.stack([zero, -one, -mu]),
    ])                                                                # (5,3)
    blocks = [d.contact_flags[..., i, None, None] * _cols(
        d, pyramid.expand(*_batch(d), 5, 3), NQ + 3 * i) for i in range(4)]
    D = torch.cat(blocks, dim=-2)
    # masked (swing) rows become 0 <= margin: +1 so they never activate
    f = torch.repeat_interleave(1.0 - d.contact_flags, 5, dim=-1)
    return Task(A, _zeros(d, 12), D, f)


def base_linear_motion_task(d: WbcData, kp, kd) -> Task:
    """xy base acceleration PD (formulateBaseLinearMotionTask)."""
    b = (d.base_acc_des[..., 0:2]
         + kp * (d.q_des[..., 0:2] - d.q_meas[..., 0:2])
         + kd * (d.v_des[..., 0:2] - d.v_meas[..., 0:2]))
    return _eq(d, _cols(d, _eye(d, 2), 0), b)


def base_xy_linear_accel_task(d: WbcData) -> Task:
    """Pure feedforward xy base acceleration (formulateBaseXYLinearAccelTask;
    defined by the reference but unused in its shipped hierarchies)."""
    return _eq(d, _cols(d, _eye(d, 2), 0), d.base_acc_des[..., 0:2])


def base_height_motion_task(d: WbcData, kp, kd) -> Task:
    b = (d.base_acc_des[..., 2:3]
         + kp * (d.q_des[..., 2:3] - d.q_meas[..., 2:3])
         + kd * (d.v_des[..., 2:3] - d.v_meas[..., 2:3]))
    return _eq(d, _cols(d, _eye(d, 1), 2), b)


def base_angular_motion_task(d: WbcData, kp, kd) -> Task:
    """World-frame angular acceleration PD with rotation error
    (formulateBaseAngularMotionTask)."""
    A = _cols(d, d.base_J[..., 3:6, :], 0)
    zyx = d.q_meas[..., 3:6]
    w_meas = spatial.zyx_rates_to_world_angvel(zyx, d.v_meas[..., 3:6])
    w_des = spatial.zyx_rates_to_world_angvel(zyx, d.v_des[..., 3:6])
    R_meas = spatial.zyx_to_rot(zyx)
    R_des = spatial.zyx_to_rot(d.q_des[..., 3:6])
    err = spatial.rotation_error_world(R_des, R_meas)
    acc_des = spatial.world_angacc_from_zyx(zyx, d.v_des[..., 3:6], d.base_acc_des[..., 3:6])
    b = (acc_des + kp * err + kd * (w_des - w_meas)
         - spatial.fmv(d.base_dJ[..., 3:6, :], d.v_meas))
    return _eq(d, A, b)


def swing_leg_task(d: WbcData, kp, kd) -> Task:
    """Swing foot acceleration PD, masked by (1 - contact)
    (formulateSwingLegTask)."""
    mask = torch.repeat_interleave(1.0 - d.contact_flags, 3, dim=-1)[..., None]
    A = mask * _cols(d, d.Jc, 0)
    accel = kp * (d.foot_pos_des - d.foot_pos_meas) + kd * (d.foot_vel_des - d.foot_vel_meas)
    b = mask[..., 0] * (accel.reshape(*_batch(d), 12) - spatial.fmv(d.dJc, d.v_meas))
    return _eq(d, A, b)


def arm_joint_tracking_task(d: WbcData, kp, kd) -> Task:
    """Arm joint acceleration PD (formulateArmJointNomalTrackingTask)."""
    b = (kp * (d.q_des[..., NQ - 6:] - d.q_meas[..., NQ - 6:])
         + kd * (d.v_des[..., NQ - 6:] - d.v_meas[..., NQ - 6:]))
    return _eq(d, _cols(d, _eye(d, 6), NQ - 6), b)


def ee_linear_tracking_task(d: WbcData, kp, kd) -> Task:
    """EE linear acceleration PD (formulateEeLinearMotionTrackingTask)."""
    acc = (kp * (d.ee_pos_des - d.ee_pos_meas)
           + kd * (d.ee_vel_des[..., :3] - d.ee_vel_meas[..., :3]))
    b = acc - spatial.fmv(d.arm_dJ[..., 0:3, :], d.v_meas)
    return _eq(d, _cols(d, d.arm_J[..., 0:3, :], 0), b)


def ee_angular_tracking_task(d: WbcData, kp, kd) -> Task:
    """EE angular acceleration PD in world frame, with the base-orientation
    columns zeroed exactly as the reference does
    (formulateEeAngularMotionTrackingTask; b uses -omega_meas)."""
    keep = torch.ones(NQ, dtype=torch.bool, device=d.M.device)
    keep[3:6] = False
    Jang = torch.where(keep, d.arm_J[..., 3:6, :], 0.0)
    dJang = torch.where(keep, d.arm_dJ[..., 3:6, :], 0.0)
    err = spatial.rotation_error_world(d.ee_rot_des, d.ee_rot_meas)
    b = kp * err + kd * (-d.ee_vel_meas[..., 3:6]) - spatial.fmv(dJang, d.v_meas)
    return _eq(d, _cols(d, Jang, 0), b)


def contact_force_task(d: WbcData) -> Task:
    """F = F_mpc (formulateContactForceTask)."""
    return _eq(d, _cols(d, _eye(d, 12), NQ), d.force_des)


def concat_tasks(*tasks: Task) -> Task:
    return Task(
        torch.cat([t.A for t in tasks], dim=-2),
        torch.cat([t.b for t in tasks], dim=-1),
        torch.cat([t.D for t in tasks], dim=-2),
        torch.cat([t.f for t in tasks], dim=-1),
    )


def scale_task(t: Task, s) -> Task:
    return Task(s * t.A, s * t.b, t.D, t.f)


def compute_torque(d: WbcData, x_opt):
    """tau = M_j qdd + h_j - J_j^T F (WbcBase::updateCmd)."""
    qdd = x_opt[..., :NQ]
    F = x_opt[..., NQ:]
    return (spatial.fmv(d.M[..., 6:, :], qdd) + d.nle[..., 6:]
            - spatial.fmv(d.Jc.transpose(-1, -2)[..., 6:, :], F))
