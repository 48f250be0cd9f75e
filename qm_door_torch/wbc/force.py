"""Force-aware hierarchical WBC, batch-major (port of
qm_door_tpu/wbc/force.py; the single-robot tick is a batch of one): the decision variables widen 36 -> 42 with the
EE wrench,

    x (42) = [qddot (24); F_feet (12); W_ee (6)],
    M qdd + h = J_c^T F + J_ee^T W + S^T tau,

with W_ee the external wrench ON the robot at the EE frame (rows of arm_J
order [linear; angular]). Tasks that ignore the wrench are the 36-var
formulations padded with 6 zero columns; the EoM, torque-limit and torque
pieces gain the J_ee^T W terms. The wrench-tracking equality (W = W_mpc
while grasping, W = 0 when not) sits at level 0 beside the EoM
(``wrench_priority=0``: W is a force the world applies, not one the
optimizer may spend) or, for any other value, at level 2 beside the
contact-force task.
"""
from __future__ import annotations

import torch

from .. import set_full_f32_matmuls
from ..models.model import RobotModel
from ..models.spatial import fmv
from . import tasks as T
from .hoqp import Task, solve_hierarchy_batched
from .wbc import WbcState, as_gains

N_DEC_FT = 42
NQ = 24


def pad_cols(t: Task) -> Task:
    """Lift a 36-var task into the 42-var space (wrench columns zero)."""
    def pad(M):
        return torch.cat([M, M.new_zeros(*M.shape[:-1], 6)], dim=-1)

    return Task(pad(t.A), t.b, pad(t.D), t.f)


def floating_base_eom_task_ft(d: T.WbcData) -> Task:
    """[M_b, -J_c^T_b, -J_ee^T_b] x = -h_b."""
    A = torch.cat([d.M[..., :6, :], -d.Jc.transpose(-1, -2)[..., :6, :],
                   -d.arm_J.transpose(-1, -2)[..., :6, :]], dim=-1)
    return T._eq(d, A, -d.nle[..., :6])


def torque_limits_task_ft(d: T.WbcData) -> Task:
    """|M_j qdd - J_c^T_j F - J_ee^T_j W + h_j| <= tau_lim."""
    row = torch.cat([d.M[..., 6:, :], -d.Jc.transpose(-1, -2)[..., 6:, :],
                     -d.arm_J.transpose(-1, -2)[..., 6:, :]], dim=-1)
    D = torch.cat([row, -row], dim=-2)
    f = torch.cat([d.torque_limits - d.nle[..., 6:], d.torque_limits + d.nle[..., 6:]], dim=-1)
    return Task(T._zeros(d, 0, N_DEC_FT), T._zeros(d, 0), D, f)


def wrench_tracking_task(d: T.WbcData, grasp) -> Task:
    """W = grasp * W_mpc (zero wrench when not grasping); ``grasp`` a number
    or a tensor of the batch dims."""
    A = torch.cat([T._zeros(d, 6, 36), T._eye(d, 6)], dim=-1)
    g = torch.as_tensor(grasp, dtype=d.M.dtype, device=d.M.device)
    return T._eq(d, A, g[..., None] * d.wrench_des)


def compute_torque_ft(d: T.WbcData, x_opt):
    """tau = M_j qdd + h_j - J_c^T_j F - J_ee^T_j W."""
    qdd = x_opt[..., :NQ]
    F = x_opt[..., NQ:NQ + 12]
    W = x_opt[..., NQ + 12:NQ + 18]
    return (fmv(d.M[..., 6:, :], qdd) + d.nle[..., 6:]
            - fmv(d.Jc.transpose(-1, -2)[..., 6:, :], F)
            - fmv(d.arm_J.transpose(-1, -2)[..., 6:, :], W))


def ft_tasks(model: RobotModel, wbc_cfg, state_desired, input_desired, rbd_measured,
             contact_flags, grasp, wbc_state: WbcState, period, wrench_priority: int = 0):
    """The force-tracking priority stack without the solve: (data,
    [T0, T1, T2]), each leaf with the inputs' batch dims; input_desired
    (...,36), grasp (...)."""
    g = as_gains(wbc_cfg, state_desired.dtype, state_desired.device)
    data = T.build_wbc_data(model, state_desired, input_desired, rbd_measured,
                            contact_flags, wbc_state.input_last, period)
    task0_parts = [
        floating_base_eom_task_ft(data),
        torque_limits_task_ft(data),
        pad_cols(T.no_contact_motion_task(data)),
        pad_cols(T.friction_cone_task(data, g.friction_coefficient)),
    ]
    if wrench_priority == 0:
        task0_parts.append(wrench_tracking_task(data, grasp))
    task1 = T.concat_tasks(
        pad_cols(T.base_height_motion_task(data, g.base_height_kp, g.base_height_kd)),
        pad_cols(T.base_angular_motion_task(data, g.base_angular_kp, g.base_angular_kd)),
        pad_cols(T.ee_linear_tracking_task(data, g.ee_linear_kp, g.ee_linear_kd)),
        pad_cols(T.ee_angular_tracking_task(data, g.ee_angular_kp, g.ee_angular_kd)),
        T.scale_task(pad_cols(T.swing_leg_task(data, g.swing_kp, g.swing_kd)),
                     g.swing_task_weight),
    )
    task2_parts = [pad_cols(T.contact_force_task(data))]
    if wrench_priority != 0:
        task2_parts.append(wrench_tracking_task(data, grasp))
    task2_parts.append(
        pad_cols(T.base_linear_motion_task(data, g.base_linear_kp, g.base_linear_kd)))
    return data, [T.concat_tasks(*task0_parts), task1, T.concat_tasks(*task2_parts)]


def hierarchical_wbc_ft_batched(model: RobotModel, wbc_cfg, state_desired, input_desired,
                                rbd_measured, contact_flags, grasp, wbc_state: WbcState,
                                period, qp_iters=None, wrench_priority: int = 0):
    """Batch-major force-tracking WBC tick: state (B,30), input (B,36), rbd
    (B,55), flags (B,4), grasp (B,), input_last (B,36), all on one device.
    Returns (cmd (B,60) = [qdd; F; W; tau], new WbcState)."""
    set_full_f32_matmuls()
    qp_iters = wbc_cfg.qp_iterations if qp_iters is None else qp_iters
    data, tasks = ft_tasks(model, wbc_cfg, state_desired, input_desired, rbd_measured,
                           contact_flags, grasp, wbc_state, period,
                           wrench_priority=wrench_priority)
    x_opt = solve_hierarchy_batched(tasks, qp_iters=qp_iters)
    tau = compute_torque_ft(data, x_opt)
    return torch.cat([x_opt, tau], dim=-1), WbcState(input_last=input_desired)


def hierarchical_wbc_ft(model: RobotModel, wbc_cfg, state_desired, input_desired, rbd_measured,
                        contact_flags, grasp, wbc_state: WbcState, period, qp_iters=None,
                        wrench_priority: int = 0):
    """One robot's force-tracking WBC tick: input_desired (36,), grasp a
    number or a 0-d tensor gating the wrench tracking; ``wrench_priority``
    0 (the wrench pinned at level 0, with the EoM) or 2 (beside the
    contact-force task). Returns (cmd (60,) = [qdd; F; W; tau], new
    WbcState)."""
    if wrench_priority not in (0, 2):
        raise ValueError(f"wrench_priority must be 0 (pinned with the EoM) or 2 (legacy "
                         f"contact-force slot), got {wrench_priority!r}")
    g = torch.as_tensor(grasp, dtype=state_desired.dtype, device=state_desired.device)
    cmd, _ = hierarchical_wbc_ft_batched(
        model, wbc_cfg, state_desired[None], input_desired[None], rbd_measured[None],
        contact_flags[None], g.reshape(1), WbcState(input_last=wbc_state.input_last[None]),
        period, qp_iters=qp_iters, wrench_priority=wrench_priority)
    return cmd[0], WbcState(input_last=input_desired)
