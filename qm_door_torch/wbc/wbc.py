"""Hierarchical whole-body controllers (port of qm_door_tpu/wbc/wbc.py).

The priority stacks mirror qm_wbc/src/HierarchicalWbc.cpp:182-202 and
HierarchicalMpcWbc.cpp:226-236:

combined (HierarchicalWbc):
  T0 = EoM + torque limits + no-contact motion + friction cone
  T1 = base height + base angular + EE linear + EE angular + 100 * swing
       (``use_arm_init``: T1 is the arm-joint PD task instead)
  T2 = contact force + base xy linear

separated (HierarchicalMpcWbc):
  T1 = base height + angular + linear + 100 * swing;  T2 = contact force

Returns cmd = [qdd (24); F (12); tau (18)] like WbcBase::updateCmd. The
task build is batch-native; the cascade's SPD solves run on K1 when the
tensors are on the card (``wbc/hoqp.py``). There is no backend argument:
the tensors' device chooses. The single-robot ticks
(:func:`hierarchical_wbc`, :func:`hierarchical_mpc_wbc`) run the batched
code on a batch of one.
"""
from __future__ import annotations

from dataclasses import dataclass, fields

import torch

from .. import set_full_f32_matmuls
from ..models.model import RobotModel
from . import tasks as T
from .hoqp import solve_hierarchy_batched


@dataclass(frozen=True)
class WbcGains:
    """The WBC gains as tensors on one device in one dtype
    (qm_wbc/cfg/wbcWigeht.cfg). ``qp_iterations`` and ``arm_init_time``
    stay plain numbers: they change control flow."""

    swing_kp: torch.Tensor
    swing_kd: torch.Tensor
    base_height_kp: torch.Tensor
    base_height_kd: torch.Tensor
    base_linear_kp: torch.Tensor
    base_linear_kd: torch.Tensor
    base_angular_kp: torch.Tensor
    base_angular_kd: torch.Tensor
    arm_joint_kp: torch.Tensor   # (6,)
    arm_joint_kd: torch.Tensor   # (6,)
    ee_linear_kp: torch.Tensor   # (3,)
    ee_linear_kd: torch.Tensor   # (3,)
    ee_angular_kp: torch.Tensor  # (3,)
    ee_angular_kd: torch.Tensor  # (3,)
    swing_task_weight: torch.Tensor
    friction_coefficient: torch.Tensor
    qp_iterations: int = 30
    arm_init_time: float = 10.0

    @classmethod
    def from_settings(cls, ws, dtype=torch.float32, device=None) -> "WbcGains":
        """From a config.WbcSettings (or anything with its fields, such as
        another WbcGains)."""
        return cls(**{
            f.name: (getattr(ws, f.name) if f.name in ("qp_iterations", "arm_init_time")
                     else torch.as_tensor(getattr(ws, f.name), dtype=dtype, device=device))
            for f in fields(cls)})


def as_gains(wbc_cfg, dtype, device) -> WbcGains:
    """``wbc_cfg`` as WbcGains in ``dtype`` on ``device`` (a WbcGains that
    already is passes through)."""
    if isinstance(wbc_cfg, WbcGains) and wbc_cfg.swing_kp.dtype == dtype \
            and wbc_cfg.swing_kp.device == torch.device(device):
        return wbc_cfg
    return WbcGains.from_settings(wbc_cfg, dtype=dtype, device=device)


@dataclass(frozen=True)
class WbcState:
    """Cross-tick WBC memory (finite-difference joint accelerations)."""

    input_last: torch.Tensor  # (..., nu): 30 nominal, 36 force-tracking

    @staticmethod
    def init(dtype=torch.float64, nu: int = 30, batch=(), device=None) -> "WbcState":
        return WbcState(input_last=torch.zeros(*batch, nu, dtype=dtype, device=device))


def _wbc_common(model, gains: WbcGains, state_desired, input_desired, rbd_measured,
                contact_flags, wbc_state: WbcState, period):
    data = T.build_wbc_data(model, state_desired, input_desired, rbd_measured,
                            contact_flags, wbc_state.input_last, period)
    task0 = T.concat_tasks(
        T.floating_base_eom_task(data),
        T.torque_limits_task(data),
        T.no_contact_motion_task(data),
        T.friction_cone_task(data, gains.friction_coefficient),
    )
    return data, task0


def combined_tasks(model: RobotModel, wbc_cfg, state_desired, input_desired,
                   rbd_measured, contact_flags, wbc_state: WbcState, period,
                   use_arm_init=False, arm_locked: bool = False):
    """The combined-system priority stack without the solve: (data,
    [T0, T1, T2]), each leaf with the inputs' batch dims.

    ``use_arm_init`` (a bool or a bool tensor broadcasting over the batch
    dims) selects the arm-joint PD task as T1 with ``torch.where``, padded
    to T1's 22 rows. ``arm_locked`` (the quad-only variant) replaces the EE
    tracking rows of T1 by the arm-joint PD hold, the same 6 rows."""
    dtype, dev = state_desired.dtype, state_desired.device
    g = as_gains(wbc_cfg, dtype, dev)
    data, task0 = _wbc_common(model, g, state_desired, input_desired, rbd_measured,
                              contact_flags, wbc_state, period)
    if arm_locked:
        ee_rows = T.arm_joint_tracking_task(data, g.arm_joint_kp, g.arm_joint_kd)
    else:
        ee_rows = T.concat_tasks(
            T.ee_linear_tracking_task(data, g.ee_linear_kp, g.ee_linear_kd),
            T.ee_angular_tracking_task(data, g.ee_angular_kp, g.ee_angular_kd),
        )
    task1_full = T.concat_tasks(
        T.base_height_motion_task(data, g.base_height_kp, g.base_height_kd),
        T.base_angular_motion_task(data, g.base_angular_kp, g.base_angular_kd),
        ee_rows,
        T.scale_task(T.swing_leg_task(data, g.swing_kp, g.swing_kd), g.swing_task_weight),
    )
    task_init = T.arm_joint_tracking_task(data, g.arm_joint_kp, g.arm_joint_kd)
    pad = task1_full.A.shape[-2] - task_init.A.shape[-2]
    batch = task_init.b.shape[:-1]
    init_A = torch.cat([task_init.A, torch.zeros(*batch, pad, T.N_DEC, dtype=dtype,
                                                 device=dev)], dim=-2)
    init_b = torch.cat([task_init.b, torch.zeros(*batch, pad, dtype=dtype, device=dev)],
                       dim=-1)
    use = torch.as_tensor(use_arm_init, device=dev)
    task1 = T.Task(torch.where(use[..., None, None], init_A, task1_full.A),
                   torch.where(use[..., None], init_b, task1_full.b),
                   task1_full.D, task1_full.f)
    task2 = T.concat_tasks(
        T.contact_force_task(data),
        T.base_linear_motion_task(data, g.base_linear_kp, g.base_linear_kd),
    )
    return data, [task0, task1, task2]


def hierarchical_wbc_batched(model: RobotModel, wbc_cfg, state_desired, input_desired,
                             rbd_measured, contact_flags, wbc_state: WbcState, period,
                             use_arm_init=False, qp_iters=None, arm_locked: bool = False):
    """Batch-major combined-system WBC tick: state_desired (B,30),
    input_desired (B,nu), rbd_measured (B,55), contact_flags (B,4) and
    wbc_state.input_last (B,nu), all on one device; ``wbc_cfg`` a
    config.WbcSettings or WbcGains. Returns (cmd (B,54), new WbcState)."""
    set_full_f32_matmuls()
    qp_iters = wbc_cfg.qp_iterations if qp_iters is None else qp_iters
    data, tasks = combined_tasks(model, wbc_cfg, state_desired, input_desired,
                                 rbd_measured, contact_flags, wbc_state, period,
                                 use_arm_init=use_arm_init, arm_locked=arm_locked)
    x_opt = solve_hierarchy_batched(tasks, qp_iters=qp_iters)
    tau = T.compute_torque(data, x_opt)
    return torch.cat([x_opt, tau], dim=-1), WbcState(input_last=input_desired)


def hierarchical_wbc(model: RobotModel, wbc_cfg, state_desired, input_desired, rbd_measured,
                     contact_flags, wbc_state: WbcState, period, use_arm_init=False,
                     qp_iters=None, arm_locked: bool = False):
    """One robot's combined-system WBC tick: state_desired (30,),
    input_desired (nu,), rbd_measured (55,), contact_flags (4,),
    wbc_state.input_last (nu,); ``use_arm_init`` a bool or a 0-d bool
    tensor (time < arm_init_time). Returns (cmd (54,), new WbcState)."""
    cmd, _ = hierarchical_wbc_batched(
        model, wbc_cfg, state_desired[None], input_desired[None], rbd_measured[None],
        contact_flags[None], WbcState(input_last=wbc_state.input_last[None]), period,
        use_arm_init=use_arm_init, qp_iters=qp_iters, arm_locked=arm_locked)
    return cmd[0], WbcState(input_last=input_desired)


def separated_tasks(model: RobotModel, wbc_cfg, state_desired, input_desired, rbd_measured,
                    contact_flags, wbc_state: WbcState, period):
    """The separated-system priority stack without the solve: (data,
    [T0, T1, T2]), each leaf with the inputs' batch dims."""
    g = as_gains(wbc_cfg, state_desired.dtype, state_desired.device)
    data, task0 = _wbc_common(model, g, state_desired, input_desired, rbd_measured,
                              contact_flags, wbc_state, period)
    task1 = T.concat_tasks(
        T.base_height_motion_task(data, g.base_height_kp, g.base_height_kd),
        T.base_angular_motion_task(data, g.base_angular_kp, g.base_angular_kd),
        T.base_linear_motion_task(data, g.base_linear_kp, g.base_linear_kd),
        T.scale_task(T.swing_leg_task(data, g.swing_kp, g.swing_kd), g.swing_task_weight),
    )
    return data, [task0, task1, T.contact_force_task(data)]


def hierarchical_mpc_wbc_batched(model: RobotModel, wbc_cfg, state_desired, input_desired,
                                 rbd_measured, contact_flags, wbc_state: WbcState, period,
                                 qp_iters=None):
    """Batch-major separated-system WBC tick (HierarchicalMpcWbc), shapes as
    :func:`hierarchical_wbc_batched`. Returns (cmd (B,54), new WbcState)."""
    set_full_f32_matmuls()
    qp_iters = wbc_cfg.qp_iterations if qp_iters is None else qp_iters
    data, tasks = separated_tasks(model, wbc_cfg, state_desired, input_desired, rbd_measured,
                                  contact_flags, wbc_state, period)
    x_opt = solve_hierarchy_batched(tasks, qp_iters=qp_iters)
    tau = T.compute_torque(data, x_opt)
    return torch.cat([x_opt, tau], dim=-1), WbcState(input_last=input_desired)


def hierarchical_mpc_wbc(model: RobotModel, wbc_cfg, state_desired, input_desired,
                         rbd_measured, contact_flags, wbc_state: WbcState, period,
                         qp_iters=None):
    """One robot's separated-system WBC tick, shapes as
    :func:`hierarchical_wbc`, on a batch of one. Returns (cmd (54,), new
    WbcState)."""
    cmd, _ = hierarchical_mpc_wbc_batched(
        model, wbc_cfg, state_desired[None], input_desired[None], rbd_measured[None],
        contact_flags[None], WbcState(input_last=wbc_state.input_last[None]), period,
        qp_iters=qp_iters)
    return cmd[0], WbcState(input_last=input_desired)
