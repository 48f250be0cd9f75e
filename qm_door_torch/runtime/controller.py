"""Controller runtime: the QMController::update tick as functions and a
host-side wrapper (port of qm_door_tpu/runtime/controller.py; replaces the
ros_control plugin lifecycle, qm_controllers/src/QMController.cpp:129-201).

One control tick:
  rbd state -> centroidal observation (yaw-unwrapped)
  -> evaluate the MPC policy at t (MRT)
  -> hierarchical WBC -> torques
  -> safety check
  -> hybrid-joint commands (posDes, velDes, kp, kd, tau_ff per joint)

The MPC solve runs at its own cadence (100 Hz) around this tick; see
sim/closed_loop.py for the interleaving used in simulation. Nothing in a
tick reads a tensor back to the host: the time gates are tensors and the
yaw carried between ticks stays on the device.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import torch

from ..models import centroidal
from ..models.model import RobotModel
from ..wbc.force import hierarchical_wbc_ft
from ..wbc.wbc import WbcGains, WbcState, as_gains, hierarchical_mpc_wbc, hierarchical_wbc
from .mrt import PolicyStore, evaluate_policy
from .safety import safety_check


class ControllerConfig(NamedTuple):
    """Static control-law parameters (QMController::updateControlLaw)."""

    leg_kp: float = 0.0
    leg_kd: float = 3.0
    arm_kp: float = 0.0
    arm_kd: float = 0.5
    leg_pd_start_time: float = 10.0
    arm_init_time: float = 10.0


@dataclass(frozen=True)
class HybridCommand:
    """The 5-tuple motor command per joint (HybridJointInterface.h:10-91)."""

    pos_des: torch.Tensor  # (18,)
    vel_des: torch.Tensor  # (18,)
    kp: torch.Tensor       # (18,)
    kd: torch.Tensor       # (18,)
    tau_ff: torch.Tensor   # (18,)

    def torque(self, q_meas, v_meas):
        """The actuator-side law tau = kp (q_d - q) + kd (v_d - v) + ff
        (QMHWSim::writeSim, QMHWSim.cpp:98-116)."""
        return (self.kp * (self.pos_des - q_meas) + self.kd * (self.vel_des - v_meas)
                + self.tau_ff)

    def stack(self):
        """(5, 18): the rows sim.sim_step takes (pos, vel, kp, kd, ff)."""
        return torch.stack([self.pos_des, self.vel_des, self.kp, self.kd, self.tau_ff])


@dataclass(frozen=True)
class TickResult:
    command: HybridCommand
    x_obs: torch.Tensor    # (30,) centroidal observation
    x_opt: torch.Tensor    # (30,) policy state
    u_opt: torch.Tensor    # (nu,) policy input
    wbc_cmd: torch.Tensor  # (54,) [qdd; F; tau], (60,) [qdd; F; W; tau] force-tracking
    safe: torch.Tensor     # 0-d bool
    wbc_state: WbcState


def observe(model: RobotModel, rbd_measured, yaw_last):
    """rbdState -> yaw-unwrapped centroidal observation
    (QMController::updateStateEstimation, QMController.cpp:238-245);
    ``yaw_last`` a number or a 0-d tensor."""
    x = centroidal.centroidal_state_from_rbd(model, rbd_measured)
    yaw = x[..., 9]
    dyaw = torch.atan2(torch.sin(yaw - yaw_last), torch.cos(yaw - yaw_last))
    x = x.clone()
    x[..., 9] = yaw_last + dyaw
    return x


def controller_tick(model: RobotModel, wbc_cfg, ctrl: ControllerConfig, policy: PolicyStore,
                    contact_flags, rbd_measured, wbc_state: WbcState, t, period, yaw_last,
                    separated: bool = False, force_tracking: bool = False, grasp=0.0,
                    arm_locked: bool = False, wrench_priority: int = 0) -> TickResult:
    """One control tick (QMController::update body) of one robot.

    ``t`` a number or a 0-d tensor; the leg gate (t > leg_pd_start_time)
    and the arm-init gate (t < arm_init_time) are tensors.
    ``force_tracking``: policy inputs are 36-dim (EE wrench appended) and
    the WBC runs the 42-var force-aware hierarchy (wbc/force.py); ``grasp``
    gates the wrench-tracking task.
    """
    x_obs = observe(model, rbd_measured, yaw_last)
    x_opt, u_opt = evaluate_policy(policy, t)
    dtype, dev = x_obs.dtype, x_obs.device
    t = torch.as_tensor(t, dtype=policy.times.dtype, device=dev)

    if force_tracking:
        wbc_cmd, wbc_state = hierarchical_wbc_ft(
            model, wbc_cfg, x_opt, u_opt, rbd_measured, contact_flags, grasp, wbc_state,
            period, wrench_priority=wrench_priority)
        tau = wbc_cmd[42:60]
    elif separated:
        wbc_cmd, wbc_state = hierarchical_mpc_wbc(model, wbc_cfg, x_opt, u_opt, rbd_measured,
                                                  contact_flags, wbc_state, period)
        tau = wbc_cmd[36:54]
    else:
        wbc_cmd, wbc_state = hierarchical_wbc(
            model, wbc_cfg, x_opt, u_opt, rbd_measured, contact_flags, wbc_state, period,
            use_arm_init=t < ctrl.arm_init_time, arm_locked=arm_locked)
        tau = wbc_cmd[36:54]

    pos_des = centroidal.joint_angles(x_opt)
    vel_des = centroidal.joint_velocities(u_opt)
    # legs are only commanded after leg_pd_start_time (QMController.cpp:180:
    # "if (time > 10)"); the arm is always commanded
    leg_on = (t > ctrl.leg_pd_start_time).to(dtype)

    def full(n, value):
        return torch.full((n,), value, dtype=dtype, device=dev)

    command = HybridCommand(
        pos_des=pos_des,
        vel_des=torch.cat([vel_des[:12], full(6, 0.0)]),
        kp=torch.cat([leg_on * full(12, ctrl.leg_kp), full(6, ctrl.arm_kp)]),
        kd=torch.cat([leg_on * full(12, ctrl.leg_kd), full(6, ctrl.arm_kd)]),
        tau_ff=torch.cat([leg_on * tau[:12], tau[12:]]))
    return TickResult(command=command, x_obs=x_obs, x_opt=x_opt, u_opt=u_opt, wbc_cmd=wbc_cmd,
                      safe=safety_check(x_obs), wbc_state=wbc_state)


class QmController:
    """Host-side controller wrapper of one robot on the model's device.

    ``separated=False`` mirrors qm::QMController (combined system,
    HierarchicalWbc); ``separated=True`` mirrors qm::QMMpcController
    (12-joint hardware, HierarchicalMpcWbc).

    ``self.gains`` (WbcGains) may be replaced between ticks (live tuning,
    dynamic_reconfigure parity). They start as ``cfg.wbc`` rounded to
    float32, as the JAX package's QmController holds them, so both
    packages tick on the same numbers. ``self.yaw_last``, the yaw the next
    observation unwraps against, carries from tick to tick as a 0-d tensor.
    """

    def __init__(self, model: RobotModel, cfg, separated: bool = False,
                 force_tracking: bool = False):
        self.model = model
        self.cfg = cfg
        self.separated = separated
        self.force_tracking = force_tracking
        self.arm_locked = getattr(cfg.model, "arm_locked", False)
        self.wrench_priority = cfg.force_tracking.wrench_priority
        self.ctrl = ControllerConfig(
            leg_kp=cfg.controller.leg_kp,
            leg_kd=cfg.controller.leg_kd,
            arm_kp=cfg.controller.arm_kp,
            arm_kd=cfg.controller.arm_kd,
            leg_pd_start_time=cfg.controller.leg_pd_start_time,
            arm_init_time=cfg.wbc.arm_init_time,
        )
        self.gains = as_gains(WbcGains.from_settings(cfg.wbc, dtype=torch.float32),
                              model.dtype, model.device)
        self.yaw_last = 0.0

    def tick(self, policy, contact_flags, rbd_measured, wbc_state, t, period,
             grasp=0.0) -> TickResult:
        res = controller_tick(
            self.model, as_gains(self.gains, self.model.dtype, self.model.device), self.ctrl,
            policy, contact_flags, rbd_measured, wbc_state, t, period, self.yaw_last,
            separated=self.separated, force_tracking=self.force_tracking, grasp=grasp,
            arm_locked=self.arm_locked, wrench_priority=self.wrench_priority)
        self.yaw_last = res.x_obs[9]
        return res
