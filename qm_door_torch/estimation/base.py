"""Estimator base: rbdState(55) assembly and the ground-truth estimator
(port of qm_door_tpu/estimation/base.py; qm_estimation/StateEstimateBase
and FromTopiceEstimate.cpp).

- rbdState layout [zyx(3); base pos(3); q_j(18); omega_world(3); v_base(3);
  qdot_j(18); ee pos(3); ee quat xyzw(4)] (StateEstimateBase.cpp:80-103).
- :func:`mode_from_flags` reproduces StateEstimateBase.h:161 (stance-flag
  bitmask to mode number, MotionPhaseDefinition).
- :class:`GroundTruthEstimate` = FromTopicStateEstimate: perfect base
  odometry in, rbd out (FromTopiceEstimate.cpp:23-38).

Every function takes leading batch dims.
"""
from __future__ import annotations

import torch

from ..models import centroidal, kinematics, spatial
from ..models.model import GRAVITY, RobotModel


def mode_from_flags(contact_flags):
    """4-bit stance flags (...,4) (LF, RF, LH, RH) -> mode number (...,)
    (modeNumber2StanceLeg inverse; ocs2_legged_robot MotionPhaseDefinition)."""
    f = torch.as_tensor(contact_flags)
    weights = torch.tensor([8, 4, 2, 1], dtype=torch.int32, device=f.device)
    return torch.sum((f > 0.5).to(torch.int32) * weights, dim=-1, dtype=torch.int32)


def assemble_rbd(model: RobotModel, zyx, base_pos, omega_world, v_world, qj, vj):
    """rbdState (...,55) from estimated quantities and the FK'd EE pose
    (StateEstimateBase::updateArmEE, StateEstimateBase.cpp:80-103)."""
    q = torch.cat([base_pos, zyx, qj], dim=-1)
    R_ee, p_ee = kinematics.ee_pose(model, q)
    quat = spatial.rot_to_quat(R_ee)
    return torch.cat([zyx, base_pos, qj, omega_world, v_world, vj, p_ee, quat], dim=-1)


def imu_from_state(model: RobotModel, q, v, a_w):
    """IMU readings (zyx, omega_world, specific force in the body frame)
    synthesized from the generalized state and the world acceleration of
    the base (QMHWSim::readSim, gravity-compensated accelerometer,
    QMHWSim.cpp:48-69)."""
    zyx = q[..., 3:6]
    R = spatial.zyx_to_rot(zyx)
    g = torch.tensor([0.0, 0.0, -GRAVITY], dtype=q.dtype, device=q.device)
    acc_body = spatial.fmv(R.transpose(-1, -2), a_w - g)
    omega_w = spatial.zyx_rates_to_world_angvel(zyx, v[..., 3:6])
    return zyx, omega_w, acc_body


class GroundTruthEstimate:
    """FromTopicStateEstimate equivalent: perfect base odometry in, rbd out,
    without the IMU path's first-sample yaw offset (FromTopiceEstimate.cpp:
    23-38 copies pose and twist as they are)."""

    def __init__(self, model: RobotModel):
        self.model = model

    def reset(self):
        pass

    def update(self, zyx, base_pos, omega_world, v_world, qj, vj):
        return assemble_rbd(self.model, zyx, base_pos, omega_world, v_world, qj, vj)

    def update_from_sim(self, sim_state):
        """A sim state's (q, v) -> rbd (the sim's measured_rbd)."""
        return centroidal.rbd_from_generalized(self.model, sim_state.q, sim_state.v)
