"""Linear Kalman filter fusing IMU and leg odometry (port of
qm_door_tpu/estimation/kalman.py).

Filter state xe (18) = [p_base(3); v_base(3); p_foot LF,RF,LH,RH (12)],
world frame. Orientation and angular velocity are taken from the IMU
directly (not filtered), as in the classic linear design.

Model:
  predict: p' = p + dt v + 0.5 dt^2 a_w ;  v' = v + dt a_w ; feet constant,
           with swing feet given large process noise so they re-lock at
           touchdown.
  measure (28): per foot i
    - relative position (3):  p_f_i - p_base  =  R_wb fk_rel_i(q_j)
    - base velocity (3):      v_base          = -(omega x r_i + R J_rel qdot)
    - foot height (1):        p_f_i[z]        =  terrain height
  with stance/swing gating through the measurement covariance.

One step is fixed-shape tensor code with no host read: the slip gate is a
``torch.where`` on its parameter, the gain a ``torch.linalg.solve_ex``,
the covariance update the Joseph form.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import torch

from ..models import kinematics, spatial
from ..models.model import GRAVITY, RobotModel
from .base import assemble_rbd

NXE = 18
NY = 28


class KfParams(NamedTuple):
    """Noise configuration (legged_control kalmanFilter defaults scale)."""

    process_position: float = 0.02
    process_velocity: float = 0.02
    process_foot: float = 0.002
    sensor_rel_position: float = 0.005
    sensor_velocity: float = 0.1
    sensor_foot_height: float = 0.01
    swing_inflation: float = 1e4   # multiplies noise for swing-foot rows
    init_cov: float = 0.1
    # Per-foot slip gate on the leg-odometry velocity rows: a foot whose
    # predicted velocity innovation exceeds ``slip_gate`` m/s gets its 3
    # velocity rows inflated by (|r|/gate - 1) * slip_inflation, so gross
    # slip is soft-rejected while clean stance is untouched. 0 disables it
    # (the default, as in the JAX package: it trades a worse settle-impact
    # transient for slip rejection).
    slip_gate: float = 0.0
    slip_inflation: float = 200.0


@dataclass(frozen=True)
class KfState:
    xe: torch.Tensor  # (18,)
    P: torch.Tensor   # (18, 18)


def _h_matrix(dtype, device=None):
    """Constant measurement matrix H (28, 18)."""
    H = torch.zeros(NY, NXE, dtype=dtype, device=device)
    eye3 = torch.eye(3, dtype=dtype, device=device)
    for i in range(4):
        # relative foot position rows: p_f_i - p
        H[3 * i:3 * i + 3, 0:3] = -eye3
        H[3 * i:3 * i + 3, 6 + 3 * i:9 + 3 * i] = eye3
        # base velocity rows
        H[12 + 3 * i:15 + 3 * i, 3:6] = eye3
        # foot height rows
        H[24 + i, 6 + 3 * i + 2] = 1.0
    return H


def kf_init(model: RobotModel, q0, params: KfParams = KfParams()) -> KfState:
    """Initialize from a configuration: base pose + FK foot positions."""
    p_feet = kinematics.contact_positions(model, q0).reshape(12)
    xe = torch.cat([q0[0:3], torch.zeros_like(q0[0:3]), p_feet])
    P = params.init_cov * torch.eye(NXE, dtype=q0.dtype, device=q0.device)
    return KfState(xe=xe, P=P)


def kf_step(model: RobotModel, params: KfParams, state: KfState, zyx, omega_world, acc_body,
            qj, vj, contact_flags, dt, terrain_height=0.0):
    """One fused predict + update. Returns (KfState, rbd (55,)).

    zyx / omega_world / acc_body: IMU readings (acc the specific force,
    body frame); qj / vj: joint encoders; contact_flags: (4,) stance flags;
    terrain_height: a number, or (4,) heights under the feet.
    """
    dtype, dev = state.xe.dtype, state.xe.device
    R_wb = spatial.zyx_to_rot(zyx)
    g = torch.tensor([0.0, 0.0, -GRAVITY], dtype=dtype, device=dev)
    a_w = spatial.fmv(R_wb, acc_body) + g

    # ---- predict -------------------------------------------------------
    xe, P = state.xe, state.P
    p = xe[0:3] + dt * xe[3:6] + 0.5 * dt * dt * a_w
    v = xe[3:6] + dt * a_w
    xe_pred = torch.cat([p, v, xe[6:18]])

    A = torch.eye(NXE, dtype=dtype, device=dev)
    A[0:3, 3:6] = dt * torch.eye(3, dtype=dtype, device=dev)

    swing = 1.0 - contact_flags                                   # (4,)
    foot_q = params.process_foot * (1.0 + swing * params.swing_inflation)
    Qd = torch.cat([
        torch.full((3,), params.process_position, dtype=dtype, device=dev),
        torch.full((3,), params.process_velocity, dtype=dtype, device=dev),
        torch.repeat_interleave(foot_q, 3).to(dtype),
    ])
    P_pred = A @ P @ A.T + dt * torch.diag(Qd)

    # ---- measurements from leg odometry -------------------------------
    # FK with the base at the origin and the IMU orientation: relative foot
    # kinematics
    q_rel = torch.cat([torch.zeros(3, dtype=dtype, device=dev), zyx, qj])
    p_rel = kinematics.contact_positions(model, q_rel)            # (4,3)
    J = kinematics.frame_jacobians(model, q_rel, model.contact_frame_ids)
    # foot velocity from the joints and the body rotation, base translation
    # excluded: v_foot_rel = J_j qdot_j + omega x p_rel
    v_rel = spatial.fmv(J[:, :3, 6:24], vj) + torch.linalg.cross(
        omega_world[None, :].expand(4, 3), p_rel, dim=-1)          # (4,3)
    th = torch.as_tensor(terrain_height, dtype=dtype, device=dev)
    y = torch.cat([p_rel.reshape(12), (-v_rel).reshape(12), th.expand(4)])

    swing_rows = torch.cat([torch.repeat_interleave(swing, 3),
                            torch.repeat_interleave(swing, 3), swing])
    Rd = torch.cat([
        torch.full((12,), params.sensor_rel_position, dtype=dtype, device=dev),
        torch.full((12,), params.sensor_velocity, dtype=dtype, device=dev),
        torch.full((4,), params.sensor_foot_height, dtype=dtype, device=dev),
    ]) * (1.0 + swing_rows * params.swing_inflation)

    H = _h_matrix(dtype, dev)
    r = y - H @ xe_pred
    # slip gate (KfParams.slip_gate): soft-reject the velocity rows of feet
    # whose predicted innovation says they slide; a gate of 0 selects the
    # rows as they are
    gate = torch.as_tensor(params.slip_gate, dtype=dtype, device=dev)
    rv = r[12:24].reshape(4, 3)
    speed = torch.sqrt(torch.sum(rv * rv, dim=-1) + 1e-12)       # (4,)
    on = gate > 0.0
    excess = torch.clamp(speed / torch.where(on, gate, torch.ones_like(gate)) - 1.0, min=0.0)
    infl = torch.repeat_interleave(1.0 + params.slip_inflation * excess, 3)
    Rd = torch.cat([Rd[:12], torch.where(on, Rd[12:24] * infl, Rd[12:24]), Rd[24:]])
    S = H @ P_pred @ H.T + torch.diag(Rd)
    K = torch.linalg.solve_ex(S, H @ P_pred)[0].T                 # (18, 28)
    xe_new = xe_pred + K @ r
    IKH = torch.eye(NXE, dtype=dtype, device=dev) - K @ H
    # Joseph form for the covariance (symmetric PSD in f32)
    P_new = IKH @ P_pred @ IKH.T + K @ torch.diag(Rd) @ K.T

    rbd = assemble_rbd(model, zyx, xe_new[0:3], omega_world, xe_new[3:6], qj, vj)
    return KfState(xe=xe_new, P=P_new), rbd


class KalmanFilterEstimate:
    """Stateful wrapper mirroring StateEstimateBase::update's cadence.

    Holds (KfState, zyx offset); ``update`` consumes one IMU + encoder
    sample and returns rbdState(55). Every estimated quantity lives in the
    world frame shifted by the first sample's yaw (the IMU path's offset
    removal, StateEstimateBase.cpp:46-68, applied to positions and rates
    alike)."""

    def __init__(self, model: RobotModel, params: KfParams = KfParams()):
        self.model = model
        self.params = params
        self._state = None
        self._zyx_offset = None
        self._R_shift = None

    def reset(self, q0):
        yaw0 = q0[3]
        zero = torch.zeros_like(yaw0)
        self._zyx_offset = torch.stack([yaw0, zero, zero])
        self._R_shift = spatial.zyx_to_rot(torch.stack([-yaw0, zero, zero]))
        q0_shift = torch.cat([spatial.fmv(self._R_shift, q0[0:3]), q0[3:6] - self._zyx_offset,
                              q0[6:]])
        self._state = kf_init(self.model, q0_shift, self.params)

    def update(self, zyx, omega_world, acc_body, qj, vj, contact_flags, dt,
               terrain_height=0.0):
        if self._state is None:
            self.reset(torch.cat([torch.zeros_like(zyx), zyx, qj]))
        zyx = zyx - self._zyx_offset
        omega_world = spatial.fmv(self._R_shift, omega_world)
        self._state, rbd = kf_step(self.model, self.params, self._state, zyx, omega_world,
                                   acc_body, qj, vj, contact_flags, dt,
                                   terrain_height=terrain_height)
        return rbd

    @property
    def state(self) -> KfState:
        return self._state
