"""Command -> TargetTrajectories converters (port of
qm_door_tpu/runtime/targets.py).

Mirrors qm_controllers/src/QmTargetTrajectoriesPublisher_node.cpp: the three
converters (interactive-marker / planner EE goal pose, base twist cmd_vel,
EE twist ee_cmd_vel) and the controller's initial target
(QMController::starting, QMController.cpp:99-115). Host-side (command-rate)
code: plain numpy in float64, as the JAX package's; each converter returns
the solver's padded TargetTrajectories with the tensors in ``dtype`` on
``device`` (CUDA unless the caller asks for the CPU).
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from ..ocp.reference import TargetTrajectories

# StartingPosition.h constants
START_X = -2.0
START_Y = 0.0
START_PSI = 0.0
ARM_DIST = 0.6
START_HEIGHT = 0.4
ARM_HEIGHT = 0.036


def _quat_yaw(q_xyzw):
    x, y, z, w = q_xyzw
    return np.arctan2(2.0 * (w * z + x * y), 1.0 - 2.0 * (y * y + z * z))


def _quat_distance(qa, qb):
    """Rotation-vector distance (ocs2 quaternionDistance magnitude)."""
    xa, ya, za, wa = qa
    xb, yb, zb, wb = qb
    # vec(qb * qa^-1) style error
    return np.array(
        [
            wa * xb - wb * xa + (ya * zb - za * yb),
            wa * yb - wb * ya + (za * xb - xa * zb),
            wa * zb - wb * za + (xa * yb - ya * xb),
        ]
    )


def _np(*arrays):
    """Each argument as a float64 numpy array (tensors are copied to the host)."""
    return tuple(np.asarray(a.detach().cpu() if isinstance(a, torch.Tensor) else a,
                            dtype=np.float64) for a in arrays)


def _create(times, states, inputs, dtype, device) -> TargetTrajectories:
    dev = resolve_device(device)
    return TargetTrajectories.create(*(torch.as_tensor(np.asarray(a, dtype=np.float64),
                                                       dtype=dtype, device=dev)
                                       for a in (times, states, inputs)))


def _pose_to_trajectories(
    ee_target_pose, base_target_pose, observation, ee_state, t_now, t_target,
    default_joint_state, com_height, feet_height,
):
    """targetPoseToTargetTrajectories (node.cpp:59-84): 2-knot, 37-dim."""
    base_current = np.array(observation[6:12], dtype=float)
    base_current[2] = com_height + feet_height
    base_current[4] = 0.0
    base_current[5] = 0.0

    s0 = np.concatenate([np.zeros(6), base_current, default_joint_state, ee_state])
    s1 = np.concatenate([np.zeros(6), base_target_pose, default_joint_state, ee_target_pose])
    return (
        np.array([t_now, t_target]),
        np.stack([s0, s1]),
        np.zeros((2, 30)),
    )


def ee_goal_to_target_trajectories(
    position, orientation_xyzw, observation, ee_state, t_now, cfg, feet_height=0.0,
    dtype=torch.float64, device=None,
):
    """EEgoalPoseToTargetTrajectories (node.cpp:195-238)."""
    position, orientation_xyzw, observation, ee_state = _np(
        position, orientation_xyzw, observation, ee_state)
    ref = cfg.reference
    ee_target = np.concatenate([position, orientation_xyzw])
    yaw = _quat_yaw(orientation_xyzw)
    base_target = np.array(observation[6:12], dtype=float)
    base_target[0] = position[0] - ARM_DIST * np.cos(yaw)
    base_target[1] = position[1] - ARM_DIST * np.sin(yaw)
    base_target[2] = ref.com_height + feet_height
    base_target[3] = yaw
    base_target[4] = 0.0
    base_target[5] = 0.0

    dpos = ee_target[:3] - np.array(ee_state[:3])
    drot = _quat_distance(np.array(ee_state[3:7]), orientation_xyzw)
    t_disp = np.linalg.norm(dpos) / ref.target_displacement_velocity
    t_rot = np.linalg.norm(drot) / ref.target_rotation_velocity
    t_target = t_now + max(t_disp, t_rot)

    times, states, inputs = _pose_to_trajectories(
        ee_target, base_target, observation, np.array(ee_state),
        t_now, t_target, ref.default_joint_state, ref.com_height, feet_height,
    )
    return _create(times, states, inputs, dtype, device)


def cmd_vel_to_target_trajectories(
    cmd_vel, last_ee_target, observation, ee_state, t_now, cfg, feet_height=0.0,
    dtype=torch.float64, device=None,
):
    """cmdVelToTargetTrajectories (node.cpp:89-129): base twist command.

    cmd_vel = [vx, vy, vz, yaw_rate] in base frame. The EE target is sticky
    (last target; re-anchored when it drifts >0.1 m from the measured EE).
    Desired momentum head(3) is set to the rotated velocity.
    """
    cmd_vel, last_ee_target, observation, ee_state = _np(
        cmd_vel, last_ee_target, observation, ee_state)
    ref = cfg.reference
    base_pose = np.array(observation[6:12], dtype=float)
    cz, sz = np.cos(base_pose[3]), np.sin(base_pose[3])
    cy, sy = np.cos(base_pose[4]), np.sin(base_pose[4])
    cx, sx = np.cos(base_pose[5]), np.sin(base_pose[5])
    Rz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
    Ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    Rx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
    v_world = Rz @ Ry @ Rx @ np.array(cmd_vel[:3])

    T = cfg.mpc.time_horizon
    base_target = np.array(base_pose)
    base_target[0] += v_world[0] * T
    base_target[1] += v_world[1] * T
    base_target[2] = ref.com_height + feet_height
    base_target[3] += cmd_vel[3] * T
    base_target[4] = 0.0
    base_target[5] = 0.0

    last_ee_target = np.array(last_ee_target, dtype=float)
    if np.linalg.norm(last_ee_target[:3] - np.array(ee_state[:3])) > 0.1:
        last_ee_target[:3] = np.array(ee_state[:3])

    times, states, inputs = _pose_to_trajectories(
        last_ee_target, base_target, observation, last_ee_target,
        t_now, t_now + T, ref.default_joint_state, ref.com_height, feet_height,
    )
    states[0][0:3] = v_world
    states[1][0:3] = v_world
    return _create(times, states, inputs, dtype, device), last_ee_target


def ee_cmd_vel_to_target_trajectories(
    cmd_vel, last_ee_target, observation, ee_state, t_now, cfg, feet_height=0.0,
    dtype=torch.float64, device=None,
):
    """EeCmdVelToTargetTrajectories (node.cpp:134-188): EE twist command in the
    EE frame (de-rotated by the initial base yaw)."""
    cmd_vel, last_ee_target, observation, ee_state = _np(
        cmd_vel, last_ee_target, observation, ee_state)
    ref = cfg.reference
    ee_current = np.array(ee_state, dtype=float)
    base_pose = np.array(observation[6:12], dtype=float)

    q = ee_current[3:7]
    x, y, z, w = q
    R_ee = np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ]
    )
    psi = base_pose[3]
    R_init = np.array(
        [[np.cos(psi), -np.sin(psi), 0], [np.sin(psi), np.cos(psi), 0], [0, 0, 1]]
    )
    v_world = R_ee @ R_init.T @ np.array(cmd_vel[:3])

    T = cfg.mpc.time_horizon
    last_ee_target = np.array(last_ee_target, dtype=float)
    ee_target = np.array(ee_current)
    ee_target[0] = ee_current[0] + v_world[0] * T
    ee_target[1] = ee_current[1] + v_world[1] * T
    ee_target[2] = last_ee_target[2]
    ee_target[3] = last_ee_target[3]
    ee_target[4] = last_ee_target[4]
    ee_target[5] = ee_current[5] + np.sin(v_world[2] * T / 2)
    ee_target[6] = ee_current[6] + np.cos(v_world[2] * T / 2)

    yaw = _quat_yaw(ee_target[3:7])
    base_target = np.array(base_pose)
    base_target[0] = ee_target[0] - ARM_DIST * np.cos(psi)
    base_target[1] = ee_target[1] - ARM_DIST * np.sin(psi)
    base_target[2] = ref.com_height + feet_height
    base_target[3] = yaw
    base_target[4] = 0.0
    base_target[5] = 0.0

    times, states, inputs = _pose_to_trajectories(
        ee_target, base_target, observation, ee_current,
        t_now, t_now + T, ref.default_joint_state, ref.com_height, feet_height,
    )
    return _create(times, states, inputs, dtype, device)


def initial_target(observation, rbd_measured, cfg, x_init, t_now=0.0, dtype=torch.float64,
                   device=None):
    """QMController::starting initial target: hold the current base state,
    send the EE to the nominal start pose."""
    observation, rbd_measured, x_init = _np(observation, rbd_measured, x_init)
    base_z = float(rbd_measured[5])
    ee_pos = np.array(
        [
            START_X + ARM_DIST * np.cos(START_PSI),
            START_Y + ARM_DIST * np.sin(START_PSI),
            START_HEIGHT + base_z,
        ]
    )
    ee_quat = np.array([0.0, 0.0, np.sin(START_PSI / 2), np.cos(START_PSI / 2)])
    arm_init = np.array(x_init[24:30])
    state = np.concatenate([np.array(observation[:24]), arm_init, ee_pos, ee_quat])
    # single-knot trajectory (clamped interpolation repeats it)
    return _create(np.array([t_now]), state[None, :], np.zeros((1, 30)), dtype, device)
