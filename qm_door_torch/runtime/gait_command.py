"""Gait command interface (port of qm_door_tpu/runtime/gait_command.py:
GaitTopicPublisher / GaitJoyPublisher / GaitReceiver replacement,
qm_controllers/src/GaitTopicPublisher.cpp:75-105). Host code, no tensors.

The ROS topic plumbing collapses to a direct host-side call: a named gait from
the 12-template library is inserted into the active GaitSchedule at the end of
the current MPC horizon — exactly when the reference's solver-synchronized
GaitReceiver applies it (at the next preSolverRun, taking effect after the
current horizon's committed plan).
"""
from __future__ import annotations

from ..ocp.gait import GAIT_LIBRARY, GaitSchedule, ModeSequenceTemplate


class GaitCommander:
    def __init__(self, schedule: GaitSchedule, time_horizon: float = 1.0):
        self.schedule = schedule
        self.time_horizon = time_horizon
        self._last_joy_gait = "stance"  # the joystick's last applied gait

    def command(self, gait_name: str, t_now: float):
        """Switch to a named gait (the '/gait_command_topic' role)."""
        if gait_name not in GAIT_LIBRARY:
            raise KeyError(
                f"unknown gait '{gait_name}'; available: {sorted(GAIT_LIBRARY)}"
            )
        template = GAIT_LIBRARY[gait_name]
        start = t_now + self.time_horizon
        self.schedule.insert_template(template, start, start + 2 * self.time_horizon)

    def command_template(self, template: ModeSequenceTemplate, t_now: float):
        start = t_now + self.time_horizon
        self.schedule.insert_template(template, start, start + 2 * self.time_horizon)

    def joy_buttons(self, buttons, t_now: float):
        """Joystick mapping (GaitJoyPublisher.cpp:35-60): deadman button 4
        held + button 0 -> trot, + button 1 -> stance; a command is applied
        only when it CHANGES (the reference tracks lastGaitCommand_)."""
        b = list(buttons) + [0] * (5 - len(buttons))
        gait = None
        if b[4] and b[0]:
            gait = "trot"
        if b[4] and b[1]:
            gait = "stance"  # stance wins on both, like the reference
        if gait is None or gait == self._last_joy_gait:
            return None
        self._last_joy_gait = gait
        self.command(gait, t_now)
        return gait


class JoyTeleop:
    """Joystick axis mapping (qm_controllers/config/joy.yaml): deadman-gated
    twists for the base (cmd_vel) and the end-effector (ee_cmd_vel).

    walk (deadman button 4): axes (0, 1, 3) -> (vy 0.3, vx 0.5, wz 1.57)
    ee   (deadman button 5): axes (0, 1, 4) -> (vy 0.3, vx 0.5, vz 0.1)

    Returns 4-vectors in the shape the target converters expect
    (runtime/targets.py cmd_vel_to_target_trajectories /
    ee_cmd_vel_to_target_trajectories).
    """

    WALK_DEADMAN = 4
    EE_DEADMAN = 5

    def cmd_vel(self, axes, buttons):
        a = list(axes) + [0.0] * (5 - len(axes))
        b = list(buttons) + [0] * (6 - len(buttons))
        if not b[self.WALK_DEADMAN]:
            return None
        return [0.5 * a[1], 0.3 * a[0], 0.0, 1.57 * a[3]]

    def ee_cmd_vel(self, axes, buttons):
        a = list(axes) + [0.0] * (5 - len(axes))
        b = list(buttons) + [0] * (6 - len(buttons))
        if not b[self.EE_DEADMAN]:
            return None
        return [0.5 * a[1], 0.3 * a[0], 0.1 * a[4], 0.0]
