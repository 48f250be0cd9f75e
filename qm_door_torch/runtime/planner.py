"""High-level planners (port of qm_door_tpu/runtime/planner.py, the
qm_planner replacement). Host code, no tensors.

CirclePlanner mirrors qm_planner/src/TestCircle.cpp: drive the arm EE along a
circle (default r = 1.2 m about (-1.4, 0, 1.0)) by emitting EE goal poses;
switch gait to trot once the first waypoint is reached; advance when the
measured EE is within 0.07 m of the target. The ROS pub/sub plumbing becomes
a stepwise host object: call ``update(ee_pos, t)`` at planner rate (10 Hz)
and it returns the current goal pose (position, quat xyzw) or None when
unchanged.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Tuple

import numpy as np

from .gait_command import GaitCommander


@dataclass
class CirclePlanner:
    gait: Optional[GaitCommander] = None
    radius: float = 1.2
    center: Tuple[float, float, float] = (-1.4, 0.0, 1.0)
    angle_increment: float = 0.1
    reach_threshold: float = 0.07
    trot_delay: float = 5.0

    angle: float = field(default=0.0, init=False)
    initial_reached: bool = field(default=False, init=False)
    _trot_at: Optional[float] = field(default=None, init=False)
    _target: np.ndarray = field(default=None, init=False)

    def __post_init__(self):
        cx, cy, cz = self.center
        self._target = np.array([cx, cy, cz])

    @property
    def target_pose(self):
        return np.concatenate([self._target, [0.0, 0.0, 0.0, 1.0]])

    def update(self, ee_pos, t):
        """Advance the plan. Returns the target pose (7,) to command."""
        reached = np.linalg.norm(np.asarray(ee_pos) - self._target) < self.reach_threshold

        if reached and not self.initial_reached:
            self.initial_reached = True
            if self.gait is not None:
                self.gait.command("trot", t)
            self._trot_at = t + self.trot_delay
            return self.target_pose

        if self._trot_at is not None and t < self._trot_at:
            return self.target_pose  # waiting out the gait transition

        if reached and self.initial_reached:
            cx, cy, cz = self.center
            self._target = np.array(
                [
                    cx + self.radius * np.cos(self.angle),
                    cy + self.radius * np.sin(self.angle),
                    cz,
                ]
            )
            self.angle += self.angle_increment
            if self.angle >= 2 * np.pi:
                self.angle = 0.0
        return self.target_pose
