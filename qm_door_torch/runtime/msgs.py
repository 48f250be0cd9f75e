"""Transport message types (qm_msgs replacement; port of
qm_door_tpu/runtime/msgs.py, numpy, unchanged).

The reference defines three float64[] messages (qm_msgs/msg/{ee_state,
base_state, arm_torque}.msg) plus the ocs2 observation message. Here they are
typed dataclasses with flat-array (de)serialization for any transport (the
native mailbox, files, sockets). Field layouts preserved:

- EeState.state: [pos(3), quat xyzw(4)]  (filled at QMController.cpp:247-258)
- Observation: time, state(30), input(30), mode
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class EeState:
    time: float
    state: np.ndarray  # (7,) pos + quat xyzw

    def to_array(self):
        return np.concatenate([[self.time], self.state])

    @staticmethod
    def from_array(a):
        return EeState(time=float(a[0]), state=np.asarray(a[1:8]))


@dataclass
class BaseState:
    time: float
    state: np.ndarray  # (6,) pose

    def to_array(self):
        return np.concatenate([[self.time], self.state])

    @staticmethod
    def from_array(a):
        return BaseState(time=float(a[0]), state=np.asarray(a[1:7]))


@dataclass
class ArmTorque:
    time: float
    torque: np.ndarray  # (6,)

    def to_array(self):
        return np.concatenate([[self.time], self.torque])

    @staticmethod
    def from_array(a):
        return ArmTorque(time=float(a[0]), torque=np.asarray(a[1:7]))


@dataclass
class Observation:
    """ocs2_msgs/mpc_observation equivalent."""

    time: float
    state: np.ndarray  # (30,)
    input: np.ndarray  # (30,)
    mode: int

    def to_array(self):
        return np.concatenate([[self.time], self.state, self.input, [self.mode]])

    @staticmethod
    def from_array(a):
        return Observation(
            time=float(a[0]), state=np.asarray(a[1:31]), input=np.asarray(a[31:61]),
            mode=int(a[61]),
        )
