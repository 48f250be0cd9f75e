"""State estimation layer (port of qm_door_tpu/estimation; replaces
qm_estimation).

- :mod:`base` — rbdState assembly, IMU synthesis, mode from contact flags,
  and the ground-truth estimator (FromTopicStateEstimate parity).
- :mod:`kalman` — linear Kalman filter fusing IMU and leg odometry.
"""
from .base import GroundTruthEstimate, assemble_rbd, imu_from_state, mode_from_flags
from .kalman import KalmanFilterEstimate, KfParams, KfState

__all__ = [
    "GroundTruthEstimate",
    "KalmanFilterEstimate",
    "KfParams",
    "KfState",
    "assemble_rbd",
    "imu_from_state",
    "mode_from_flags",
]
