"""Safety checker (port of qm_door_tpu/runtime/safety.py;
qm_controllers SafetyChecker.h:25-32): stop the controller when the base
roll or pitch leaves +-pi/2."""
from __future__ import annotations

import math

import torch


def safety_check(x_obs, limit=math.pi / 2):
    """(...,) bool, True = safe. ``x_obs`` (..., 30) is the centroidal
    observation; the base euler zyx sits at [9:12] = (yaw, pitch, roll)."""
    pitch = x_obs[..., 10]
    roll = x_obs[..., 11]
    return (torch.abs(pitch) < limit) & (torch.abs(roll) < limit)
