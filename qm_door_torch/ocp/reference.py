"""Target trajectories: desired-state storage + interpolation (port of
qm_door_tpu/ocp/reference.py).

States carry 37 dims = 30 centroidal state + 7 EE pose [pos(3), quat
xyzw(4)]. Fixed shape: K knots padded by repeating the final knot so that
interpolation clamps (ocs2 LinearInterpolation clamping).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from ..models import spatial


@dataclass(frozen=True)
class TargetTrajectories:
    times: torch.Tensor   # (K,)
    states: torch.Tensor  # (K, 37)
    inputs: torch.Tensor  # (K, 30)

    @staticmethod
    def create(times, states, inputs, max_knots: int = 8):
        """Padded TargetTrajectories from tensors of <= max_knots rows."""
        k = times.shape[0]
        pad = max_knots - k
        if pad < 0:
            raise ValueError(f"too many knots ({k} > {max_knots})")
        if pad:
            times = torch.cat([times, times[-1:].expand(pad) + 1e6])
            states = torch.cat([states, states[-1:].expand(pad, -1)])
            inputs = torch.cat([inputs, inputs[-1:].expand(pad, -1)])
        return TargetTrajectories(times=times, states=states, inputs=inputs)

    def _segment(self, t):
        """(index, alpha) for times t (...,), alpha the weight of the left
        knot (ocs2 LinearInterpolation::timeSegment semantics, clamped)."""
        K = self.times.shape[0]
        idx = torch.clamp(
            torch.searchsorted(self.times, t, right=True) - 1, 0, K - 2)
        t0 = self.times[idx]
        t1 = self.times[idx + 1]
        denom = torch.where(torch.abs(t1 - t0) < 1e-12, torch.ones_like(t0), t1 - t0)
        alpha = torch.clamp(1.0 - (t - t0) / denom, 0.0, 1.0)
        return idx, alpha

    def desired_state(self, t):
        """Linear interpolation of the full 37-dim desired state at t (...,)."""
        idx, alpha = self._segment(t)
        a = alpha[..., None]
        return a * self.states[idx] + (1.0 - a) * self.states[idx + 1]

    def ee_pose(self, t):
        """(position, quaternion) of the desired EE pose at t (...,): lerp +
        slerp (EndEffectorConstraint::interpolateEndEffectorPose)."""
        idx, alpha = self._segment(t)
        a = alpha[..., None]
        lhs = self.states[idx, 30:37]
        rhs = self.states[idx + 1, 30:37]
        pos = a * lhs[..., :3] + (1.0 - a) * rhs[..., :3]
        quat = spatial.quat_slerp(lhs[..., 3:], rhs[..., 3:], 1.0 - a)
        return pos, quat
