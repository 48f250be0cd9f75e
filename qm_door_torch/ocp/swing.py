"""Swing-foot z reference trajectories (SwingTrajectoryPlanner replacement).

Mirrors ocs2_legged_robot SwingTrajectoryPlanner: for each foot and swing
phase [t_liftoff, t_touchdown], two cubic Hermite segments
  liftoff(h0, v_lift*s) -> apex(midtime, h_apex, 0) -> touchdown(h1, v_td*s)
with s = min(1, phase_duration / swing_time_scale) and
h_apex = max(h0, h1) + swing_height * s. During stance the z-velocity
reference is 0 at the terrain height.

Settings from task.info swing_trajectory_config (liftOffVelocity 0.05,
touchDownVelocity -0.1, swingHeight 0.15, touchdownAfterHorizon 0.2,
swingTimeScale 0.15).

Host-side numpy: outputs fixed-shape (N+1, 4) arrays consumed by the
solver (the normal-velocity equality constraint and, when positionErrorGain
is nonzero, the z-position feedback term — QMPreComputation.cpp:56-71).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .gait import GaitSchedule


@dataclass
class SwingConfig:
    lift_off_velocity: float = 0.05
    touch_down_velocity: float = -0.1
    swing_height: float = 0.15
    touchdown_after_horizon: float = 0.2
    swing_time_scale: float = 0.15
    terrain_height: float = 0.0


def _hermite(t, t0, t1, p0, v0, p1, v1):
    """Cubic Hermite position and velocity at t."""
    dt = max(t1 - t0, 1e-9)
    s = np.clip((t - t0) / dt, 0.0, 1.0)
    h00 = 2 * s**3 - 3 * s**2 + 1
    h10 = s**3 - 2 * s**2 + s
    h01 = -2 * s**3 + 3 * s**2
    h11 = s**3 - s**2
    p = h00 * p0 + h10 * dt * v0 + h01 * p1 + h11 * dt * v1
    dh00 = 6 * s**2 - 6 * s
    dh10 = 3 * s**2 - 4 * s + 1
    dh01 = -6 * s**2 + 6 * s
    dh11 = 3 * s**2 - 2 * s
    v = (dh00 * p0 + dh01 * p1) / dt + dh10 * v0 + dh11 * v1
    return p, v


def _swing_ref(t, t0, t1, cfg: SwingConfig, h0, h1):
    """Position/velocity reference inside one swing phase with per-phase
    liftoff height h0 and touchdown height h1 (the reference's
    SwingTrajectoryPlanner carries exactly these two per-phase heights,
    task.info:24-31)."""
    duration = t1 - t0
    s = min(1.0, duration / cfg.swing_time_scale) if cfg.swing_time_scale > 0 else 1.0
    apex = max(h0, h1) + cfg.swing_height * s
    tm = 0.5 * (t0 + t1)
    if t <= tm:
        return _hermite(t, t0, tm, h0, cfg.lift_off_velocity * s, apex, 0.0)
    return _hermite(t, tm, t1, apex, 0.0, h1, cfg.touch_down_velocity * s)


def compile_swing_references(schedule: GaitSchedule, times, cfg: SwingConfig,
                             phase_heights=None):
    """Per-node (z_pos_ref, z_vel_ref), each (N+1, 4).

    ``phase_heights``: optional callable ``(foot, t_liftoff, t_touchdown) ->
    (h0, h1)`` supplying TERRAIN-AWARE liftoff/touchdown heights for each
    swing phase (the ocs2 SwingTrajectoryPlanner per-phase liftOff/touchDown
    sequence). Default: flat ground at ``cfg.terrain_height``. Stance nodes
    hold the relevant phase height.
    """
    times = np.asarray(times)
    horizon_end = times[-1] + cfg.touchdown_after_horizon
    n = len(times)
    z_pos = np.full((n, 4), cfg.terrain_height)
    z_vel = np.zeros((n, 4))
    for foot in range(4):
        phases = schedule.contact_phases(foot, times[0], horizon_end)
        for (t0, t1, in_contact) in phases:
            lo = t0 if np.isfinite(t0) else times[0] - 1.0
            hi = t1 if np.isfinite(t1) else horizon_end + cfg.touchdown_after_horizon
            mask = (times >= lo - 1e-9) & (times <= hi + 1e-9)
            if in_contact:
                if phase_heights is not None:
                    # stance: hold the terrain height under the stance foot
                    h0, _ = phase_heights(foot, lo, hi)
                    z_pos[mask, foot] = h0
                continue
            if phase_heights is not None:
                h0, h1 = phase_heights(foot, lo, hi)
            else:
                h0 = h1 = cfg.terrain_height
            for i in np.nonzero(mask)[0]:
                p, v = _swing_ref(times[i], lo, hi, cfg, h0, h1)
                z_pos[i, foot] = p
                z_vel[i, foot] = v
    return z_pos, z_vel
