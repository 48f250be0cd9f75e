"""Plain optimal-control problem of the benchmark's reference: the stage data
a configuration defines (contact schedule, swing-foot height references,
nominal input, end-effector target, wrench reference), the stage and
terminal costs, and the state-input equalities, one node at a time.

Everything is derived again from the configuration file and the model file;
nothing is read from the program under test.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from . import model as rb


@dataclass(frozen=True)
class Weights:
    Q: torch.Tensor          # (30, 30)
    R: torch.Tensor          # (nu, nu)
    ee: torch.Tensor         # (6,) stage EE weights
    ee_final: torch.Tensor   # (6,)
    mu: float                # friction coefficient
    cone_mu: float
    cone_delta: float
    cone_reg: float
    pos_mu: float
    pos_delta: float
    vel_mu: float
    vel_delta: float
    arm_pos: tuple           # (lower (6,), upper (6,))
    arm_vel: tuple


def _tensor(a, like):
    return torch.as_tensor(np.asarray(a, dtype=np.float64), dtype=like.dtype, device=like.device)


def weights(cfg, m: rb.Model) -> Weights:
    """Cost weights of the configuration. R's foot-velocity block is mapped
    into joint velocities through the feet's leg-joint Jacobian at the
    initial state (the reference controller's input-cost mapping)."""
    c = cfg["cost"]
    t = lambda a: _tensor(a, m.body_mass)  # noqa: E731
    r = np.concatenate([np.full(12, c["r_forces"]), np.full(12, c["r_foot_velocity"]),
                        np.full(6, c["r_arm_velocity"])]) * c["r_scaling"]
    q0 = torch.as_tensor(cfg["initial_state"][6:30], dtype=torch.float64)
    m64 = rb.Model(**{k: (v.double().cpu() if isinstance(v, torch.Tensor) else v)
                      for k, v in vars(m).items()})
    J = torch.func.jacfwd(lambda q: rb.feet(m64, q).reshape(12))(q0)[:, 6:18].numpy()
    R = np.diag(r)
    R[12:24, 12:24] = J.T @ np.diag(r[12:24]) @ J
    nu = cfg["nu"]
    if nu == 36:
        ft = cfg["force_tracking"]
        R36 = np.zeros((36, 36))
        R36[:30, :30] = R
        R36[30:, 30:] = np.diag(np.r_[np.full(3, ft["r_ee_force"]),
                                      np.full(3, ft["r_ee_torque"])] * c["r_scaling"])
        R = R36
    f, jl = cfg["friction"], cfg["joint_limits"]
    ee = lambda p, o: t([p] * 3 + [o] * 3)  # noqa: E731
    return Weights(
        Q=t(np.diag(c["q_diag"])), R=t(R),
        ee=ee(c["ee_mu_position"], c["ee_mu_orientation"]),
        ee_final=ee(c["final_ee_mu_position"], c["final_ee_mu_orientation"]),
        mu=f["friction_coefficient"], cone_mu=f["barrier_mu"], cone_delta=f["barrier_delta"],
        cone_reg=f["cone_regularization"], pos_mu=jl["position_mu"],
        pos_delta=jl["position_delta"], vel_mu=jl["velocity_mu"], vel_delta=jl["velocity_delta"],
        arm_pos=(m.pos_lower[12:18], m.pos_upper[12:18]),
        arm_vel=(t(jl["arm_velocity_lower"]), t(jl["arm_velocity_upper"])))


# --- stage data ----------------------------------------------------------------

def _events(gait, until):
    """Switching times and the contact flags after each: the gait's cycle
    tiled from t = 0 (a stance phase before it), the times accumulated
    cycle by cycle."""
    modes, st = gait["modes"], gait["switching_times"]
    times, flags = [0.0], [[1, 1, 1, 1]]
    t0 = 0.0
    while times[-1] < until:
        for k, mode in enumerate(modes):
            flags.append(mode)
            times.append(t0 + (st[k + 1] - st[0]))
        t0 = times[-1]
    flags.append(flags[-1])
    return np.asarray(times), np.asarray(flags, dtype=np.float64)


def _hermite(t, t0, t1, p0, v0, p1, v1):
    """Position and velocity of the cubic Hermite segment at t."""
    h = max(t1 - t0, 1e-9)
    s = min(max((t - t0) / h, 0.0), 1.0)
    p = ((2 * s**3 - 3 * s**2 + 1) * p0 + (s**3 - 2 * s**2 + s) * h * v0
         + (-2 * s**3 + 3 * s**2) * p1 + (s**3 - s**2) * h * v1)
    v = ((6 * s**2 - 6 * s) * p0 + (-6 * s**2 + 6 * s) * p1) / h \
        + (3 * s**2 - 4 * s + 1) * v0 + (3 * s**2 - 2 * s) * v1
    return p, v


def _swing_velocity(t, lo, hi, sw):
    """Vertical velocity reference of a foot at t in its swing [lo, hi] on
    flat ground: up to the apex at mid-swing and down again, two cubic
    segments, the lift-off and touch-down speeds scaled by the swing's
    duration against swing_time_scale."""
    s = min(1.0, (hi - lo) / sw["swing_time_scale"])
    apex = sw["swing_height"] * s
    mid = 0.5 * (lo + hi)
    if t <= mid:
        return _hermite(t, lo, mid, 0.0, sw["lift_off_velocity"] * s, apex, 0.0)[1]
    return _hermite(t, mid, hi, apex, 0.0, 0.0, sw["touch_down_velocity"] * s)[1]


def stage(cfg, m: rb.Model, t0: float):
    """The stage data of the horizon that starts at ``t0``: a dict of
    tensors over the N+1 nodes (flags (N+1, 4), z_vel (N+1, 4), u_nom
    (N+1, nu), x_nom (N+1, 30), ee_pos (3,), ee_rot (3, 3), grasp (N+1,))."""
    dt = cfg["sqp"]["dt"]
    n = int(round(cfg["horizon_s"] / dt))
    times = t0 + dt * np.arange(n + 1)
    sw = cfg["swing"]
    end = times[-1] + sw["touchdown_after_horizon"]
    ev, ev_flags = _events(cfg["gait"], end + 1.0)
    flags = ev_flags[np.searchsorted(ev, times, side="right")]
    z_vel = np.zeros((n + 1, 4))
    bounds = np.r_[-np.inf, ev, np.inf]
    for foot in range(4):
        # runs of equal contact, each over [bounds[i], bounds[j]]
        f = ev_flags[:, foot]
        i = 0
        while i < len(f):
            j = i
            while j + 1 < len(f) and f[j + 1] == f[i]:
                j += 1
            lo, hi = bounds[i], bounds[j + 1]
            if f[i] == 0 and np.isfinite(lo) and np.isfinite(hi):
                for k in np.nonzero((times >= lo - 1e-9) & (times <= hi + 1e-9))[0]:
                    z_vel[k, foot] = _swing_velocity(times[k], lo, hi, sw)
            i = j + 1
    t = lambda a: _tensor(a, m.body_mass)  # noqa: E731
    fz = float(m.mass) * rb.GRAVITY / np.maximum(flags.sum(-1, keepdims=True), 1.0)
    F = np.zeros((n + 1, 4, 3))
    F[..., 2] = flags * fz
    u_nom = np.concatenate([F.reshape(n + 1, 12), np.zeros((n + 1, 18))], axis=1)
    grasp = np.zeros(n + 1)
    if cfg["nu"] == 36:
        ft = cfg["force_tracking"]
        grasp[:] = ft["grasp"]
        w = np.asarray(ft["wrench_ref"])[None] * grasp[:, None]
        share = -w[:, :3] / np.maximum(flags.sum(-1, keepdims=True), 1.0)
        u_nom[:, :12] += (flags[..., None] * share[:, None, :]).reshape(n + 1, 12)
        u_nom = np.concatenate([u_nom, w], axis=1)
    if "target" in cfg:
        tg = cfg["target"]
        x_nom, p_ee = t(tg["state"]), t(tg["ee_position"])
        R_ee = t(_quat_rotation(tg["ee_quat"]))
    else:
        x_nom = t(cfg["initial_state"])
        R_ee, p_ee = rb.ee_pose(m, x_nom[6:30])
    return dict(flags=t(flags), z_vel=t(z_vel), u_nom=t(u_nom),
                x_nom=x_nom.expand(n + 1, 30), ee_pos=p_ee, ee_rot=R_ee, grasp=t(grasp))


def _quat_rotation(q):
    """The rotation matrix of a unit quaternion (x, y, z, w), numpy float64."""
    x, y, z, w = np.asarray(q, dtype=np.float64) / np.linalg.norm(q)
    return np.array([[1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
                     [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
                     [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)]])


# --- costs and constraints (one node) ----------------------------------------------

def ee_error(m: rb.Model, x, ee_pos, ee_rot):
    """End-effector pose error: position, and the vector part of the
    quaternion of R_ref R^T (the orientation error of the reference's
    end-effector soft constraint, up to a sign that no cost term sees)."""
    R, p = rb.ee_pose(m, x[6:30])
    M = ee_rot @ R.transpose(-1, -2)
    ori = rb.vee(M - M.transpose(-1, -2)) / (2.0 * torch.sqrt(1.0 + torch.trace(M)))
    return torch.cat([p - ee_pos, ori])


def relaxed_barrier(h, mu, delta):
    """-mu ln(h) above delta, its quadratic extension below."""
    z = (h - 2.0 * delta) / delta
    quad = mu * (-math.log(delta) + 0.5 * z * z - 0.5)
    return torch.where(h >= delta, -mu * torch.log(torch.clamp(h, min=delta)), quad)


def smooth_cost(w: Weights, flags, x_nom, u_nom, x, u, magnitude=False):
    """The stage cost without the end-effector term: quadratic tracking,
    the friction-cone barrier of each stance foot, the arm's soft position
    and velocity boxes. ``magnitude``: each barrier term taken by its
    absolute value (the barriers are negative far from their bounds, so
    the cost can sum to near 0 from terms of a few units)."""
    size = torch.abs if magnitude else (lambda t: t)
    dx, du = x - x_nom, u - u_nom
    c = 0.5 * dx @ w.Q @ dx + 0.5 * du @ w.R @ du
    F = u[0:12].reshape(4, 3)
    h = w.mu * F[:, 2] - torch.sqrt(F[:, 0] ** 2 + F[:, 1] ** 2 + w.cone_reg)
    c = c + torch.sum(size(flags * relaxed_barrier(h, w.cone_mu, w.cone_delta)))
    for z, (lo, hi), mu, delta in ((x[24:30], w.arm_pos, w.pos_mu, w.pos_delta),
                                   (u[24:30], w.arm_vel, w.vel_mu, w.vel_delta)):
        c = c + torch.sum(size(relaxed_barrier(hi - z, mu, delta))
                          + size(relaxed_barrier(z - lo, mu, delta)))
    return c


def velocity_rows(flags):
    """(12) 0/1 rows of the foot-velocity equality: all three of a stance
    foot, the vertical one of a swing foot."""
    rows = torch.stack([flags, flags, torch.ones_like(flags)], dim=-1)
    return rows.reshape(*flags.shape[:-1], 12)


def velocity_constraint(m: rb.Model, flags, z_vel, x, u):
    """Stance feet still, swing feet on their vertical velocity reference."""
    rhs = torch.stack([torch.zeros_like(flags), torch.zeros_like(flags),
                       (1.0 - flags) * z_vel], dim=-1).reshape(12)
    return velocity_rows(flags) * (rb.foot_velocities(m, x, u) - rhs)


def rk2(m: rb.Model, x, u, dt):
    """Heun's step with the input held over the interval."""
    k1 = rb.flow(m, x, u)
    return x + 0.5 * dt * (k1 + rb.flow(m, x + dt * k1, u))
