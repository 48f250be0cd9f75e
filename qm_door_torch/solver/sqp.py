"""SQP MPC solver pieces (port of qm_door_tpu/solver/sqp.py): the
trajectory merit of the linesearch, the solver settings, and the solver's
static state. The iteration itself is solver/batched_sqp.py.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..models.model import RobotModel
from ..ocp import constraints as cons
from ..ocp.problem import OcpConfig, StageData, stage_cost, terminal_cost
from .transcription import check_linearization, rk2_step


def evaluate_trajectory(model: RobotModel, ocp: OcpConfig, stage: StageData, dt, X, U):
    """(cost, violation_sse) of trajectories X (..., N+1, 30), U (..., N, 30)
    — the linesearch merit pieces, batched over the leading dims.

    violation = dynamics defects SSE + projected equality constraint SSE
    (foot-velocity rows + swing-foot forces), the OCS2 filter linesearch's
    equality metric.
    """
    N = U.shape[-2]
    row = stage.rows(slice(0, N))
    x, x_next = X[..., :-1, :], X[..., 1:, :]
    costs = stage_cost(model, ocp, row, x, U)                          # (..., N)
    total_cost = dt * torch.sum(costs, dim=-1) + terminal_cost(model, ocp, stage, X[..., -1, :])
    defects = rk2_step(model, x, U, dt) - x_next
    g = cons.velocity_constraint(model, x, U, row.contact_flags, row.z_vel_ref)
    zero_force = (1.0 - torch.repeat_interleave(row.contact_flags, 3, dim=-1)) * U[..., 0:12]
    eq_sse = torch.sum(torch.sum(g * g, dim=-1) + torch.sum(zero_force * zero_force, dim=-1),
                       dim=-1)
    violation = torch.sum(defects * defects, dim=(-2, -1)) + eq_sse
    return total_cost, violation


class _SqpSettingsStatic(NamedTuple):
    """The SqpSettings the iteration reads."""

    dt: float
    sqp_iterations: int
    g_max: float
    g_min: float
    armijo_factor: float
    max_step: float
    min_step: float
    step_reduction: float
    hessian_shift: float
    linesearch_steps: int = 4
    sensitivity: str = "frozen"  # RK2 discrete-sensitivity mode (config.py)
    lin_tangents: str = "analytic"  # linearization derivative mode (config.py)


def _settings_static(cfg_sqp) -> _SqpSettingsStatic:
    """Settings from config.SqpSettings; rejects linearization modes that are
    unknown or not ported."""
    check_linearization(cfg_sqp.lin_tangents, cfg_sqp.sensitivity)
    return _SqpSettingsStatic(
        dt=cfg_sqp.dt,
        sqp_iterations=cfg_sqp.sqp_iterations,
        g_max=cfg_sqp.g_max,
        g_min=cfg_sqp.g_min,
        armijo_factor=cfg_sqp.armijo_factor,
        max_step=cfg_sqp.max_step,
        min_step=cfg_sqp.min_step,
        step_reduction=cfg_sqp.step_reduction,
        hessian_shift=cfg_sqp.hessian_shift,
        linesearch_steps=cfg_sqp.linesearch_steps,
        sensitivity=cfg_sqp.sensitivity,
        lin_tangents=cfg_sqp.lin_tangents,
    )


class SqpSolver:
    """MPC-mode SQP solver state (SqpMpc equivalent): the problem
    definition, the settings and the horizon length. Solves run batched
    through parallel/batched.py:BatchedMpc."""

    def __init__(self, model: RobotModel, ocp: OcpConfig, cfg):
        self.model = model
        self.ocp = ocp
        self.cfg = cfg
        self.settings = _settings_static(cfg.sqp)
        self.n_intervals = int(round(cfg.mpc.time_horizon / cfg.sqp.dt))

    def cold_start(self, stage: StageData, x_init):
        """Initializer trajectory: constant state, weight-compensating input
        (QMInitializer::compute)."""
        N = self.n_intervals
        X = x_init[None].expand(N + 1, -1).clone()
        U = stage.u_nom[:N].clone()
        return X, U
