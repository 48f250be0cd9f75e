"""SQP MPC solver: linearize -> project -> Riccati -> linesearch (port of
qm_door_tpu/solver/sqp.py).

``sqp_iteration`` is one scenario's iteration (per-scenario projection and
sweeps, the filter linesearch over the whole alpha grid in one batched
evaluation); ``SqpSolver.solve`` runs ``sqp_iterations`` of them from a
cold start or from the previous solution shifted onto the new grid. The
batched serving iteration is solver/batched_sqp.py.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import torch

from ..models.model import RobotModel
from ..ocp import constraints as cons
from ..ocp.problem import OcpConfig, StageData, stage_cost, terminal_cost
from .riccati import lqr_solve
from .transcription import (PROJECTIONS, LqProblem, check_linearization, linearize_ocp,
                            project_ocp, rk2_step)

RICCATI = ("scan", "parallel")


@dataclass(frozen=True)
class SqpSolution:
    """Primal solution of one MPC solve."""

    times: torch.Tensor  # (N+1,)
    X: torch.Tensor      # (N+1, 30)
    U: torch.Tensor      # (N, nu)
    cost: torch.Tensor
    constraint_violation: torch.Tensor
    step_size: torch.Tensor


def _pinned_input_sse(ocp: OcpConfig, stage: StageData, U):
    """SSE a node (..., N) of the inputs the projection pins: swing-foot
    forces, the EE wrench off-grasp (nu = 36), and the arm velocities under
    ``arm_locked``."""
    N = U.shape[-2]
    swing = 1.0 - torch.repeat_interleave(stage.contact_flags[..., :N, :], 3, dim=-1)
    sse = torch.sum((swing * U[..., 0:12]) ** 2, dim=-1)
    if U.shape[-1] == 36:  # force tracking: zero wrench off-grasp
        off = 1.0 - stage.grasp_flags[..., :N, None]
        sse = sse + torch.sum((off * U[..., 30:36]) ** 2, dim=-1)
    if ocp.arm_locked:  # quad-only: arm velocity inputs pinned to zero
        sse = sse + torch.sum(U[..., 24:30] ** 2, dim=-1)
    return sse


def evaluate_trajectory(model: RobotModel, ocp: OcpConfig, stage: StageData, dt, X, U):
    """(cost, violation_sse) of trajectories X (..., N+1, 30), U (..., N, nu)
    — the linesearch merit pieces, batched over the leading dims (stage data
    shared, or with the same leading dims).

    violation = dynamics defects SSE + projected equality constraint SSE
    (foot-velocity rows + the pinned inputs), the OCS2 filter linesearch's
    equality metric.
    """
    N = U.shape[-2]
    row = stage.rows(slice(0, N))
    x, x_next = X[..., :-1, :], X[..., 1:, :]
    costs = stage_cost(model, ocp, row, x, U)                          # (..., N)
    total_cost = dt * torch.sum(costs, dim=-1) + terminal_cost(model, ocp, stage, X[..., -1, :])
    defects = rk2_step(model, x, U, dt) - x_next
    g = cons.velocity_constraint(model, x, U, row.contact_flags, row.z_vel_ref)
    eq_sse = torch.sum(torch.sum(g * g, dim=-1) + _pinned_input_sse(ocp, stage, U), dim=-1)
    violation = torch.sum(defects * defects, dim=(-2, -1)) + eq_sse
    return total_cost, violation


def baseline_violation(ocp: OcpConfig, stage: StageData, lq: LqProblem, U):
    """The current iterate's violation from the linearization byproducts:
    lq.d holds the RK2 defects and lq.g0 the masked velocity equalities, so
    only the pinned inputs' term is computed anew."""
    return (torch.sum(lq.d * lq.d, dim=(-2, -1)) + torch.sum(lq.g0 * lq.g0, dim=(-2, -1))
            + torch.sum(_pinned_input_sse(ocp, stage, U), dim=-1))


def accept(cost0, viol0, costs, viols, alpha, settings):
    """OCS2 FilterLinesearch acceptance: an infeasible baseline (viol0 >
    g_max) needs a violation decrease, a feasible one (viol0 < g_min) a cost
    decrease, anything between either; never a non-finite trial."""
    decrease_viol = viols < (1.0 - 1e-3) * viol0
    decrease_cost = costs < cost0 - settings.armijo_factor * alpha * torch.abs(cost0)
    ok_infeasible = decrease_viol
    ok_feasible = decrease_cost & (viols < torch.clamp(2 * viol0, min=settings.g_max))
    ok_mixed = decrease_cost | decrease_viol
    ok = torch.where(
        viol0 > settings.g_max, ok_infeasible,
        torch.where(viol0 < settings.g_min, ok_feasible, ok_mixed))
    return ok & torch.isfinite(costs) & torch.isfinite(viols)


def _alpha_grid(settings, like):
    return settings.max_step * (settings.step_reduction ** torch.arange(
        settings.linesearch_steps, dtype=like.dtype, device=like.device))


def _linesearch(model, ocp, stage, dt, X, U, dX, dU, cost0, viol0, settings):
    """Filter linesearch over the whole alpha grid, every candidate in one
    batched trajectory evaluation; the largest accepted alpha wins.
    Returns (alpha, cost, violation), the baseline's where none is accepted."""
    alphas = _alpha_grid(settings, X)
    costs, viols = evaluate_trajectory(model, ocp, stage, dt,
                                       X + alphas[:, None, None] * dX,
                                       U + alphas[:, None, None] * dU)
    accepted = accept(cost0, viol0, costs, viols, alphas, settings)
    first = torch.argmax(accepted.to(torch.int64))  # the largest alpha first
    any_ok = torch.any(accepted)
    zero = torch.zeros((), dtype=X.dtype, device=X.device)
    return (torch.where(any_ok, alphas[first], zero), torch.where(any_ok, costs[first], cost0),
            torch.where(any_ok, viols[first], viol0))


def sqp_iteration(model: RobotModel, ocp: OcpConfig, stage: StageData, dt, settings,
                  x_init, X, U):
    """One SQP iteration of one scenario: X (N+1, 30), U (N, nu).
    Returns updated (X, U, (cost, violation, step_size)); the inputs are
    not modified."""
    if settings.riccati == "parallel":
        raise NotImplementedError("riccati='parallel' (the associative scan) is not ported yet")
    lq = linearize_ocp(model, ocp, stage, dt, X[None], U[None],
                       sensitivity=settings.sensitivity, tangents=settings.lin_tangents)
    lq = LqProblem(**{k: v[0] for k, v in vars(lq).items()})
    plq = project_ocp(lq, stage, U, shift=settings.hessian_shift, method=settings.projection,
                      arm_locked=ocp.arm_locked)
    dX, dU, _, _ = lqr_solve(plq, x_init - X[0])

    # the baseline merit comes free from the linearization byproducts
    cost0 = lq.cost
    viol0 = baseline_violation(ocp, stage, lq, U)
    alpha, cost_new, viol_new = _linesearch(
        model, ocp, stage, dt, X, U, dX, dU, cost0, viol0, settings)
    # always move the initial state to the measured one; a rejected step
    # (alpha = 0) keeps the iterate: where, not 0 * dX, so a non-finite step
    # cannot poison it
    take = alpha > 0.0
    X_new = torch.where(take, X + alpha * dX, X)
    U_new = torch.where(take, U + alpha * dU, U)
    X_new[0] = x_init  # X_new is a fresh tensor: the caller's X is untouched
    return X_new, U_new, (cost_new, viol_new, alpha)


class _SqpSettingsStatic(NamedTuple):
    """The SqpSettings the iterations read."""

    dt: float
    sqp_iterations: int
    g_max: float
    g_min: float
    armijo_factor: float
    max_step: float
    min_step: float
    step_reduction: float
    hessian_shift: float
    projection: str = "chol"
    riccati: str = "scan"
    linesearch_steps: int = 4
    sensitivity: str = "frozen"  # RK2 discrete-sensitivity mode (config.py)
    lin_tangents: str = "analytic"  # linearization derivative mode (config.py)


def _settings_static(cfg_sqp) -> _SqpSettingsStatic:
    """Settings from config.SqpSettings; rejects unknown modes."""
    check_linearization(cfg_sqp.lin_tangents, cfg_sqp.sensitivity)
    if cfg_sqp.projection not in PROJECTIONS:
        raise ValueError(f"projection={cfg_sqp.projection!r}: expected one of {PROJECTIONS}")
    if cfg_sqp.riccati not in RICCATI:
        raise ValueError(f"riccati={cfg_sqp.riccati!r}: expected one of {RICCATI}")
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
        projection=cfg_sqp.projection,
        riccati=cfg_sqp.riccati,
        linesearch_steps=cfg_sqp.linesearch_steps,
        sensitivity=cfg_sqp.sensitivity,
        lin_tangents=cfg_sqp.lin_tangents,
    )


class SqpSolver:
    """MPC-mode SQP solver (SqpMpc equivalent): the problem definition, the
    settings and the horizon length. ``solve`` runs one scenario; batched
    solves run through parallel/batched.py:BatchedMpc."""

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

    def warm_start(self, prev_times, prev_X, prev_U, new_times):
        """Shift the previous solution onto the new grid (MPC warm start):
        states interpolated linearly, inputs held (zero-order). ``prev_X``
        (..., N+1, 30) and ``prev_U`` (..., N, nu) may lead with a batch
        axis: every scenario shifts on the shared times at once."""
        N = self.n_intervals
        last = prev_times.shape[0] - 2
        idx = torch.clamp(torch.searchsorted(prev_times, new_times, right=True) - 1, 0, last)
        t0, t1 = prev_times[idx], prev_times[idx + 1]
        a = torch.clamp((new_times - t0) / torch.clamp(t1 - t0, min=1e-9), 0.0, 1.0)[:, None]
        X = (1 - a) * prev_X[..., idx, :] + a * prev_X[..., idx + 1, :]
        idx_u = torch.clamp(torch.searchsorted(prev_times[:-1], new_times[:N], right=True) - 1,
                            0, prev_U.shape[-2] - 1)
        return X, prev_U[..., idx_u, :]

    def _solve_impl(self, stage: StageData, x_init, X, U) -> SqpSolution:
        for _ in range(self.settings.sqp_iterations):
            X, U, stats = sqp_iteration(self.model, self.ocp, stage, self.settings.dt,
                                        self.settings, x_init, X, U)
        cost, viol, alpha = stats
        return SqpSolution(times=stage.times, X=X, U=U, cost=cost,
                           constraint_violation=viol, step_size=alpha)

    def solve(self, stage: StageData, x_init, warm=None) -> SqpSolution:
        """One MPC solve. ``warm``: optional (times, X, U) of the previous solve."""
        if warm is None:
            X0, U0 = self.cold_start(stage, x_init)
        else:
            X0, U0 = self.warm_start(*warm, stage.times)
            X0[0] = x_init
        return self._solve_impl(stage, x_init, X0, U0)
