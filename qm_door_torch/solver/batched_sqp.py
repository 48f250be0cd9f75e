"""Natively-batched SQP iteration: the serving path (port of
qm_door_tpu/solver/batched_sqp.py).

One iteration for B scenarios in lock-step:

- linearize: ``transcription.linearize_ocp``, vmapped over (B, N);
- project: ``transcription.project_ocp_batched``, one (B*N)-batched SPD
  solve;
- Riccati: ``riccati.lqr_solve_batched``, 67 (N) batched gain solves;
- linesearch: the filter linesearch over the alpha grid with an early exit
  — one batched trajectory evaluation per candidate, stopping as soon as
  every scenario has accepted a step (one host sync per candidate after the
  first). The accepted alpha per scenario is the largest accepted
  candidate, as in the full sweep.

The SPD solves go to kernel K1 when the tensors are on CUDA and to its plain
version on the CPU (``ops/spd_solve.py`` decides by device).
"""
from __future__ import annotations

import torch

from ..models.model import RobotModel
from ..ocp.problem import OcpConfig, StageData
from .riccati import lqr_solve_batched
from .sqp import evaluate_trajectory
from .transcription import NU, linearize_ocp, project_ocp_batched


def _accept(cost0, viol0, costs, viols, alpha, settings):
    """OCS2 FilterLinesearch acceptance rule."""
    decrease_viol = viols < (1.0 - 1e-3) * viol0
    decrease_cost = costs < cost0 - settings.armijo_factor * alpha * torch.abs(cost0)
    ok_infeasible = decrease_viol
    ok_feasible = decrease_cost & (viols < torch.clamp(2 * viol0, min=settings.g_max))
    ok_mixed = decrease_cost | decrease_viol
    ok = torch.where(
        viol0 > settings.g_max, ok_infeasible,
        torch.where(viol0 < settings.g_min, ok_feasible, ok_mixed))
    return ok & torch.isfinite(costs) & torch.isfinite(viols)


def batched_sqp_iteration(model: RobotModel, ocp: OcpConfig, stage: StageData,
                          dt, settings, x_init, X, U):
    """One SQP iteration for B scenarios sharing ``stage``.

    x_init (B, 30); X (B, N+1, 30); U (B, N, 30). Returns (X, U, stats) with
    stats = (cost, violation, step_size), each (B,). The inputs are not
    modified.
    """
    if U.shape[-1] != NU:
        raise NotImplementedError("only the 30-input problem is ported")
    B, N = U.shape[0], U.shape[1]
    lq = linearize_ocp(model, ocp, stage, dt, X, U,
                       sensitivity=settings.sensitivity, tangents=settings.lin_tangents)
    flags = stage.contact_flags[:N].expand(B, N, 4)
    dx0 = x_init - X[:, 0]
    plq = project_ocp_batched(lq, flags, U, shift=settings.hessian_shift)
    dX, dU, _, _ = lqr_solve_batched(plq, dx0)

    # baseline merit from the linearization byproducts
    cost0 = lq.cost                                                  # (B,)
    swing = 1.0 - torch.repeat_interleave(flags, 3, dim=-1)
    zero_force_sse = torch.sum((swing * U[:, :, 0:12]) ** 2, dim=(1, 2))
    viol0 = (torch.sum(lq.d * lq.d, dim=(1, 2))
             + torch.sum(lq.g0 * lq.g0, dim=(1, 2)) + zero_force_sse)

    # --- early-exit filter linesearch over the alpha grid ------------------
    n_alpha = settings.linesearch_steps
    alphas = settings.max_step * (
        settings.step_reduction ** torch.arange(n_alpha, dtype=X.dtype, device=X.device))
    accepted = torch.zeros(B, dtype=torch.bool, device=X.device)
    alpha = torch.zeros(B, dtype=X.dtype, device=X.device)
    cost_new, viol_new = cost0, viol0
    for i in range(n_alpha):
        if i > 0 and bool(torch.all(accepted)):
            break
        a = alphas[i]
        costs, viols = evaluate_trajectory(model, ocp, stage, dt, X + a * dX, U + a * dU)
        ok = _accept(cost0, viol0, costs, viols, a, settings)
        newly = ok & ~accepted
        alpha = torch.where(newly, a, alpha)
        cost_new = torch.where(newly, costs, cost_new)
        viol_new = torch.where(newly, viols, viol_new)
        accepted = accepted | ok

    # a rejected step (alpha = 0) keeps the iterate: where, not 0 * dX, so a
    # non-finite step cannot poison it
    take = (alpha > 0.0)[:, None, None]
    X_new = torch.where(take, X + alpha[:, None, None] * dX, X)
    U_new = torch.where(take, U + alpha[:, None, None] * dU, U)
    X_new[:, 0] = x_init  # X_new is a fresh tensor: the caller's X is untouched
    return X_new, U_new, (cost_new, viol_new, alpha)
