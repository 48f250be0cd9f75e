"""Natively-batched SQP iteration: the serving path (port of
qm_door_tpu/solver/batched_sqp.py).

One iteration for B scenarios in lock-step:

- linearize: ``transcription.linearize_ocp``, vmapped over (B, N);
- the LQ stage (project + Riccati), by ``backend``:

  ============  ==========================================  ===================
  backend       LQ stage                                    JAX backend
  ============  ==========================================  ===================
  ``bm_k1``     ``transcription.project_ocp_batched`` (one  ``bm_pallas`` /
  (default)     K1 solve over B*N nodes) + ``riccati.       ``bm_xla``
                lqr_solve_batched`` (N K1 gain solves)
  ``bm_fused``  the same projection + K2, the whole         ``bm_fused``
                backward sweep in one kernel
  ``lq_fused``  ``ops.lq.solve_lq_batched``: K3a, K3b       ``pallas``
                (projection), K3c (backward), K3d
                (forward); nu = 30 only
  ============  ==========================================  ===================
- linesearch: the filter linesearch over the alpha grid with an early exit
  — one batched trajectory evaluation per candidate, stopping as soon as
  every scenario has accepted a step (one host sync per candidate after the
  first). The accepted alpha per scenario is the largest accepted
  candidate, as in the full sweep.

Every kernel runs when the tensors are on CUDA and its plain version on the
CPU (each wrapper in ``ops/`` decides by device).
"""
from __future__ import annotations

import torch

from ..models.model import RobotModel
from ..ocp import constraints as cons
from ..ocp.problem import OcpConfig, StageData
from ..ops.lq import solve_lq_batched
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


BACKENDS = ("bm_k1", "bm_fused", "lq_fused")


def batched_sqp_iteration(model: RobotModel, ocp: OcpConfig, stage: StageData,
                          dt, settings, x_init, X, U, backend: str = "bm_k1"):
    """One SQP iteration for B scenarios sharing ``stage``.

    x_init (B, 30); X (B, N+1, 30); U (B, N, 30). ``backend`` picks the LQ
    stage (module docstring). Returns (X, U, stats) with stats = (cost,
    violation, step_size), each (B,). The inputs are not modified.
    """
    if backend not in BACKENDS:
        raise ValueError(f"backend={backend!r}: expected one of {BACKENDS}")
    if backend == "lq_fused" and U.shape[-1] != NU:
        raise ValueError(f"backend 'lq_fused' takes nu = 30 only (its kernels hard-code "
                         f"30/30/18/12), not nu = {U.shape[-1]}")
    if U.shape[-1] != NU:
        raise NotImplementedError("only the 30-input problem is ported")
    B, N = U.shape[0], U.shape[1]
    lq = linearize_ocp(model, ocp, stage, dt, X, U,
                       sensitivity=settings.sensitivity, tangents=settings.lin_tangents)
    flags = stage.contact_flags[:N].expand(B, N, 4)
    dx0 = x_init - X[:, 0]
    if backend == "lq_fused":
        dX, dU = solve_lq_batched(lq, cons.velocity_row_mask(flags),
                                  torch.repeat_interleave(flags, 3, dim=-1), U[:, :, :12], dx0,
                                  shift=settings.hessian_shift)
    else:
        plq = project_ocp_batched(lq, flags, U, shift=settings.hessian_shift)
        dX, dU, _, _ = lqr_solve_batched(
            plq, dx0, backend="fused" if backend == "bm_fused" else "k1")

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
