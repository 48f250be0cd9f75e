"""Natively-batched SQP iteration: the serving path (port of
qm_door_tpu/solver/batched_sqp.py).

One iteration for B scenarios in lock-step, on the 30-input problem or
the force-tracking one (nu = 36), with ``arm_locked`` or not, the stage
data shared or per scenario (``stage_batched``):

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
                (forward); nu = 30 only,
                not ``arm_locked``
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
from .sqp import _alpha_grid, baseline_violation, evaluate_trajectory
from .sqp import accept as _accept
from .transcription import NU, NU_FT, linearize_ocp, project_ocp_batched

BACKENDS = ("bm_k1", "bm_fused", "lq_fused")


def batched_sqp_iteration(model: RobotModel, ocp: OcpConfig, stage: StageData,
                          dt, settings, x_init, X, U, stage_batched: bool = False,
                          backend: str = "bm_k1"):
    """One SQP iteration for B scenarios.

    x_init (B, 30); X (B, N+1, 30); U (B, N, nu). ``stage`` is shared (no
    leading axis) or per scenario (leading B, ``stage_batched``).
    ``backend`` picks the LQ stage (module docstring). Returns (X, U, stats)
    with stats = (cost, violation, step_size), each (B,). The inputs are not
    modified.
    """
    if backend not in BACKENDS:
        raise ValueError(f"backend={backend!r}: expected one of {BACKENDS}")
    nu = U.shape[-1]
    if nu not in (NU, NU_FT):
        raise ValueError(f"U has {nu} inputs, expected {NU} or {NU_FT}")
    if backend == "lq_fused" and (nu != NU or ocp.arm_locked):
        raise ValueError(f"backend 'lq_fused' takes nu = 30 only (its kernels hard-code "
                         f"30/30/18/12) and no arm_locked, not nu = {nu}, "
                         f"arm_locked={ocp.arm_locked}")
    B, N = U.shape[0], U.shape[1]
    lq = linearize_ocp(model, ocp, stage, dt, X, U, sensitivity=settings.sensitivity,
                       tangents=settings.lin_tangents, stage_batched=stage_batched)
    flags = stage.contact_flags[..., :N, :].expand(B, N, 4)
    dx0 = x_init - X[:, 0]
    if backend == "lq_fused":
        dX, dU = solve_lq_batched(lq, cons.velocity_row_mask(flags),
                                  torch.repeat_interleave(flags, 3, dim=-1), U[:, :, :12], dx0,
                                  shift=settings.hessian_shift)
    else:
        grasp = stage.grasp_flags[..., :N].expand(B, N) if nu == NU_FT else None
        plq = project_ocp_batched(lq, flags, U, shift=settings.hessian_shift, grasp=grasp,
                                  arm_locked=ocp.arm_locked)
        dX, dU, _, _ = lqr_solve_batched(
            plq, dx0, backend="fused" if backend == "bm_fused" else "k1")

    # baseline merit from the linearization byproducts
    cost0 = lq.cost                                                  # (B,)
    viol0 = baseline_violation(ocp, stage, lq, U)

    # --- early-exit filter linesearch over the alpha grid ------------------
    # one batched evaluation a candidate, stopping once every scenario has
    # accepted a step (one host sync a candidate after the first)
    alphas = _alpha_grid(settings, X)
    accepted = torch.zeros(B, dtype=torch.bool, device=X.device)
    alpha = torch.zeros(B, dtype=X.dtype, device=X.device)
    cost_new, viol_new = cost0, viol0
    for i in range(settings.linesearch_steps):
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
