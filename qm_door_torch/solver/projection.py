"""Cholesky-projector equality projection of one scenario's nodes (port of
qm_door_tpu/solver/projection.py).

The QR projection of transcription._project_node with only a Cholesky and
matmuls:

- M = Gv Gv^T + diag(1 - active_rows) is SPD and exactly invertible (masked
  rows of Gv are zero), so Gv^+ = Gv^T M^-1 is the exact pseudo-inverse of
  the active rows;
- the null space is the orthogonal projector P = I - Gv^+ Gv (18x18): the
  reduced input is u_red = [dF_tilde (12); w (18)], w acting through P, and
  the (I - P) Hessian regularizer pins the directions in range(Gv^T).

The functions take nodes with any leading dims; the SPD solve of every node
is one call to K1 (``ops/spd_solve.py``) with the nodes as its batch.
"""
from __future__ import annotations

import torch

from ..models.spatial import fmv
from ..ocp import constraints as cons
from ..ops.spd_solve import spd_solve

NX = 30
NU = 30
NU_RED_PROJ = 30
NU_FT = 36


def arm_lock(Gv, g0, v_arm, arm_locked: bool):
    """The quad-only arm lock as an input-space equality u_arm = 0: the
    arm-velocity delta pinned to -v_arm (the current arm joint velocities,
    u_bar[24:30]) and the velocity constraint left to the 12 leg columns.
    Returns (col_mask (18,), Gv with the arm columns zeroed, p_lock
    (..., 18), g0 + Gv p_lock); unlocked (ones, Gv, None, g0)."""
    dtype, dev = g0.dtype, g0.device
    if not arm_locked:
        return torch.ones(18, dtype=dtype, device=dev), Gv, None, g0
    col_mask = torch.cat([torch.ones(12, dtype=dtype, device=dev),
                          torch.zeros(6, dtype=dtype, device=dev)])
    p_lock = torch.cat([torch.zeros(*v_arm.shape[:-1], 12, dtype=dtype, device=dev), -v_arm],
                       dim=-1)
    return col_mask, Gv * col_mask, p_lock, g0 + fmv(Gv, p_lock)


def project_node_chol(flags, F_bar, g0, Gx, Gv, shift, v_arm=None, arm_locked: bool = False):
    """du = p + Pu u_red + Px dx with u_red in R^30. Returns (p (...,30),
    Pu (...,30,30), Px (...,30,30), reg (...,30,30)).

    ``arm_locked``: the quadruped-only variant (``arm_lock``), the arm's
    reduced dims identity-regularized."""
    dtype, dev = g0.dtype, g0.device
    lead = g0.shape[:-1]
    active = cons.velocity_row_mask(flags)                          # (..., 12)
    col_mask, Gv_f, p_lock, g0_eff = arm_lock(Gv, g0, v_arm, arm_locked)
    M = Gv_f @ Gv_f.transpose(-1, -2) + torch.diag_embed(1.0 - active)
    pinvT = spd_solve(M.reshape(-1, 12, 12).contiguous(),
                      Gv_f.reshape(-1, 12, 18).contiguous()).reshape(*lead, 12, 18)
    GvPinv = pinvT.transpose(-1, -2)                                 # (..., 18, 12) = Gv_f^+

    du_part = -fmv(GvPinv, g0_eff)                                   # (..., 18)
    if p_lock is not None:
        du_part = p_lock + du_part
    Px_v = -GvPinv @ Gx                                              # (..., 18, 30)
    P = torch.diag(col_mask) - GvPinv @ Gv_f                         # (..., 18, 18) projector

    force_mask = torch.repeat_interleave(flags, 3, dim=-1)           # (..., 12) 1 = stance
    p = torch.cat([-(1.0 - force_mask) * F_bar, du_part], dim=-1)
    z = lambda *s: torch.zeros(*lead, *s, dtype=dtype, device=dev)  # noqa: E731
    eye18 = torch.eye(18, dtype=dtype, device=dev)
    Pu = torch.cat([torch.cat([torch.diag_embed(force_mask), z(12, 18)], dim=-1),
                    torch.cat([z(18, 12), P], dim=-1)], dim=-2)
    Px = torch.cat([z(12, NX), Px_v], dim=-2)
    reg = torch.cat([torch.cat([torch.diag_embed(1.0 - force_mask), z(12, 18)], dim=-1),
                     torch.cat([z(18, 12), eye18 - P], dim=-1)], dim=-2)
    reg = reg + shift * torch.eye(NU_RED_PROJ, dtype=dtype, device=dev)
    return p, Pu, Px, reg


def project_node_chol_ft(flags, grasp, F_bar, W_bar, g0, Gx, Gv, shift):
    """Force-tracking variant, u (36) = [F (12); v_j (18); W_ee (6)]: the EE
    wrench is eliminated like a swing foot's force where the grasp flag is 0
    (its delta pinned to -W_bar, its reduced dims identity-regularized) and
    is a free tracked input while grasping. Reduced input dim 36."""
    dtype, dev = g0.dtype, g0.device
    lead = g0.shape[:-1]
    p0, Pu0, Px0, reg0 = project_node_chol(flags, F_bar, g0, Gx, Gv, 0.0)
    g = grasp.to(dtype)[..., None, None]                             # (..., 1, 1)
    eye6 = torch.eye(6, dtype=dtype, device=dev)
    z = lambda *s: torch.zeros(*lead, *s, dtype=dtype, device=dev)  # noqa: E731

    def widen(M30, W6):
        return torch.cat([torch.cat([M30, z(30, 6)], dim=-1),
                          torch.cat([z(6, 30), W6], dim=-1)], dim=-2)

    p = torch.cat([p0, -(1.0 - g[..., 0]) * W_bar], dim=-1)
    Pu = widen(Pu0, g * eye6)
    Px = torch.cat([Px0, z(6, NX)], dim=-2)
    reg = widen(reg0, (1.0 - g) * eye6) + shift * torch.eye(NU_FT, dtype=dtype, device=dev)
    return p, Pu, Px, reg
