"""Hierarchical QP cascade (port of qm_door_tpu/wbc/hoqp.py; HoQp
replacement, Bellicoso et al. 2016).

Each priority level solves

    min_{z,v} ||A_l (x_prev + Z z) - b_l||^2 + ||v||^2
    s.t. D_i (x_prev + Z z) <= f_i + v_i*   (all higher levels i)
         D_l (x_prev + Z z) <= f_l + v,  v >= 0

with Z the orthogonal projector onto the null space of every equality row
processed so far (a masked SPD Gram solve, no SVD); the directions Z
removes are pinned by the complementary projector in H. Every leaf of a
:class:`Task` carries a leading batch axis, and every SPD solve (the level
QPs' Newton systems and the projectors' Gram systems) is one batched call
to K1 (``ops/spd_solve.py``). The single-problem forms
(:func:`null_projector`, :func:`solve_hierarchy`) are the batched ones on
a batch of one; ``nullspace="svd"`` takes the null-space basis from an SVD
(:func:`null_space_masked`, torch.linalg, as the JAX package uses
jnp.linalg.svd there) instead of the projector.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence

import torch

from ..models.spatial import fmv
from ..ops.spd_solve import spd_solve
from .qp import solve_qp_slack_batched


class Task(NamedTuple):
    """Equality (A x = b) and inequality (D x <= f) rows; masked rows are zero
    with f = +margin so they never activate. Leaves: A (...,r,n), b (...,r),
    D (...,q,n), f (...,q)."""

    A: torch.Tensor
    b: torch.Tensor
    D: torch.Tensor
    f: torch.Tensor


def _spd_solve_b(M, Y, shift: float):
    """M (B,k,k) SPD, Y (B,k,m) -> (B,k,m): one K1 call for CUDA tensors
    (every right-hand side at once), its plain version on the CPU."""
    return spd_solve(M.contiguous(), Y.contiguous(), shift)


def null_projector_batched(A, ridge=None):
    """Orthogonal projector onto null(A) for each element: A (B,m,n) ->
    (B,n,n).

    Live rows are equilibrated to unit norm (null(A) is invariant to row
    scaling; rows below row_tol of the largest are cancellation residue and
    are zeroed), the Gram matrix's dead diagonal is completed, a relative
    ridge absorbs rank deficiency, and one iterative-refinement pass reuses
    the factorization. Both ridges are computed and an element takes the
    safe one where the thin one gave a non-finite projector."""
    dtype = A.dtype
    f32 = dtype == torch.float32
    if ridge is None:
        ridge = 1e-7 if f32 else 1e-10
    ridge_safe = 1e-5 if f32 else 1e-8
    B, m, n = A.shape
    rn = torch.linalg.norm(A, dim=-1)                               # (B,m)
    row_tol = 1e-6 if f32 else 1e-12
    live_r = rn > row_tol * torch.clamp(torch.amax(rn, dim=-1, keepdim=True), min=1.0)
    A = torch.where(live_r[..., None], A / torch.clamp(rn, min=1e-30)[..., None],
                    torch.zeros_like(A))
    AT = A.transpose(-1, -2)
    G = A @ AT
    diag = torch.diagonal(G, dim1=-2, dim2=-1)                      # (B,m)
    scale = torch.clamp(torch.amax(diag, dim=-1), min=1.0)          # (B,)
    dead = (diag < 1e-12 * scale[:, None]).to(dtype)                # (B,m)
    eye_m = torch.eye(m, dtype=dtype, device=A.device)
    Gc = G + eye_m[None] * (dead * scale[:, None])[:, :, None]

    def proj(r):
        M = Gc + (r * scale)[:, None, None] * eye_m[None]
        pinvA = _spd_solve_b(M, A, 0.0)
        pinvA = pinvA + _spd_solve_b(M, A - M @ pinvA, 0.0)
        return torch.eye(n, dtype=dtype, device=A.device)[None] - AT @ pinvA

    P = proj(ridge)
    ok = torch.isfinite(P).all(dim=-1).all(dim=-1)
    P_safe = proj(ridge_safe)
    return torch.where(ok[:, None, None], P, P_safe)


def null_projector(A, ridge=None):
    """Orthogonal projector onto null(A), A (m,n) -> (n,n): one element of
    :func:`null_projector_batched`. The JAX package computes the safe ridge
    only when the thin one gives a non-finite projector (lax.cond); here
    both are computed and the safe one selected where needed, so the values
    are the same and every projector makes the same 4 solves."""
    return null_projector_batched(A[None], ridge)[0]


def null_space_masked(M, rel_tol=None):
    """Full-width (..., n, n) null-space basis of M (..., m, n) from an SVD:
    the right singular vectors whose singular value is at most rel_tol of
    the largest (or of 1) are kept, the row-space columns are exactly zero,
    so the shape stays static."""
    if rel_tol is None:
        rel_tol = 1e-5 if M.dtype == torch.float32 else 1e-9
    _, sv, Vh = torch.linalg.svd(M, full_matrices=True)
    n, k = M.shape[-1], sv.shape[-1]
    tol = rel_tol * torch.clamp(torch.amax(sv, dim=-1, keepdim=True), min=1.0)
    live = torch.cat([sv > tol, torch.zeros(*sv.shape[:-1], n - k, dtype=torch.bool,
                                            device=M.device)], dim=-1)
    return Vh.transpose(-1, -2) * (1.0 - live.to(M.dtype))[..., None, :]


def solve_hierarchy(tasks: Sequence[Task], qp_iters: int = 30, null_tol=None,
                    nullspace: str = "projector"):
    """Solve one problem's priority cascade (Task leaves without a batch
    axis), highest priority first, as a batch of one of
    :func:`solve_hierarchy_batched`. Returns x (n,)."""
    return solve_hierarchy_batched([Task(*(t[None] for t in task)) for task in tasks],
                                   qp_iters=qp_iters, null_tol=null_tol, nullspace=nullspace)[0]


def solve_hierarchy_batched(tasks: Sequence[Task], qp_iters: int = 30, null_tol=None,
                            nullspace: str = "projector"):
    """Solve the priority cascade, highest priority first; every Task leaf
    carries a leading batch axis (A (B,r,n), b (B,r), D (B,q,n), f (B,q)).
    Returns x (B,n).

    ``nullspace``: "projector" (:func:`null_projector_batched`, on K1) or
    "svd" (:func:`null_space_masked` with ``null_tol``; its dead columns
    are pinned by a unit diagonal on the columns it zeroed)."""
    if nullspace not in ("projector", "svd"):
        raise ValueError(f"nullspace={nullspace!r}: expected 'projector' or 'svd'")
    B, _, n = tasks[0].A.shape
    dtype, dev = tasks[0].A.dtype, tasks[0].A.device
    x = torch.zeros((B, n), dtype=dtype, device=dev)
    eye_n = torch.eye(n, dtype=dtype, device=dev)
    Z = eye_n.expand(B, n, n)
    h_reg = 1e-5 if dtype == torch.float32 else 1e-9
    prev_ineq = []

    for level, task in enumerate(tasks):
        A, b, D, f = task
        nv = D.shape[1]
        AZ = A @ Z
        AZT = AZ.transpose(-1, -2)
        H_zz = AZT @ AZ
        if nullspace == "svd":
            col_live = (torch.linalg.norm(Z, dim=-2) > 1e-8).to(dtype)     # (B,n)
            H_zz = H_zz + torch.diag_embed(1.0 - col_live)
        elif level > 0:
            # dead directions = range of the processed equality rows: pin
            # their coordinates with the complementary projector
            H_zz = H_zz + (eye_n[None] - Z)
        H_zz = H_zz + h_reg * eye_n[None]
        c_z = fmv(AZT, fmv(A, x) - b)

        if nv > 0:
            G1 = D @ Z
            h1 = f - fmv(D, x)
        else:
            G1 = torch.zeros((B, 0, n), dtype=dtype, device=dev)
            h1 = torch.zeros((B, 0), dtype=dtype, device=dev)
        if prev_ineq:
            Gp = torch.cat([Dp @ Z for Dp, _ in prev_ineq], dim=1)
            hp = torch.cat([fp - fmv(Dp, x) for Dp, fp in prev_ineq], dim=-1)
        else:
            Gp = torch.zeros((B, 0, n), dtype=dtype, device=dev)
            hp = torch.zeros((B, 0), dtype=dtype, device=dev)

        z, v = solve_qp_slack_batched(H_zz, c_z, G1, h1, Gp, hp, iters=qp_iters)
        x = x + fmv(Z, z)

        if nv > 0:
            prev_ineq.append((D, f + v))
        if level < len(tasks) - 1:
            stacked_A = torch.cat([t.A for t in tasks[: level + 1]], dim=1)
            Z = (null_projector_batched(stacked_A) if nullspace == "projector"
                 else null_space_masked(stacked_A, rel_tol=null_tol))
    return x


def level_residuals(tasks: Sequence[Task], x):
    """Each level's residual at x (B,n'), n' >= the tasks' n:
    sqrt(||A_l x - b_l||^2 + ||max(D_l x - f_l, 0)||^2), the quantity level
    l minimizes with its slack (h_reg aside). Returns (B, levels)."""
    x = x[:, :tasks[0].A.shape[-1]]
    return torch.stack([torch.sqrt(torch.sum((fmv(A, x) - b) ** 2, dim=-1)
                                   + torch.sum(torch.clamp(fmv(D, x) - f, min=0.0) ** 2, dim=-1))
                        for A, b, D, f in tasks], dim=-1)
