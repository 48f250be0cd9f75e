"""Batch-major Riccati LQ solve over the horizon (port of the batched
sweeps of qm_door_tpu/solver/riccati.py).

The LQ problem is defect-aware multiple shooting:
  min  sum_k 1/2 dx'lxx dx + 1/2 du'luu du + du'lux dx + lx'dx + lu'du
       + terminal 1/2 dx'lxx_f dx + lx_f'dx
  s.t. dx_{k+1} = A_k dx_k + B_k du_k + d_k,   dx_0 given.

The sweeps are Python loops over the N nodes, each step batched over the B
scenarios; the gain solve of every backward step is one call to K1
(``ops/spd_solve.py``).
"""
from __future__ import annotations

import torch

from ..models.spatial import fmm, fmv
from ..ops.spd_solve import spd_solve
from .transcription import ProjectedLq


def _sym(M):
    return 0.5 * (M + M.transpose(-1, -2))


def riccati_backward_batched(lq: ProjectedLq):
    """Backward sweep over (B, N, ...) LQ data. Returns K (B,N,nu,nx),
    kff (B,N,nu)."""
    nx = lq.A.shape[-1]
    N = lq.A.shape[1]
    S, s = lq.lxx_f, lq.lx_f
    Ks, kffs = [None] * N, [None] * N
    for k in reversed(range(N)):
        A, B, d = lq.A[:, k], lq.B[:, k], lq.d[:, k]
        AT, BT = A.transpose(-1, -2), B.transpose(-1, -2)
        Sd_s = fmv(S, d) + s
        Qx = lq.lx[:, k] + fmv(AT, Sd_s)
        Qu = lq.lu[:, k] + fmv(BT, Sd_s)
        SA = fmm(S, A)
        SB = fmm(S, B)
        Qxx = lq.lxx[:, k] + fmm(AT, SA)
        Quu = _sym(lq.luu[:, k] + fmm(BT, SB))
        Qux = lq.lux[:, k] + fmm(BT, SA)
        rhs = torch.cat([Qux, Qu[..., None]], dim=-1)
        sol = -spd_solve(Quu.contiguous(), rhs)
        K, kff = sol[..., :nx], sol[..., nx]
        QuxT = Qux.transpose(-1, -2)
        S = _sym(Qxx + fmm(QuxT, K))
        s = Qx + fmv(QuxT, kff)
        Ks[k], kffs[k] = K, kff
    return torch.stack(Ks, dim=1), torch.stack(kffs, dim=1)


def riccati_forward_batched(lq: ProjectedLq, K, kff, dx0):
    """Forward rollout over (B, N, ...). Returns (dX (B,N+1,nx), dU (B,N,30)),
    recovering du = p + blkdiag(diag(fm), P) u_red + [0; Px_v] dx."""
    N = lq.A.shape[1]
    dx = dx0
    dXs, dUs = [], []
    for k in range(N):
        u_red = kff[:, k] + fmv(K[:, k], dx)
        du_F = lq.force_mask[:, k] * u_red[..., 0:12]
        du_v = fmv(lq.P[:, k], u_red[..., 12:30]) + fmv(lq.Px_v[:, k], dx)
        dUs.append(lq.p[:, k] + torch.cat([du_F, du_v], dim=-1))
        dXs.append(dx)
        dx = fmv(lq.A[:, k], dx) + fmv(lq.B[:, k], u_red) + lq.d[:, k]
    dXs.append(dx)
    return torch.stack(dXs, dim=1), torch.stack(dUs, dim=1)


def lqr_solve_batched(lq: ProjectedLq, dx0):
    """Backward + forward sweeps. lq carries (B, N, ...); dx0 (B, nx).
    Returns (dX, dU, K, kff)."""
    K, kff = riccati_backward_batched(lq)
    dX, dU = riccati_forward_batched(lq, K, kff, dx0)
    return dX, dU, K, kff
