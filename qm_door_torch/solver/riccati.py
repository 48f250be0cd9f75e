"""Riccati LQ solve over the horizon (port of qm_door_tpu/solver/riccati.py
without the associative-scan backend).

The LQ problem is defect-aware multiple shooting:
  min  sum_k 1/2 dx'lxx dx + 1/2 du'luu du + du'lux dx + lx'dx + lu'du
       + terminal 1/2 dx'lxx_f dx + lx_f'dx
  s.t. dx_{k+1} = A_k dx_k + B_k du_k + d_k,   dx_0 given.

Batch-major sweeps (``*_batched``), backend "k1": Python loops over the N
nodes, each step batched over the B scenarios; the gain solve of every
backward step is one call to K1 (``ops/spd_solve.py``). Backend "fused":
the whole backward sweep is one launch of K2 (``ops/riccati_fused.py``),
then the same forward loop.

Per-scenario sweeps (``riccati_backward``, ``riccati_forward``,
``lqr_solve``): the batch-major sweeps on (N, ...) data given a leading
batch of one, so each gain solve is a K1 call with one system and the
input recovery takes the dense form.
"""
from __future__ import annotations

import torch

from ..models.spatial import fmm, fmv
from ..ops.riccati_fused import riccati_backward_fused_lq
from ..ops.spd_solve import spd_solve
from .transcription import ProjectedLq


def _sym(M):
    return 0.5 * (M + M.transpose(-1, -2))


def riccati_backward_batched(lq: ProjectedLq):
    """Backward sweep over (B, N, ...) LQ data. Returns (K (B,N,nu,nx),
    kff (B,N,nu), S0 (B,nx,nx), s0 (B,nx))."""
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
    return torch.stack(Ks, dim=1), torch.stack(kffs, dim=1), S, s


def _recover(lq: ProjectedLq, k, u_red, dx):
    """du = p + Pu u_red + Px dx at node k of batch-major data: dense when
    the projection carried Pu / Px (the per-scenario path), else
    structured — the force (and wrench) dims are elementwise gates, only
    the 18 joint-velocity dims need products."""
    if lq.P is None:
        return lq.p[:, k] + fmv(lq.Pu[:, k], u_red) + fmv(lq.Px[:, k], dx)
    parts = [lq.force_mask[:, k] * u_red[..., 0:12],
             fmv(lq.P[:, k], u_red[..., 12:30]) + fmv(lq.Px_v[:, k], dx)]
    if lq.grasp_gate is not None:
        parts.append(lq.grasp_gate[:, k] * u_red[..., 30:36])
    return lq.p[:, k] + torch.cat(parts, dim=-1)


def riccati_forward_batched(lq: ProjectedLq, K, kff, dx0):
    """Forward rollout over (B, N, ...). Returns (dX (B,N+1,nx),
    dU_red (B,N,nu_red), dU (B,N,nu))."""
    N = lq.A.shape[1]
    dx = dx0
    dXs, dU_reds, dUs = [], [], []
    for k in range(N):
        u_red = kff[:, k] + fmv(K[:, k], dx)
        dU_reds.append(u_red)
        dUs.append(_recover(lq, k, u_red, dx))
        dXs.append(dx)
        dx = fmv(lq.A[:, k], dx) + fmv(lq.B[:, k], u_red) + lq.d[:, k]
    dXs.append(dx)
    return torch.stack(dXs, dim=1), torch.stack(dU_reds, dim=1), torch.stack(dUs, dim=1)


RICCATI_BACKENDS = ("k1", "fused")


def lqr_solve_batched(lq: ProjectedLq, dx0, backend: str = "k1"):
    """Backward + forward sweeps. lq carries (B, N, ...); dx0 (B, nx).
    Returns (dX, dU, K, kff).

    backend "k1": the scan over the nodes with one K1 gain solve each;
    "fused": K2, the whole backward sweep in one kernel, with shift 0 (the
    Hessian shift already sits in the projected luu), as the JAX package's
    ``lqr_solve_batched(backend="fused")``."""
    if backend == "k1":
        K, kff, _, _ = riccati_backward_batched(lq)
    elif backend == "fused":
        K, kff = riccati_backward_fused_lq(lq)
    else:
        raise ValueError(f"backend={backend!r}: expected one of {RICCATI_BACKENDS}")
    dX, _, dU = riccati_forward_batched(lq, K, kff, dx0)
    return dX, dU, K, kff


# ---------------------------------------------------------------------------
# per-scenario sweeps: the batch-major ones on a batch of one
# ---------------------------------------------------------------------------

def _batch_of_one(lq: ProjectedLq) -> ProjectedLq:
    return ProjectedLq(**{k: None if v is None else v[None] for k, v in vars(lq).items()})


def riccati_backward(lq: ProjectedLq):
    """Backward sweep over one scenario's (N, ...) data. Returns
    (K (N,nu,nx), kff (N,nu), S0, s0)."""
    return tuple(t[0] for t in riccati_backward_batched(_batch_of_one(lq)))


def riccati_forward(lq: ProjectedLq, K, kff, dx0):
    """Forward rollout of one scenario's LQ solution. Returns
    (dX (N+1,nx), dU_red (N,nu_red), dU (N,nu))."""
    return tuple(t[0] for t in riccati_forward_batched(_batch_of_one(lq), K[None], kff[None],
                                                       dx0[None]))


def lqr_solve(lq: ProjectedLq, dx0):
    """Backward + forward sweeps of one scenario. Returns (dX, dU, K, kff)."""
    return tuple(t[0] for t in lqr_solve_batched(_batch_of_one(lq), dx0[None]))
