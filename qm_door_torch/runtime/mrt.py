"""MPC-MRT policy bridge (port of qm_door_tpu/runtime/mrt.py;
MPC_MRT_Interface's role).

``PolicyStore`` is one snapshot of MPC solutions on a shared time grid,
for one scenario or for a batch (X (B, N+1, 30), U (B, N, nu));
``evaluate_policy`` interpolates every scenario at once with one
``searchsorted`` on the shared times.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class PolicyStore:
    """MPC solution snapshots on one time grid."""

    times: torch.Tensor  # (N+1,)
    X: torch.Tensor      # (..., N+1, 30)
    U: torch.Tensor      # (..., N, nu)


def evaluate_policy(policy: PolicyStore, t):
    """(x*, u*) at time ``t`` (a number or a 0-d tensor): linear state
    interpolation, piecewise-linear input (ocs2 MRT evaluatePolicy
    semantics), clamped at the horizon ends. Nothing is read back to the
    host."""
    times = policy.times
    K = times.shape[0]
    t = torch.as_tensor(t, dtype=times.dtype, device=times.device)
    idx = torch.clamp(torch.searchsorted(times, t.reshape(1), right=True) - 1, 0, K - 2)
    t0, t1 = times[idx][0], times[idx + 1][0]
    a = torch.clamp((t - t0) / torch.clamp(t1 - t0, min=1e-9), 0.0, 1.0)
    x = (1 - a) * _node(policy.X, idx) + a * _node(policy.X, idx + 1)

    nu = policy.U.shape[-2]
    u = ((1 - a) * _node(policy.U, torch.clamp(idx, 0, nu - 1))
         + a * _node(policy.U, torch.clamp(idx + 1, 0, nu - 1)))
    return x, u


def _node(Z, idx):
    """Z (..., K, n) at node ``idx`` (a one-element index tensor): (..., n)."""
    return torch.index_select(Z, -2, idx)[..., 0, :]
