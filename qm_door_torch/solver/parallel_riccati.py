"""Associative-scan (parallel) Riccati LQ solve, log depth over the horizon
instead of the sequential sweep's N steps (port of
qm_door_tpu/solver/parallel_riccati.py).

The value-function recursion is an associative operator (Särkkä &
García-Fernández, arXiv:1905.13002, LQT section). Each stage is first
reduced to standard LQT form by completing the square in u:
    u = K0 x + k0 + u~,   K0 = -luu^-1 lux,  k0 = -luu^-1 lu
which leaves the control cost 1/2 u~' luu u~, the dynamics
    x' = (A + B K0) x + (d + B k0) + B u~
the state cost X = lxx - lux' luu^-1 lux and the linear term
r = lx - lux' luu^-1 lu. Value functions are V_k(x) = 1/2 x'J x - eta'x +
const; the suffix-combined elements give (J_k, eta_k) at every node, and
the gains follow with one batched solve.

PyTorch has no associative scan: :func:`reverse_scan` is a log-depth
(Hillis-Steele) suffix scan, ceil(log2(N + 1)) levels (7 for the 68
elements of N = 67), each level one batched :func:`_combine` over every
element that has a partner 2^level nodes later. Its reduction order
differs from ``jax.lax.associative_scan``'s (odd/even recursion), so the
two agree to rounding, not bit for bit.

The SPD solves go to K1 (``ops/spd_solve.py``), as the sequential sweep
sends JAX's ``cho_factor``: one call completes the square at every stage
(the right-hand sides [lux, lu, B'] stacked, N x nu x (2 nx + 1)), one
solves every gain (N x nu x (nx + 1)). JAX's ``cho_factor`` reads luu's
upper triangle and K1 the lower, so luu goes in transposed. The
non-symmetric I + C1 J2 systems of the combine stay ``torch.linalg.solve``,
as JAX computes them outside any Pallas kernel.
"""
from __future__ import annotations

import torch

from ..models.spatial import fmm, fmv
from ..ops.spd_solve import spd_solve
from .transcription import ProjectedLq


def _sym(M):
    return 0.5 * (M + M.mT)


def _stage_standard_form(lq: ProjectedLq):
    """Complete the square in u at every stage (one K1 call)."""
    nx = lq.A.shape[-1]
    rhs = torch.cat([lq.lux, lq.lu[..., None], lq.B.mT], dim=-1)
    sol = spd_solve(lq.luu.mT.contiguous(), rhs.contiguous())
    K0, k0, BU = -sol[..., :nx], -sol[..., nx], sol[..., nx + 1:]
    F = lq.A + fmm(lq.B, K0)
    c = lq.d + fmv(lq.B, k0)
    X = _sym(lq.lxx + fmm(lq.lux.mT, K0))
    r = lq.lx + fmv(lq.lux.mT, k0)
    C = _sym(fmm(lq.B, BU))  # B luu^-1 B'
    return K0, k0, F, c, X, r, C


def _combine(e1, e2):
    """Associative combination of element tuples (A, b, C, eta, J), batched
    over the leading dims: e1 covers the earlier segment."""
    A1, b1, C1, eta1, J1 = e1
    A2, b2, C2, eta2, J2 = e2
    eye = torch.eye(A1.shape[-1], dtype=A1.dtype, device=A1.device)
    M = eye + fmm(C1, J2)
    A2M = torch.linalg.solve(M.mT, A2.mT).mT  # A2 M^-1
    A = fmm(A2M, A1)
    b = fmv(A2M, b1 + fmv(C1, eta2)) + b2
    C = _sym(fmm(fmm(A2M, C1), A2.mT) + C2)
    # (I + J2 C1)^-1 applied from the left to (eta2 - J2 b1) and J2 A1
    rhs = torch.cat([(eta2 - fmv(J2, b1))[..., None], fmm(J2, A1)], dim=-1)
    sol = torch.linalg.solve(eye + fmm(J2, C1), rhs)
    eta = fmv(A1.mT, sol[..., 0]) + eta1
    J = _sym(fmm(A1.mT, sol[..., 1:]) + J1)
    return A, b, C, eta, J


def reverse_scan(combine, elems):
    """Suffix scan over the first axis: out[k] = e[k] o e[k+1] o ... o e[-1]
    with ``combine(earlier, later)`` associative, in ceil(log2(n)) levels;
    each level combines, in one batched call, every element with the
    partial result 2^level places later."""
    n = elems[0].shape[0]
    span = 1
    while span < n:
        head = combine(tuple(e[:n - span] for e in elems), tuple(e[span:] for e in elems))
        elems = tuple(torch.cat([h, e[n - span:]]) for h, e in zip(head, elems))
        span *= 2
    return elems


def forward_scan(combine, elems):
    """Prefix scan over the first axis: out[k] = e[0] o ... o e[k] with
    ``combine(earlier, later)``, in ceil(log2(n)) batched levels."""
    n = elems[0].shape[0]
    span = 1
    while span < n:
        tail = combine(tuple(e[:n - span] for e in elems), tuple(e[span:] for e in elems))
        elems = tuple(torch.cat([e[:span], t]) for t, e in zip(tail, elems))
        span *= 2
    return elems


def parallel_riccati_backward(lq: ProjectedLq):
    """The feedback gains of one scenario's (N, ...) LQ data through the
    associative scan: (K (N, nu, nx), kff (N, nu)), equal to rounding to
    ``riccati.riccati_backward``'s."""
    nx = lq.A.shape[-1]
    dtype, dev = lq.A.dtype, lq.A.device
    _, _, F, c, X, r, C = _stage_standard_form(lq)

    # stage elements k = 0..N-1, then the terminal element
    zero = torch.zeros((1, nx, nx), dtype=dtype, device=dev)
    zerov = torch.zeros((1, nx), dtype=dtype, device=dev)
    elems = tuple(torch.cat([s, t]) for s, t in zip(
        (F, c, C, -r, X), (zero, zerov, zero, -lq.lx_f[None], lq.lxx_f[None])))
    _, _, _, eta_all, J_all = reverse_scan(_combine, elems)
    # V_{k+1}'s parameters for stage k: the suffix from k + 1
    Jn, etan = J_all[1:], eta_all[1:]

    # the gains with the original A, B, d: Quu = luu + B'J'B, Qux = B'J'A,
    # qu = B'(J'd - eta')
    BtJ = fmm(lq.B.mT, Jn)
    Quu = _sym(lq.luu + fmm(BtJ, lq.B))
    Qux = fmm(BtJ, lq.A)
    qu = fmv(BtJ, lq.d) - fmv(lq.B.mT, etan)
    rhs = torch.cat([Qux + lq.lux, (qu + lq.lu)[..., None]], dim=-1)
    sol = -spd_solve(Quu.contiguous(), rhs.contiguous())
    return sol[..., :nx], sol[..., nx]


def parallel_forward_rollout(A_cl, b_cl, dx0):
    """The affine rollout dx_{k+1} = A_cl[k] dx_k + b_cl[k] through a prefix
    scan: A_cl (N, n, n), b_cl (N, n), dx0 (n,) -> (N+1, n)."""
    def comb(e1, e2):
        A1, b1 = e1
        A2, b2 = e2
        return fmm(A2, A1), fmv(A2, b1) + b2

    A_all, b_all = forward_scan(comb, (A_cl, b_cl))
    return torch.cat([dx0[None], fmv(A_all, dx0) + b_all])
