"""The QPs of the whole-body cascade (port of qm_door_tpu/wbc/qp.py): the
level QP ``solve_qp_slack_batched`` the cascade runs, and the stacked dense
QP ``solve_qp_batched`` / ``solve_qp`` it is equivalent to.

    min_{z,v}  1/2 z'Hz z + cz'z + 1/2 v'v
    s.t.       G1 z - v <= h1        (level inequalities, slacked)
               -v <= 0               (slack positivity)
               Gp z <= hp            (inherited, frozen slacks)

An infeasible-start primal-dual interior point with a fixed iteration count:
every iteration runs, and the converged or non-finite elements of the batch
keep their iterate through ``torch.where`` masks, so the loop never reads a
value back to the host. The IP Newton system's slack block is diagonal and
eliminated analytically, so each iteration is one batched n x n SPD solve on
K1 (``ops/spd_solve.py``; n = 36 on the nominal stack, 42 with the wrench).
The stacked form ``solve_qp_batched`` (min 1/2 z'Hz + c'z s.t. Gz <= h,
with the slacks as variables) solves (n + nv)-sized Newton systems on K1:
92 x 92 at the production level sizes, inside K1's n <= 128.
"""
from __future__ import annotations

import torch

from ..models.spatial import fmv
from ..ops.spd_solve import spd_solve

TAU = 0.995  # fraction to the boundary


def _spd_solve_batched(M, rhs, shift: float):
    """Batched Newton-system solve: M (B,k,k) SPD, rhs (B,k) -> (B,k), on
    K1 for CUDA tensors and its plain version on the CPU."""
    return spd_solve(M.contiguous(), rhs[..., None].contiguous(), shift)[..., 0]


def _min_last(x):
    """min over the last axis; +inf where it is empty."""
    if x.shape[-1] == 0:
        return torch.full(x.shape[:-1], float("inf"), dtype=x.dtype, device=x.device)
    return torch.amin(x, dim=-1)


def _max_last(x):
    """max over the last axis; -inf where it is empty."""
    if x.shape[-1] == 0:
        return torch.full(x.shape[:-1], float("-inf"), dtype=x.dtype, device=x.device)
    return torch.amax(x, dim=-1)


def _max_step(x, dx):
    neg = dx < 0
    ratio = torch.where(neg, -x / torch.where(neg, dx, -torch.ones_like(dx)),
                        torch.full_like(x, float("inf")))
    return TAU * _min_last(ratio)


def _finite(*ts):
    ok = None
    for t in ts:
        f = torch.isfinite(t).all(dim=-1)
        ok = f if ok is None else ok & f
    return ok


def solve_qp_batched(H, c, G, h, iters: int = 30):
    """Solve min 1/2 z'Hz + c'z s.t. Gz <= h for each element of a batch:
    H (B,n,n) positive definite, c (B,n), G (B,m,n), h (B,m), m >= 1.
    Returns (z, lam, s), each with the leading batch axis.

    The same interior point as :func:`solve_qp_slack_batched` without the
    slack elimination: Jacobi equilibration (variable scaling from diag(H),
    constraint rows normalized), each iteration's (n, n) Newton system on
    K1, the freeze at mu_tol, and in float32 the active-set polish, kept
    only where finite and feasible to 1e-4 in the original units (the
    returned slack then matches the polished primal; lam stays the
    interior point's)."""
    B, n, _ = H.shape
    m = G.shape[1]
    dtype = H.dtype
    f32 = dtype == torch.float32
    mu_tol = 1e-5 if f32 else 1e-10
    tiny = 1e-25 if f32 else 1e-300
    w_max = 1e6 if f32 else 1e12
    jitter = 1e-6 if f32 else 1e-11

    dH = torch.diagonal(H, dim1=-2, dim2=-1)
    d = 1.0 / torch.sqrt(torch.clamp(dH, min=1e-8))
    H = H * d[:, :, None] * d[:, None, :]
    c = c * d
    Gd = G * d[:, None, :]
    e = 1.0 / torch.clamp(torch.linalg.norm(Gd, dim=-1), min=1.0)
    G = Gd * e[..., None]
    h = h * e
    GT = G.transpose(-1, -2)

    z = torch.zeros((B, n), dtype=dtype, device=H.device)
    s = torch.ones((B, m), dtype=dtype, device=H.device)
    lam = torch.ones((B, m), dtype=dtype, device=H.device)
    for _ in range(iters):
        mu = torch.sum(lam * s, dim=-1) / m
        proceed = mu > mu_tol
        target = (0.1 * mu)[:, None]
        r_d = fmv(H, z) + c + fmv(GT, lam)
        r_p = fmv(G, z) + s - h
        s_safe = torch.clamp(s, min=tiny)
        w = torch.clamp(lam / s_safe, 0.0, w_max)
        M = H + GT @ (w[..., None] * G)
        rhs = -r_d - fmv(GT, target / s_safe - lam + w * r_p)
        dz = _spd_solve_batched(M, rhs, jitter)
        ds = -r_p - fmv(G, dz)
        dlam = target / s_safe - lam - w * ds
        alpha = torch.clamp(torch.minimum(_max_step(s, ds), _max_step(lam, dlam)), max=1.0)
        ok = (proceed & _finite(dz, ds, dlam))[:, None]
        a = alpha[:, None]
        z = torch.where(ok, z + a * dz, z)
        s = torch.where(ok, s + a * ds, s)
        lam = torch.where(ok, lam + a * dlam, lam)

    if f32:
        act = (lam > s).to(dtype) * 1e6
        Mp = H + GT @ (act[..., None] * G)
        z_p = _spd_solve_batched(Mp, -c + fmv(GT, act * h), jitter)
        resid = fmv(G, z_p) - h
        viol = _max_last(resid / torch.clamp(e, min=tiny))
        ok_p = (_finite(z_p) & (viol < 1e-4))[:, None]
        z = torch.where(ok_p, z_p, z)
        s = torch.where(ok_p, -resid, s)

    return d * z, e * lam, s / torch.clamp(e, min=tiny)


def solve_qp(H, c, G, h, iters: int = 30):
    """One problem of :func:`solve_qp_batched` (H (n,n), c (n,), G (m,n),
    h (m,)), as a batch of one. Returns (z, lam, s)."""
    z, lam, s = solve_qp_batched(H[None], c[None], G[None], h[None], iters=iters)
    return z[0], lam[0], s[0]


def solve_qp_slack_batched(Hz, cz, G1, h1, Gp, hp, iters: int = 30):
    """HoQp-structured batched IP solve with the slack block eliminated.

    Shapes: Hz (B,n,n), cz (B,n), G1 (B,nv,n), h1 (B,nv), Gp (B,mp,n),
    hp (B,mp); nv or mp may be 0. Returns (z (B,n), v (B,nv)).

    The problem is Jacobi-equilibrated (variable scaling from diag(Hz),
    constraint rows normalized, the slack's -1 in each G1 row's norm). In
    float32 the interior point freezes at mu_tol and an active-set polish
    snaps the primal to the KKT point of the identified active set; it is
    kept only where finite and feasible to 1e-4 in the original units.
    """
    B, n, _ = Hz.shape
    nv = G1.shape[1]
    mp = Gp.shape[1]
    dtype = Hz.dtype
    f32 = dtype == torch.float32
    mu_tol = 1e-5 if f32 else 1e-10
    tiny = 1e-25 if f32 else 1e-300
    w_max = 1e6 if f32 else 1e12
    jitter = 1e-6 if f32 else 1e-11

    dH = torch.diagonal(Hz, dim1=-2, dim2=-1)
    d = 1.0 / torch.sqrt(torch.clamp(dH, min=1e-8))
    Hz = Hz * d[:, :, None] * d[:, None, :]
    cz = cz * d
    G1d = G1 * d[:, None, :]
    e1 = 1.0 / torch.clamp(torch.sqrt(torch.sum(G1d * G1d, dim=-1) + 1.0), min=1.0)
    G1s = G1d * e1[..., None]
    h1s = h1 * e1
    Gpd = Gp * d[:, None, :]
    ep = 1.0 / torch.clamp(torch.linalg.norm(Gpd, dim=-1), min=1.0)
    Gps = Gpd * ep[..., None]
    hps = hp * ep
    G1T = G1s.transpose(-1, -2)
    GpT = Gps.transpose(-1, -2)

    if nv == 0 and mp == 0:
        # unconstrained level: one SPD solve
        z = _spd_solve_batched(Hz, -cz, jitter)
        return d * z, torch.zeros((B, 0), dtype=dtype, device=Hz.device)

    def ones(k):
        return torch.ones((B, k), dtype=dtype, device=Hz.device)

    z = torch.zeros((B, n), dtype=dtype, device=Hz.device)
    v = torch.zeros((B, nv), dtype=dtype, device=Hz.device)
    s1, lam1, s2, lam2, sp, lamp = ones(nv), ones(nv), ones(nv), ones(nv), ones(mp), ones(mp)
    m_tot = nv + nv + mp

    def safe(s):
        return torch.clamp(s, min=tiny)

    def weight(lam, s):
        return torch.clamp(lam / safe(s), 0.0, w_max)

    for _ in range(iters):
        mu = (torch.sum(lam1 * s1, -1) + torch.sum(lam2 * s2, -1)
              + torch.sum(lamp * sp, -1)) / m_tot
        proceed = mu > mu_tol
        target = (0.1 * mu)[:, None]

        r_dz = fmv(Hz, z) + cz + fmv(G1T, lam1) + fmv(GpT, lamp)
        r_dv = v - e1 * lam1 - lam2
        r_p1 = fmv(G1s, z) - e1 * v + s1 - h1s
        r_p2 = -v + s2
        r_pp = fmv(Gps, z) + sp - hps

        w1, w2, wp = weight(lam1, s1), weight(lam2, s2), weight(lamp, sp)
        q1 = target / safe(s1) - lam1 + w1 * r_p1
        q2 = target / safe(s2) - lam2 + w2 * r_p2
        qp_ = target / safe(sp) - lamp + wp * r_pp

        den = 1.0 + e1 * w1 * e1 + w2                       # (B,nv) diag
        w1_t = w1 - (w1 * e1) * (w1 * e1) / den             # Schur weight
        rhs_z = -r_dz - fmv(G1T, q1) - fmv(GpT, qp_)
        rhs_v = -r_dv + e1 * q1 + q2
        Mred = (Hz + G1T @ (w1_t[..., None] * G1s)
                + GpT @ (wp[..., None] * Gps))
        rhs_red = rhs_z + fmv(G1T, (w1 * e1 / den) * rhs_v)
        dz = _spd_solve_batched(Mred, rhs_red, jitter)
        dv = (rhs_v + e1 * w1 * fmv(G1s, dz)) / den

        ds1 = -r_p1 - (fmv(G1s, dz) - e1 * dv)
        dlam1 = target / safe(s1) - lam1 - w1 * ds1
        ds2 = -r_p2 + dv
        dlam2 = target / safe(s2) - lam2 - w2 * ds2
        dsp = -r_pp - fmv(Gps, dz)
        dlamp = target / safe(sp) - lamp - wp * dsp

        alpha = torch.clamp(torch.minimum(
            torch.minimum(_max_step(s1, ds1), _max_step(lam1, dlam1)),
            torch.minimum(
                torch.minimum(_max_step(s2, ds2), _max_step(lam2, dlam2)),
                torch.minimum(_max_step(sp, dsp), _max_step(lamp, dlamp)))), max=1.0)
        ok = (proceed & _finite(dz, dv, ds1, dlam1, ds2, dlam2, dsp, dlamp))[:, None]
        a = alpha[:, None]
        z = torch.where(ok, z + a * dz, z)
        v = torch.where(ok, v + a * dv, v)
        s1 = torch.where(ok, s1 + a * ds1, s1)
        lam1 = torch.where(ok, lam1 + a * dlam1, lam1)
        s2 = torch.where(ok, s2 + a * ds2, s2)
        lam2 = torch.where(ok, lam2 + a * dlam2, lam2)
        sp = torch.where(ok, sp + a * dsp, sp)
        lamp = torch.where(ok, lamp + a * dlamp, lamp)

    if f32:
        # active-set polish in the condensed space: inactive rows drop out,
        # active rows get a stiff quadratic penalty
        a1 = (lam1 > s1).to(dtype) * 1e6
        a2 = (lam2 > s2).to(dtype) * 1e6
        ap = (lamp > sp).to(dtype) * 1e6
        denp = 1.0 + e1 * a1 * e1 + a2
        a1_t = a1 - (a1 * e1) * (a1 * e1) / denp
        rhs_z = -cz + fmv(G1T, a1 * h1s) + fmv(GpT, ap * hps)
        rhs_v = -e1 * (a1 * h1s)
        Mp = (Hz + G1T @ (a1_t[..., None] * G1s)
              + GpT @ (ap[..., None] * Gps))
        rhs_p = rhs_z + fmv(G1T, (a1 * e1 / denp) * rhs_v)
        z_p = _spd_solve_batched(Mp, rhs_p, jitter)
        v_p = (rhs_v + e1 * a1 * fmv(G1s, z_p)) / denp
        # feasibility gate in the original units across all three row groups
        r1 = (fmv(G1s, z_p) - e1 * v_p - h1s) / torch.clamp(e1, min=tiny)
        r2 = -v_p
        rp = (fmv(Gps, z_p) - hps) / torch.clamp(ep, min=tiny)
        viol = torch.maximum(_max_last(r1), torch.maximum(_max_last(r2), _max_last(rp)))
        ok_p = (_finite(z_p, v_p) & (viol < 1e-4))[:, None]
        z = torch.where(ok_p, z_p, z)
        v = torch.where(ok_p, v_p, v)

    return d * z, v
