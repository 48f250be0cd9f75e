"""The reference's SQP iteration: the LQ approximation of the multiple-shooting
problem by automatic differentiation, its equality-constrained solve as one
dense KKT system a scenario, and the filter linesearch's merit.

The iteration it follows (one SQP iteration of the configuration's MPC):

- dynamics: Heun's RK2 step, linearized with the "frozen" sensitivity (the
  second stage reuses the first stage's Jacobian of the flow map);
- cost: the exact Hessian of the tracking, friction-cone and soft-box
  terms, Gauss-Newton for the end-effector pose term;
- equalities: the foot-velocity rows of each node, swing-foot forces (and,
  off-grasp, the end-effector wrench) pinned to zero;
- a Tikhonov term hessian_shift * |du|^2 on the free part of each node's
  input step (the null space of the node's velocity rows for the joint
  velocities, the stance-foot forces and the grasped wrench);
- the step dX, dU solves the whole horizon's KKT system at once;
- merit: total cost and the violation (squared defects, equalities and
  pinned inputs) of each trial X + a dX, U + a dU.
"""
from __future__ import annotations

from functools import partial

import torch
from torch.func import hessian, jacfwd, jacrev, vmap

from . import model as rb
from . import ocp


def _node(m, w, dt, flags, z_vel, x_nom, u_nom, ee_pos, ee_rot, x, u, x_next):
    """One node's LQ data (dt-scaled cost terms)."""
    nx = x.shape[0]
    flow = partial(rb.flow, m)
    f1 = flow(x, u)
    Jx, Ju = jacfwd(flow, argnums=(0, 1))(x, u)
    f2 = flow(x + dt * f1, u)
    eye = torch.eye(nx, dtype=x.dtype, device=x.device)
    A = eye + 0.5 * dt * (Jx + Jx @ (eye + dt * Jx))
    B = 0.5 * dt * (2.0 * Ju + dt * Jx @ Ju)
    d = x + 0.5 * dt * (f1 + f2) - x_next

    def smooth(z):
        return ocp.smooth_cost(w, flags, x_nom, u_nom, z[:nx], z[nx:])

    z = torch.cat([x, u])
    g, H = jacrev(smooth)(z), hessian(smooth)(z)
    err = partial(ocp.ee_error, m, ee_pos=ee_pos, ee_rot=ee_rot)
    e, Je = err(x), jacfwd(err)(x)
    lxx = H[:nx, :nx] + Je.T @ (w.ee[:, None] * Je)
    lx = g[:nx] + Je.T @ (w.ee * e)
    cost = smooth(z) + 0.5 * torch.sum(w.ee * e * e)

    con = partial(ocp.velocity_constraint, m, flags, z_vel)
    g0 = con(x, u)
    Gx, Gu = jacfwd(con, argnums=(0, 1))(x, u)
    return dict(A=A, B=B, d=d, lx=dt * lx, lu=dt * g[nx:], lxx=dt * lxx,
                luu=dt * H[nx:, nx:], lux=dt * H[nx:, :nx], cost=dt * cost,
                g0=g0, Gx=Gx, Gv=Gu[:, 12:30])


def _terminal(m, w, ee_pos, ee_rot, x):
    err = partial(ocp.ee_error, m, ee_pos=ee_pos, ee_rot=ee_rot)
    e, Je = err(x), jacfwd(err)(x)
    return (0.5 * torch.sum(w.ee_final * e * e), Je.T @ (w.ee_final * e),
            Je.T @ (w.ee_final[:, None] * Je))


def linearize(m, w, dt, st, X, U):
    """LQ data of S scenarios: X (S, N+1, 30), U (S, N, nu); ``st`` the
    stage dicts stacked with a leading S axis."""
    N = U.shape[1]
    node = vmap(vmap(partial(_node, m, w, dt), in_dims=(0, 0, 0, 0, None, None, 0, 0, 0)),
                in_dims=(0, 0, 0, 0, 0, 0, 0, 0, 0))
    lq = node(st["flags"][:, :N], st["z_vel"][:, :N], st["x_nom"][:, :N], st["u_nom"][:, :N],
              st["ee_pos"], st["ee_rot"], X[:, :-1], U, X[:, 1:])
    lf, lq["lx_f"], lq["lxx_f"] = vmap(partial(_terminal, m, w))(st["ee_pos"], st["ee_rot"],
                                                                  X[:, -1])
    lq["cost"] = torch.sum(lq["cost"], dim=-1) + lf
    return lq


def kkt_step(lq, st, U, dx0, shift):
    """(dX (S, N+1, 30), dU (S, N, nu)) of the equality-constrained LQ
    problem, one dense KKT solve a scenario.

    Unknowns: dx_0..dx_N, du_0..du_{N-1}, then one multiplier a constraint
    row; an inactive row (a velocity row the contact schedule drops, a pin
    of an input that is free) reads lambda = 0."""
    S, N, nx, nu = U.shape[0], U.shape[1], lq["A"].shape[-1], U.shape[-1]
    dtype, dev = U.dtype, U.device
    flags = st["flags"][:, :N]
    grasp = st["grasp"][:, :N]
    fm = torch.repeat_interleave(flags, 3, dim=-1)                   # (S,N,12) 1 = stance
    act = ocp.velocity_rows(flags)                                   # (S,N,12)
    ux = lambda k: (N + 1) * nx + k * nu  # noqa: E731
    nz = (N + 1) * nx + N * nu
    n_pin = 12 + (6 if nu == 36 else 0)
    rows = nx + N * (nx + 12 + n_pin)
    K = torch.zeros((S, nz + rows, nz + rows), dtype=dtype, device=dev)
    rhs = torch.zeros((S, nz + rows), dtype=dtype, device=dev)
    eye_x = torch.eye(nx, dtype=dtype, device=dev)

    # free part of each node's joint-velocity step: the null space of its rows
    Gv = lq["Gv"]
    P = torch.eye(18, dtype=dtype, device=dev) - torch.linalg.pinv(Gv) @ Gv
    reg = torch.zeros((S, N, nu, nu), dtype=dtype, device=dev)
    reg[:, :, 0:12, 0:12] = torch.diag_embed(fm)
    reg[:, :, 12:30, 12:30] = P
    if nu == 36:
        reg[:, :, 30:36, 30:36] = torch.diag_embed(grasp[..., None].expand(S, N, 6))

    def put(r, c, block):
        K[:, r:r + block.shape[-2], c:c + block.shape[-1]] += block

    for k in range(N):
        xk, uk = k * nx, ux(k)
        put(xk, xk, lq["lxx"][:, k])
        put(uk, uk, lq["luu"][:, k] + shift * reg[:, k])
        put(uk, xk, lq["lux"][:, k])
        put(xk, uk, lq["lux"][:, k].transpose(-1, -2))
        rhs[:, xk:xk + nx] -= lq["lx"][:, k]
        rhs[:, uk:uk + nu] -= lq["lu"][:, k]
    put(N * nx, N * nx, lq["lxx_f"])
    rhs[:, N * nx:(N + 1) * nx] -= lq["lx_f"]

    def con(r, c, block):  # a constraint row block and its transpose
        put(nz + r, c, block)
        put(c, nz + r, block.transpose(-1, -2))

    con(0, 0, eye_x.expand(S, nx, nx))
    rhs[:, nz:nz + nx] = dx0
    r = nx
    for k in range(N):
        xk, uk = k * nx, ux(k)
        con(r, (k + 1) * nx, eye_x.expand(S, nx, nx))                # dx_{k+1}
        con(r, xk, -lq["A"][:, k])                                   # - A dx_k
        con(r, uk, -lq["B"][:, k])                                   # - B du_k
        rhs[:, nz + r:nz + r + nx] = lq["d"][:, k]
        r += nx
        con(r, xk, lq["Gx"][:, k])
        con(r, uk + 12, lq["Gv"][:, k])
        rhs[:, nz + r:nz + r + 12] = -lq["g0"][:, k]
        K[:, nz + r:nz + r + 12, nz + r:nz + r + 12] -= torch.diag_embed(1.0 - act[:, k])
        r += 12
        pinned = torch.cat([1.0 - fm[:, k]] + ([(1.0 - grasp[:, k, None]).expand(S, 6)]
                                               if nu == 36 else []), dim=-1)   # (S, n_pin)
        con(r, uk, torch.cat([torch.diag_embed(pinned[:, :12]),
                              torch.zeros((S, 12, nu - 12), dtype=dtype, device=dev)], -1))
        if nu == 36:
            con(r + 12, uk + 30, torch.diag_embed(pinned[:, 12:]))
        rhs[:, nz + r:nz + r + n_pin] = -pinned * torch.cat(
            [U[:, k, 0:12]] + ([U[:, k, 30:36]] if nu == 36 else []), dim=-1)
        K[:, nz + r:nz + r + n_pin, nz + r:nz + r + n_pin] -= torch.diag_embed(1.0 - pinned)
        r += n_pin
    # one system at a time (a batched solve of systems this large goes to
    # routines meant for small ones)
    sol = torch.stack([torch.linalg.solve(K[i], rhs[i]) for i in range(S)])
    dX = sol[:, :(N + 1) * nx].reshape(S, N + 1, nx)
    dU = sol[:, (N + 1) * nx:nz].reshape(S, N, nu)
    return dX, dU


def merit(m, w, dt, st, X, U, magnitude=False):
    """(cost (S,), violation (S,)) of trajectories X (S, N+1, 30), U (S, N, nu);
    with ``magnitude`` the cost's scale in place of the cost: every barrier
    term by its absolute value."""
    N = U.shape[1]

    def node(flags, z_vel, x_nom, u_nom, grasp, ee_pos, ee_rot, x, u, x_next):
        e = ocp.ee_error(m, x, ee_pos, ee_rot)
        c = (ocp.smooth_cost(w, flags, x_nom, u_nom, x, u, magnitude)
             + 0.5 * torch.sum(w.ee * e * e))
        defect = ocp.rk2(m, x, u, dt) - x_next
        g = ocp.velocity_constraint(m, flags, z_vel, x, u)
        swing = 1.0 - torch.repeat_interleave(flags, 3)
        pinned = torch.sum((swing * u[0:12]) ** 2)
        if u.shape[0] == 36:
            pinned = pinned + torch.sum(((1.0 - grasp) * u[30:36]) ** 2)
        return dt * c, torch.sum(defect * defect) + torch.sum(g * g) + pinned

    f = vmap(vmap(node, in_dims=(0, 0, 0, 0, 0, None, None, 0, 0, 0)))
    c, v = f(st["flags"][:, :N], st["z_vel"][:, :N], st["x_nom"][:, :N], st["u_nom"][:, :N],
             st["grasp"][:, :N], st["ee_pos"], st["ee_rot"], X[:, :-1], U, X[:, 1:])

    def final(ee_pos, ee_rot, x):
        e = ocp.ee_error(m, x, ee_pos, ee_rot)
        return 0.5 * torch.sum(w.ee_final * e * e)

    return torch.sum(c, -1) + vmap(final)(st["ee_pos"], st["ee_rot"], X[:, -1]), torch.sum(v, -1)


def iteration(m, w, cfg, st, x_init, X, U, candidates=False):
    """The reference's step on S scenarios: (dX, dU), the baseline merit
    (cost0, viol0), the linesearch's step sizes (alphas) and, with
    ``candidates``, the merit of each candidate along the step (costs,
    viols (S, L))."""
    s = cfg["sqp"]
    dt = s["dt"]
    lq = linearize(m, w, dt, st, X, U)
    dX, dU = kkt_step(lq, st, U, x_init - X[:, 0], s["hessian_shift"])
    alphas = [s["max_step"] * s["step_reduction"] ** i for i in range(s["linesearch_steps"])]
    out = dict(dX=dX, dU=dU, cost0=lq["cost"], alphas=alphas,
               viol0=merit(m, w, dt, st, X, U)[1])
    if candidates:
        trials = [merit(m, w, dt, st, X + a * dX, U + a * dU) for a in alphas]
        out.update(costs=torch.stack([c for c, _ in trials], -1),
                   viols=torch.stack([v for _, v in trials], -1))
    return out
