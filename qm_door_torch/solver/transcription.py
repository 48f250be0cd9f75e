"""Multiple-shooting transcription: linearization + equality projection
(port of qm_door_tpu/solver/transcription.py).

Per node: RK2 (Heun) discrete dynamics, the Jacobians of the centroidal
flow map, foot-velocity equalities and EE error, RK2 sensitivities
(``frozen`` or ``rk2``), and the cost quadratization. ``lin_tangents``
picks how the q-columns are derived: closed-form analytic pieces
("analytic" / "analytic_bf16") or one 21-tangent forward sweep of the whole
stage-1 graph ("f32" / "bf16", the AD branch, the port's own oracle).
``linearize_ocp`` maps the node function over (B, N) with
``torch.func.vmap``.

Two projections of the state-input equalities:

- batch-major (``project_ocp_batched``): the Cholesky projector as one
  (B*N, 12, 12) x 49-RHS SPD solve (kernel K1 on CUDA) and the blockwise
  substitution du = p + Pu u_red + Px dx with Pu = blkdiag(diag(fm), P[,
  diag(grasp)]) and Px = [0; Px_v; 0];
- per scenario (``project_ocp``): a node function over the N nodes, the
  Cholesky projector (its SPD solve on K1 with the nodes as the batch) or
  the QR basis, and the dense substitution.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import Optional

import torch
from torch.func import jacfwd, jacrev, jvp, vmap

from ..models import centroidal, kinematics, spatial
from ..models.spatial import fmm, fmv
from ..models.dynamics import centroidal_momentum_matrix, com_position
from ..models.model import RobotModel
from ..ocp import constraints as cons
from ..ocp.problem import (OcpConfig, StageData, StageRow, _ee_error,
                           quadratize_stage, quadratize_terminal_ref)
from ..ops.spd_solve import spd_solve
from .projection import arm_lock, project_node_chol, project_node_chol_ft

NX = 30
NU = 30
NU_FT = 36
NU_RED = 26  # QR projection: 12 forces + 14 padded null-space coordinates
NV_JOINTS = 18
NC_ROWS = 12  # masked foot-velocity rows

LIN_TANGENTS = ("f32", "bf16", "analytic", "analytic_bf16")
SENSITIVITIES = ("frozen", "rk2")
PROJECTIONS = ("chol", "qr")


def check_linearization(tangents: str, sensitivity: str) -> None:
    """Reject unknown linearization settings."""
    if tangents not in LIN_TANGENTS:
        raise ValueError(f"lin_tangents={tangents!r}: expected one of {LIN_TANGENTS}")
    if sensitivity not in SENSITIVITIES:
        raise ValueError(f"sensitivity={sensitivity!r}: expected one of {SENSITIVITIES}")


def rk2_step(model: RobotModel, x, u, dt):
    """Heun / explicit midpoint (OCS2 SensitivityIntegrator RK2), input held
    constant over the interval; the flow map by input width (30 / 36)."""
    k1 = centroidal.flow_map_any(model, x, u)
    k2 = centroidal.flow_map_any(model, x + dt * k1, u)
    return x + 0.5 * dt * (k1 + k2)


@dataclass(frozen=True)
class LqProblem:
    """Per-node LQ data in the full (dx, du) space, leading dims (..., N)."""

    A: torch.Tensor     # (..., N, 30, 30)
    B: torch.Tensor     # (..., N, 30, nu)
    d: torch.Tensor     # (..., N, 30) defects  Phi(x_k,u_k) - x_{k+1}
    lx: torch.Tensor    # (..., N, 30)   dt-scaled
    lu: torch.Tensor    # (..., N, nu)
    lxx: torch.Tensor   # (..., N, 30, 30)
    luu: torch.Tensor   # (..., N, nu, nu)
    lux: torch.Tensor   # (..., N, nu, 30)
    cost: torch.Tensor  # (...,) total cost of the current iterate
    g0: torch.Tensor    # (..., N, 12) masked velocity-constraint values
    Gx: torch.Tensor    # (..., N, 12, 30)
    Gv: torch.Tensor    # (..., N, 12, 18)
    lx_f: torch.Tensor  # (..., 30)
    lxx_f: torch.Tensor  # (..., 30, 30)


@dataclass(frozen=True)
class ProjectedLq:
    """LQ data in the reduced input space, ready for Riccati.

    Input recovery du = p + Pu u_red + Px dx, in one of two forms: dense
    ``Pu`` / ``Px`` (per-scenario path, (N, ...)), or structured (batch-major
    path, (B, N, ...)): Pu = blkdiag(diag(force_mask), P[, diag(grasp_gate)]),
    Px = rows 12:30 <- Px_v.
    """

    A: torch.Tensor     # (..., N, 30, 30)  A + B Px
    B: torch.Tensor     # (..., N, 30, nu_red)  B Pu
    d: torch.Tensor     # (..., N, 30)      d + B p
    lx: torch.Tensor
    lu: torch.Tensor
    lxx: torch.Tensor
    luu: torch.Tensor
    lux: torch.Tensor
    lx_f: torch.Tensor
    lxx_f: torch.Tensor
    p: torch.Tensor                            # (..., N, nu)
    Pu: Optional[torch.Tensor] = None          # (N, nu, nu_red) dense form
    Px: Optional[torch.Tensor] = None          # (N, nu, 30)
    P: Optional[torch.Tensor] = None           # (B, N, 18, 18) structured form
    Px_v: Optional[torch.Tensor] = None        # (B, N, 18, 30)
    force_mask: Optional[torch.Tensor] = None  # (B, N, 12)
    grasp_gate: Optional[torch.Tensor] = None  # (B, N, 1), force tracking only


def _flow_force_cols(model, x):
    """Analytic d(flow_map)/dF (30, 12) at one node: forces enter only the
    momentum-rate rows, d hdot_lin/dF_i = I/m, d hdot_ang/dF_i = skew(p_ci - com)/m."""
    q = centroidal.pinocchio_q(x)
    m = torch.sum(model.body_mass)
    p_c = kinematics.contact_positions(model, q)        # (4,3)
    com = com_position(model, q)
    eye = torch.eye(3, dtype=x.dtype, device=x.device)
    lin = torch.cat([eye / m] * 4, dim=1)               # (3,12)
    ang = torch.cat([spatial.skew(p_c[i] - com) / m for i in range(4)], dim=1)
    zeros = torch.zeros((24, 12), dtype=x.dtype, device=x.device)
    return torch.cat([lin, ang, zeros], dim=0)


def _flow_wrench_cols(model, x):
    """Analytic d(flow_map_ft)/dW_ee (30, 6) at one node: the EE wrench
    enters only the momentum-rate rows, d hdot_lin/dF_ee = I/m,
    d hdot_ang/dF_ee = skew(p_ee - com)/m, d hdot_ang/dtau_ee = I/m."""
    q = centroidal.pinocchio_q(x)
    m = torch.sum(model.body_mass)
    _, p_ee = kinematics.ee_pose(model, q)
    com = com_position(model, q)
    eye = torch.eye(3, dtype=x.dtype, device=x.device)
    z3 = torch.zeros((3, 3), dtype=x.dtype, device=x.device)
    lin = torch.cat([eye / m, z3], dim=1)                               # (3,6)
    ang = torch.cat([spatial.skew(p_ee - com) / m, eye / m], dim=1)
    zeros = torch.zeros((24, 6), dtype=x.dtype, device=x.device)
    return torch.cat([lin, ang, zeros], dim=0)


def _flow_input_cols(model, x, nu, dvb_dvj):
    """d(flow)/du (30, nu) at one node: the force columns, the joint-velocity
    columns (through the base velocity), and at nu = 36 the wrench columns."""
    dev = x.device
    z6_18 = torch.zeros((6, 18), dtype=x.dtype, device=dev)
    df_dvj = torch.cat([z6_18, dvb_dvj, torch.eye(18, dtype=x.dtype, device=dev)], dim=0)
    cols = [_flow_force_cols(model, x), df_dvj]
    if nu == NU_FT:
        cols.append(_flow_wrench_cols(model, x))
    return torch.cat(cols, dim=1)


def _cast_bf16(model: RobotModel, *tensors):
    """bfloat16 copies of the model and tensors: one f32 operand would
    silently promote the whole chain back to f32."""
    return (model.to(dtype=torch.bfloat16),) + tuple(t.to(torch.bfloat16) for t in tensors)


def _basis_jacobian(fn, q):
    """d fn / d q (m, n) as ``torch.func.vmap`` of ``torch.func.jvp`` over the
    n basis tangents (the role of ``jax.vmap`` over ``jax.linearize``'s jvp)."""
    eye = torch.eye(q.shape[-1], dtype=q.dtype, device=q.device)
    return vmap(lambda t: jvp(fn, (q,), (t,))[1])(eye).T


def _flow_q_jacobian_analytic(model, x, u, sweep: str = "f32"):
    """Closed-form d(flow)/dq (30, 24) at one node — no tangent sweep through
    the CMM.

    - ``hdot_lin`` rows: q-independent — zero.
    - ``hdot_ang`` rows: -(1/m) sum_i skew(F_i) (J_ci - Jcom), Jcom = A[:3]/m
      (plus the EE wrench's force at its frame at nu = 36).
    - ``v_b`` rows: -A_b^{-1} d(A(q) v_bar)/dq at the frozen primal velocity
      v_bar, by REVERSE-mode AD (6 cotangents through the CMM); the xyz
      columns are exact zeros (translation invariance).
    - ``v_j`` rows: q-independent — zero.

    Returns (dq_f1 (30,24), A (6,24), v_bar (24,), Jall (5,6,24)) with Jall
    the feet + EE LWA frame Jacobians.
    """
    dtype = x.dtype
    q = centroidal.pinocchio_q(x)
    h = x[0:6]
    v_j = u[12:30]
    F = u[0:12].reshape(4, 3)
    m = torch.sum(model.body_mass)

    A = centroidal_momentum_matrix(model, q)
    rhs = m * h - spatial.fmv(A[:, 6:], v_j)
    v_b = spatial.solve6_block(A[:, :6], rhs)
    v_bar = torch.cat([v_b, v_j])

    xyz = q[0:3]
    if sweep == "bf16":
        # only the Jacobian is bf16-derived; every primal stays in dtype
        model_s, xyz_s, v_bar_s = _cast_bf16(model, xyz, v_bar)

        def w_fn(q_ej):
            return centroidal_momentum_matrix(model_s, torch.cat([xyz_s, q_ej])) @ v_bar_s

        Jw_ej = jacrev(w_fn)(q[3:24].to(torch.bfloat16)).to(dtype)
    else:
        def w_fn(q_ej):
            return centroidal_momentum_matrix(model, torch.cat([xyz, q_ej])) @ v_bar

        Jw_ej = jacrev(w_fn)(q[3:24])                                # (6, 21)
    z6_3 = torch.zeros((6, 3), dtype=dtype, device=x.device)
    dvb_dq = -spatial.solve6_block(A[:, :6], torch.cat([z6_3, Jw_ej], dim=1))

    fids = tuple(model.contact_frame_ids) + (model.ee_frame_id,)
    Jall = kinematics.frame_jacobians(model, q, fids)                # (5, 6, 24)
    Jcom = A[:3, :] / m

    dh_ang = torch.zeros((3, 24), dtype=dtype, device=x.device)
    for i in range(4):
        dh_ang = dh_ang - spatial.fmm(spatial.skew(F[i]), Jall[i, :3, :] - Jcom) / m
    if u.shape[-1] == NU_FT:
        W = u[30:36]
        dh_ang = dh_ang - spatial.fmm(spatial.skew(W[0:3]), Jall[4, :3, :] - Jcom) / m

    dq_f1 = torch.cat([
        torch.zeros((3, 24), dtype=dtype, device=x.device),
        dh_ang,
        dvb_dq,
        torch.zeros((18, 24), dtype=dtype, device=x.device),
    ], dim=0)
    return dq_f1, A, v_bar, Jall


def _momentum_velocity_coeffs(model, q, A=None):
    """Linear-structure coefficients of the base velocity at fixed q:
        d v_b / dh  = m A_b^{-1},   d v_b / dvj = -A_b^{-1} A_j
    ``A``: the CMM at q, when the caller already has it."""
    m = torch.sum(model.body_mass)
    if A is None:
        A = centroidal_momentum_matrix(model, q)
    eye6 = torch.eye(6, dtype=q.dtype, device=q.device)
    sol = spatial.solve6_block(A[:, :6], torch.cat([m * eye6, A[:, 6:]], dim=1))
    return sol[:, :6], -sol[:, 6:]


def _stage1_analytic(model, ocp, row: StageRow, x, u, sweep):
    """The analytic branch's stage-1 pieces: (f1, g0, e, dq_f1, dq_g, Je_q,
    A_cmm, Jfeet_lin). Two small AD passes remain: a 21-tangent forward
    sweep through the FK-only foot-velocity chain and a 3-tangent
    quaternion-error differential; "bf16" runs the foot-velocity sweep and
    the CMM cotangents in bfloat16."""
    dtype, dev = x.dtype, x.device
    q_bar = x[6:30]
    dq_f1, A_cmm, v_bar_frozen, Jall = _flow_q_jacobian_analytic(model, x, u, sweep=sweep)
    f1 = centroidal.flow_map_any(model, x, u)
    g0 = cons.velocity_constraint(model, x, u, row.contact_flags, row.z_vel_ref)
    e = _ee_error(model, ocp, x, row.ee_pos_ref, row.ee_quat_ref)

    if sweep == "bf16":
        model_s, xyz_s, v_bar_s = _cast_bf16(model, q_bar[0:3], v_bar_frozen)
        q_ej = q_bar[3:24].to(torch.bfloat16)
    else:
        model_s, xyz_s, v_bar_s = model, q_bar[0:3], v_bar_frozen
        q_ej = q_bar[3:24]

    def fv_fn(q_ej_):
        J = kinematics.frame_jacobians(
            model_s, torch.cat([xyz_s, q_ej_]), tuple(model.contact_frame_ids))
        return spatial.fmv(J[:, :3, :], v_bar_s).reshape(12)

    Jfv_ej = jacfwd(fv_fn)(q_ej).to(dtype)                           # (12, 21)
    mask = cons.velocity_row_mask(row.contact_flags)
    Jlin = Jall[:4, :3, :].reshape(12, 24)  # the feet rows of Jall
    z12_3 = torch.zeros((12, 3), dtype=dtype, device=dev)
    dq_g = mask[:, None] * (torch.cat([z12_3, Jfv_ej], dim=1) + Jlin[:, :6] @ dq_f1[6:12])

    R_ee, _ = kinematics.ee_pose(model, q_bar)
    eye3 = torch.eye(3, dtype=dtype, device=dev)
    D_ori = jacfwd(lambda t: spatial.quat_error_ocs2(
        spatial.rot_to_quat((eye3 + spatial.skew(t)) @ R_ee), row.ee_quat_ref
    ))(torch.zeros(3, dtype=dtype, device=dev))                      # (3, 3)
    Je_q = torch.cat([Jall[4, :3, :], D_ori @ Jall[4, 3:6, :]], dim=0)  # (6, 24)
    return f1, g0, e, dq_f1, dq_g, Je_q, A_cmm, Jlin


def _stage1_ad(model, ocp, row: StageRow, x, u, sweep):
    """The AD branch's stage-1 pieces, as :func:`_stage1_analytic` returns
    them (A_cmm None): one 21-tangent forward sweep (euler + joint columns)
    of the whole stage-1 graph — flow map, velocity constraint, EE error —
    at the base translation held fixed. Every stage-1 output but the EE
    position error is invariant to a base translation, whose xyz columns
    are exactly I3. "bf16" sweeps with every captured operand in bfloat16,
    model included; the primals are computed in the working dtype, so the
    defects, constraint values and cost stay exact."""
    dtype, dev = x.dtype, x.device
    h_bar, q_bar = x[0:6], x[6:30]

    def stage1_of(m_, h_, xyz_, u_, flags_, zref_, pos_, quat_):
        def stage1(q_ej):
            x_ = torch.cat([h_, xyz_, q_ej])
            return torch.cat([
                centroidal.flow_map_any(m_, x_, u_),
                cons.velocity_constraint(m_, x_, u_, flags_, zref_),
                _ee_error(m_, ocp, x_, pos_, quat_)])
        return stage1

    operands = (h_bar, q_bar[0:3], u, row.contact_flags, row.z_vel_ref, row.ee_pos_ref,
                row.ee_quat_ref)
    stage1 = stage1_of(model, *operands)
    out1 = stage1(q_bar[3:24])
    if sweep == "bf16":
        J1 = _basis_jacobian(stage1_of(*_cast_bf16(model, *operands)),
                             q_bar[3:24].to(torch.bfloat16)).to(dtype)
    else:
        J1 = _basis_jacobian(stage1, q_bar[3:24])                    # (48, 21)
    f1, g0, e = out1[:30], out1[30:42], out1[42:48]
    z30_3 = torch.zeros((30, 3), dtype=dtype, device=dev)
    z12_3 = torch.zeros((12, 3), dtype=dtype, device=dev)
    e_xyz = torch.cat([torch.eye(3, dtype=dtype, device=dev),
                       torch.zeros((3, 3), dtype=dtype, device=dev)], dim=0)
    dq_f1 = torch.cat([z30_3, J1[:30]], dim=1)                       # (30, 24)
    dq_g = torch.cat([z12_3, J1[30:42]], dim=1)                      # (12, 24)
    Je_q = torch.cat([e_xyz, J1[42:48]], dim=1)                      # (6, 24)
    Jfeet = kinematics.frame_jacobians(model, q_bar, tuple(model.contact_frame_ids))
    return f1, g0, e, dq_f1, dq_g, Je_q, None, Jfeet[:, :3, :].reshape(12, 24)


def _node_linearization(model, ocp: OcpConfig, dt, row: StageRow, x, u, x_next,
                        sensitivity: str = "frozen", tangents: str = "analytic"):
    """One node's LQ data: (A, B, d, l, lx, lu, lxx, luu, lux, g0, Gx, Gv),
    cost terms dt-scaled.

    The flow map, foot-velocity equalities and EE error are nonlinear only in
    q (24); they are LINEAR in the normalized momentum h (6) and the joint
    velocities v_j (18). So the q-columns come from :func:`_stage1_analytic`
    or :func:`_stage1_ad` (by ``tangents``), and the h / v_j / force (and
    wrench) columns are assembled from A_b^{-1}, A_j and the foot Jacobians.

    ``sensitivity``: "frozen" — the second RK2 stage reuses the first
    stage's Jacobian; "rk2" — the second flow Jacobian at the midpoint state
    (the analytic pieces there, or a 21-tangent sweep of the flow map in the
    working dtype on the AD branch). The defect stays exact RK2 either way.
    """
    check_linearization(tangents, sensitivity)
    dtype, dev = x.dtype, x.device
    nu = u.shape[-1]  # 30 nominal / 36 force-tracking
    q_bar = x[6:30]
    analytic = tangents.startswith("analytic")
    sweep = "bf16" if tangents in ("bf16", "analytic_bf16") else "f32"
    stage1 = _stage1_analytic if analytic else _stage1_ad
    f1, g0, e, dq_f1, dq_g, Je_q, A_cmm, Jlin = stage1(model, ocp, row, x, u, sweep)

    dvb_dh, dvb_dvj = _momentum_velocity_coeffs(model, q_bar, A=A_cmm)
    z6_6 = torch.zeros((6, 6), dtype=dtype, device=dev)
    z18_6 = torch.zeros((18, 6), dtype=dtype, device=dev)
    df1_dh = torch.cat([z6_6, dvb_dh, z18_6], dim=0)                 # (30, 6)

    mask = cons.velocity_row_mask(row.contact_flags)
    dg_dh = mask[:, None] * (Jlin[:, :6] @ dvb_dh)                   # (12, 6)
    dg_dvj = mask[:, None] * (Jlin[:, :6] @ dvb_dvj + Jlin[:, 6:])

    df1_dx = torch.cat([df1_dh, dq_f1], dim=1)                       # (30, 30)
    df1_du = _flow_input_cols(model, x, nu, dvb_dvj)                 # (30, nu)
    Gx = torch.cat([dg_dh, dq_g], dim=1)                             # (12, 30)
    Gv = dg_dvj
    Je = torch.cat([z6_6, Je_q], dim=1)

    x2 = x + dt * f1
    f2 = centroidal.flow_map_any(model, x2, u)
    if sensitivity == "frozen":
        df2_dx2, df2_du = df1_dx, df1_du
    else:
        q2 = x2[6:30]
        if analytic:
            J2q, A2, _, _ = _flow_q_jacobian_analytic(model, x2, u, sweep=sweep)
        else:
            def stage2(q_ej):
                return centroidal.flow_map_any(model, torch.cat([x2[0:6], q2[0:3], q_ej]), u)

            z30_3 = torch.zeros((30, 3), dtype=dtype, device=dev)
            J2q, A2 = torch.cat([z30_3, _basis_jacobian(stage2, q2[3:24])], dim=1), None
        dvb2_dh, dvb2_dvj = _momentum_velocity_coeffs(model, q2, A=A2)
        df2_dx2 = torch.cat([torch.cat([z6_6, dvb2_dh, z18_6], dim=0), J2q], dim=1)
        df2_du = _flow_input_cols(model, x2, nu, dvb2_dvj)

    # RK2 (Heun) discrete sensitivities: Phi = x + dt/2 (f1 + f2(x + dt f1, u))
    eye30 = torch.eye(30, dtype=dtype, device=dev)
    A = eye30 + 0.5 * dt * (df1_dx + df2_dx2 @ (eye30 + dt * df1_dx))
    B = 0.5 * dt * (df1_du + df2_du + dt * (df2_dx2 @ df1_du))
    d = x + 0.5 * dt * (f1 + f2) - x_next

    l, lx, lu, lxx, luu, lux = quadratize_stage(model, ocp, row, x, u, ee_lin=(e, Je))
    return A, B, d, dt * l, dt * lx, dt * lu, dt * lxx, dt * luu, dt * lux, g0, Gx, Gv


def linearize_ocp(model: RobotModel, ocp: OcpConfig, stage: StageData, dt, X, U,
                  sensitivity: str = "frozen", tangents: str = "analytic",
                  stage_batched: bool = False) -> LqProblem:
    """Linearization of dynamics/cost/constraints along X (B, N+1, 30) /
    U (B, N, nu), vmapped over the scenarios and the nodes. The stage data
    is shared, or has a leading B axis with ``stage_batched``."""
    check_linearization(tangents, sensitivity)
    if X.dim() != 3:
        raise ValueError(f"X must be (B, N+1, 30), got {tuple(X.shape)}")
    if stage_batched != (stage.contact_flags.dim() == 3):
        raise ValueError(f"stage_batched={stage_batched} but contact_flags has shape "
                         f"{tuple(stage.contact_flags.shape)}")
    N = U.shape[-2]
    s_dim = 0 if stage_batched else None
    node = vmap(vmap(partial(_node_linearization, model, ocp, dt,
                             sensitivity=sensitivity, tangents=tangents)),
                in_dims=(s_dim, 0, 0, 0))
    term = vmap(partial(quadratize_terminal_ref, model, ocp), in_dims=(s_dim, s_dim, 0))
    A, B, d, l, lx, lu, lxx, luu, lux, g0, Gx, Gv = node(
        stage.rows(slice(0, N)), X[:, :-1], U, X[:, 1:])
    lf, lx_f, lxx_f = term(stage.ee_pos_ref[..., -1, :], stage.ee_quat_ref[..., -1, :],
                           X[:, -1])
    return LqProblem(
        A=A, B=B, d=d, lx=lx, lu=lu, lxx=lxx, luu=luu, lux=lux,
        cost=torch.sum(l, dim=-1) + lf,
        g0=g0, Gx=Gx, Gv=Gv, lx_f=lx_f, lxx_f=lxx_f,
    )


# ---------------------------------------------------------------------------
# per-scenario projection (dense substitution)
# ---------------------------------------------------------------------------

def _row_permutation(flags):
    """Permutation putting active velocity rows first (stable), over leading
    node dims. Row activity: stance foot -> (1,1,1); swing foot -> (0,0,1).
    Returns (perm (..., 12), activity (..., 12), r (...,)) with r = the
    number of active rows = 2c + 4."""
    activity = cons.velocity_row_mask(flags)
    perm = torch.argsort(-activity, dim=-1, stable=True)
    r = torch.sum(activity, dim=-1).to(torch.int64)
    return perm, activity, r


def _project_node(flags, F_bar, g0, Gx, Gv, shift):
    """The affine reduced-input parametrization by QR, for nodes with any
    leading dims: du = p + Pu u_red + Px dx, u_red = [dF_tilde(12); w(14)].
    Returns (p (...,30), Pu (...,30,26), Px (...,30,30), reg (...,26,26))."""
    dtype, dev = g0.dtype, g0.device
    perm, _, r = _row_permutation(flags)
    g0p = torch.take_along_dim(g0, perm, dim=-1)
    Gxp = torch.take_along_dim(Gx, perm[..., None], dim=-2)
    Gvp = torch.take_along_dim(Gv, perm[..., None], dim=-2)

    # QR of Gv_perm^T (18 x 12): Gv = R^T Q^T
    Q, R = torch.linalg.qr(Gvp.transpose(-1, -2), mode="complete")  # (...,18,18), (...,18,12)
    Rtop = R[..., :NC_ROWS, :]  # upper triangular; columns >= r are zero

    # padded triangular solve: R^T y = rhs with a unit diagonal on inactive rows
    active_row = torch.arange(NC_ROWS, device=dev) < r[..., None]
    Rsafe = Rtop + torch.diag_embed((~active_row).to(dtype))

    def pinv_apply(rhs):
        y = torch.linalg.solve_triangular(Rsafe.transpose(-1, -2), rhs, upper=False)
        return Q[..., :, :NC_ROWS] @ y                              # (..., 18, k)

    du_part = -pinv_apply(g0p[..., None])[..., 0]                   # (..., 18)
    Px_v = -pinv_apply(Gxp)                                          # (..., 18, 30)

    # null-space basis: columns r .. r+13 of Q, masked by j < 18 - r
    j14 = torch.arange(14, device=dev)
    cols = torch.clamp(r[..., None] + j14, 0, NV_JOINTS - 1)        # (..., 14)
    w_mask = (j14 < (NV_JOINTS - r[..., None])).to(dtype)
    Nbasis = torch.take_along_dim(Q, cols[..., None, :], dim=-1) * w_mask[..., None, :]

    # force elimination: stance dims free, swing dims pinned to -F_bar
    force_mask = torch.repeat_interleave(flags, 3, dim=-1)           # (..., 12) 1 = stance
    p = torch.cat([-(1.0 - force_mask) * F_bar, du_part], dim=-1)
    lead = g0.shape[:-1]
    z = lambda *s: torch.zeros(*lead, *s, dtype=dtype, device=dev)  # noqa: E731
    Pu = torch.cat([torch.cat([torch.diag_embed(force_mask), z(12, 14)], dim=-1),
                    torch.cat([z(18, 12), Nbasis], dim=-1)], dim=-2)
    Px = torch.cat([z(12, NX), Px_v], dim=-2)
    # regularization of the padded reduced dims (swing forces, padded w)
    red_mask = torch.cat([force_mask, w_mask], dim=-1)
    reg = torch.diag_embed(1.0 - red_mask) + shift * torch.eye(NU_RED, dtype=dtype, device=dev)
    return p, Pu, Px, reg


def project_ocp(lq: LqProblem, stage: StageData, U, shift=1e-5, method: str = "chol",
                arm_locked: bool = False) -> ProjectedLq:
    """Force elimination + velocity-constraint projection of one scenario's
    LQ data (N, ...), with the dense substitution.

    method: "chol" (Cholesky projector, reduced dim 30 / 36) or "qr"
    (orthonormal padded basis, reduced dim 26). The force-tracking problem
    (nu = 36, stage.grasp_flags) and ``arm_locked`` take the Cholesky
    projector only. ``stage`` needs ``contact_flags`` (and ``grasp_flags``).
    """
    if method not in PROJECTIONS:
        raise ValueError(f"method={method!r}: expected one of {PROJECTIONS}")
    N = U.shape[0]
    flags = stage.contact_flags[:N]
    F_bar = U[:, 0:12]
    if U.shape[-1] == NU_FT:
        p, Pu, Px, reg = project_node_chol_ft(
            flags, stage.grasp_flags[:N], F_bar, U[:, 30:36], lq.g0, lq.Gx, lq.Gv, shift)
    elif arm_locked:
        if method != "chol":
            raise ValueError("arm_locked requires the chol projection")
        p, Pu, Px, reg = project_node_chol(flags, F_bar, lq.g0, lq.Gx, lq.Gv, shift,
                                           v_arm=U[:, 24:30], arm_locked=True)
    else:
        node_fn = project_node_chol if method == "chol" else _project_node
        p, Pu, Px, reg = node_fn(flags, F_bar, lq.g0, lq.Gx, lq.Gv, shift)
    return _apply_projection(lq, p, Pu, Px, reg)


def _apply_projection(lq: LqProblem, p, Pu, Px, reg) -> ProjectedLq:
    """Substitute du = p + Pu u_red + Px dx into dynamics and cost (dense
    maps; any leading dims)."""
    es = torch.einsum
    A_bar = lq.A + lq.B @ Px
    B_bar = lq.B @ Pu
    d_bar = lq.d + es("...ij,...j->...i", lq.B, p)

    # cost substitution du = p + Pu u + Px dx into
    #   1/2 dx'lxx dx + 1/2 du'luu du + du'lux dx + lx'dx + lu'du :
    lu_p = lq.lu + es("...ij,...j->...i", lq.luu, p)                # lu + luu p
    lx_bar = (lq.lx + es("...ui,...u->...i", Px, lu_p)               # Px^T (lu + luu p)
              + es("...ui,...u->...i", lq.lux, p))                   # lux^T p
    lu_bar = es("...ui,...u->...i", Pu, lu_p)
    PxT_lux = es("...ui,...ux->...ix", Px, lq.lux)                   # Px^T lux
    lxx_bar = (lq.lxx + PxT_lux + PxT_lux.transpose(-1, -2)
               + es("...ui,...uv,...vx->...ix", Px, lq.luu, Px))
    luu_bar = es("...ui,...uv,...vj->...ij", Pu, lq.luu, Pu) + reg
    lux_bar = (es("...ui,...ux->...ix", Pu, lq.lux)
               + es("...ui,...uv,...vx->...ix", Pu, lq.luu, Px))
    return ProjectedLq(
        A=A_bar, B=B_bar, d=d_bar,
        lx=lx_bar, lu=lu_bar, lxx=lxx_bar, luu=luu_bar, lux=lux_bar,
        lx_f=lq.lx_f, lxx_f=lq.lxx_f, p=p, Pu=Pu, Px=Px,
    )


# ---------------------------------------------------------------------------
# batch-major projection (structured substitution)
# ---------------------------------------------------------------------------

def project_ocp_batched(lq: LqProblem, flags, U, shift=1e-5, grasp=None,
                        arm_locked: bool = False) -> ProjectedLq:
    """Batch-major Cholesky-projector projection over (B, N, ...) LQ data.

    The single SPD solve runs as ONE (B*N, 12, 12) x 49-RHS call to K1.
    flags (B,N,4); U (B,N,nu); grasp (B,N) for the force-tracking problem
    (nu = 36). ``arm_locked`` (nu = 30 only): the quad-only variant, the
    arm-velocity inputs pinned to zero (projection.arm_lock).
    """
    dtype, dev = lq.g0.dtype, lq.g0.device
    B, N = flags.shape[0], flags.shape[1]
    nu = U.shape[-1]
    if nu not in (NU, NU_FT):
        raise ValueError(f"project_ocp_batched: nu = {nu}, expected {NU} or {NU_FT}")
    if (nu == NU_FT) != (grasp is not None):
        raise ValueError("project_ocp_batched: grasp is given exactly for nu = 36")
    active = cons.velocity_row_mask(flags)                          # (B,N,12)
    eye12 = torch.eye(NC_ROWS, dtype=dtype, device=dev)
    if arm_locked and nu != NU:
        raise ValueError("arm_locked requires the 30-input problem")
    col_mask, Gv, p_lock_v, g0 = arm_lock(lq.Gv, lq.g0, U[..., 24:30], arm_locked)
    GvT = Gv.transpose(-1, -2)                                       # (B,N,18,12)
    # M = Gv Gv^T + diag(1 - active): symmetric by construction
    M = fmm(Gv, GvT) + (1.0 - active)[..., :, None] * eye12
    rhs = torch.cat([g0[..., None], lq.Gx, Gv], dim=-1)             # (B,N,12,49)
    W = spd_solve(M.reshape(B * N, NC_ROWS, NC_ROWS).contiguous(),
                  rhs.reshape(B * N, NC_ROWS, -1).contiguous())
    W = W.reshape(B, N, NC_ROWS, -1)

    Minv_g0 = W[..., 0]                                              # (B,N,12)
    Minv_Gx = W[..., 1:1 + NX]                                       # (B,N,12,30)
    pinvT = W[..., 1 + NX:]                                          # (B,N,12,18)

    du_part = -torch.sum(Gv * Minv_g0[..., None], dim=-2)            # (B,N,18)
    if p_lock_v is not None:
        du_part = p_lock_v + du_part
    Px_v = -fmm(GvT, Minv_Gx)                                        # (B,N,18,30)
    P = torch.diag(col_mask) - fmm(GvT, pinvT)

    force_mask = torch.repeat_interleave(flags, 3, dim=-1)           # (B,N,12)
    parts = [-(1.0 - force_mask) * U[..., 0:12], du_part]
    g = None
    if nu == NU_FT:
        g = grasp[..., None]                                         # (B,N,1)
        parts.append(-(1.0 - g) * U[..., 30:36])
    return _apply_projection_structured(lq, torch.cat(parts, dim=-1), P, Px_v, force_mask,
                                        grasp=g, shift=shift)


def _apply_projection_structured(lq: LqProblem, p, P, Px_v, fm, grasp=None,
                                 shift=1e-5) -> ProjectedLq:
    """Blockwise du = p + Pu u_red + Px dx substitution for the batched path.

    Pu = blkdiag(diag(fm), P[, diag(grasp)]) and Px = [0; Px_v; 0]: the force
    (and wrench) blocks are elementwise row/column scalings and only the
    18-dim joint-velocity block carries dense products. p (B,N,nu);
    P (B,N,18,18); Px_v (B,N,18,30); fm (B,N,12); grasp (B,N,1) for the
    36-input force-tracking problem.
    """
    dtype, dev = lq.A.dtype, lq.A.device
    nu = lq.B.shape[-1]
    PT = P.transpose(-1, -2)
    Px_vT = Px_v.transpose(-1, -2)

    B_F = lq.B[..., :, 0:12]
    B_v = lq.B[..., :, 12:30]
    A_bar = lq.A + fmm(B_v, Px_v)
    d_bar = lq.d + fmv(lq.B, p)

    lu_p = lq.lu + fmv(lq.luu, p)                                    # lu + luu p
    lu_p_v = lu_p[..., 12:30]
    lux_v = lq.lux[..., 12:30, :]
    luu_Fv = lq.luu[..., 0:12, 12:30]
    luu_vv = lq.luu[..., 12:30, 12:30]

    lx_bar = lq.lx + fmv(Px_vT, lu_p_v) + fmv(lq.lux.transpose(-1, -2), p)
    PxT_lux = fmm(Px_vT, lux_v)                                      # Px^T lux
    lxx_bar = lq.lxx + PxT_lux + PxT_lux.transpose(-1, -2) + fmm(Px_vT, fmm(luu_vv, Px_v))

    fm_col = fm[..., None, :]    # scale columns indexed by F
    fm_row = fm[..., :, None]    # scale rows indexed by F
    eye18 = torch.eye(NV_JOINTS, dtype=dtype, device=dev)
    eye12 = torch.eye(12, dtype=dtype, device=dev)

    FF_bar = fm_row * lq.luu[..., 0:12, 0:12] * fm_col + (1.0 - fm[..., :, None]) * eye12
    Fv_bar = fm_row * fmm(luu_Fv, P)
    vv_bar = fmm(PT, fmm(luu_vv, P)) + (eye18 - P)
    lux_F_bar = fm_row * (lq.lux[..., 0:12, :] + fmm(luu_Fv, Px_v))
    lux_v_bar = fmm(PT, lux_v + fmm(luu_vv, Px_v))
    lu_bar = [fm * lu_p[..., 0:12], fmv(PT, lu_p_v)]
    B_bar = [B_F * fm_col, fmm(B_v, P)]
    lux_bar = [lux_F_bar, lux_v_bar]

    if nu == NU_FT:
        gc = grasp[..., None]                                        # (B,N,1,1)
        luu_vW = lq.luu[..., 12:30, 30:36]
        FW_bar = fm_row * lq.luu[..., 0:12, 30:36] * gc
        vW_bar = fmm(PT, luu_vW) * gc
        WW_bar = gc * lq.luu[..., 30:36, 30:36] * gc + (1.0 - gc) * torch.eye(
            6, dtype=dtype, device=dev)
        luu_rows = [torch.cat([FF_bar, Fv_bar, FW_bar], dim=-1),
                    torch.cat([Fv_bar.transpose(-1, -2), vv_bar, vW_bar], dim=-1),
                    torch.cat([FW_bar.transpose(-1, -2), vW_bar.transpose(-1, -2), WW_bar],
                              dim=-1)]
        lux_bar.append(gc * (lq.lux[..., 30:36, :] + fmm(luu_vW.transpose(-1, -2), Px_v)))
        lu_bar.append(grasp * lu_p[..., 30:36])
        B_bar.append(lq.B[..., :, 30:36] * gc)
    else:
        luu_rows = [torch.cat([FF_bar, Fv_bar], dim=-1),
                    torch.cat([Fv_bar.transpose(-1, -2), vv_bar], dim=-1)]
    luu_bar = torch.cat(luu_rows, dim=-2) + shift * torch.eye(nu, dtype=dtype, device=dev)
    return ProjectedLq(
        A=A_bar, B=torch.cat(B_bar, dim=-1), d=d_bar,
        lx=lx_bar, lu=torch.cat(lu_bar, dim=-1),
        lxx=lxx_bar, luu=luu_bar, lux=torch.cat(lux_bar, dim=-2),
        lx_f=lq.lx_f, lxx_f=lq.lxx_f,
        p=p, P=P, Px_v=Px_v, force_mask=fm, grasp_gate=grasp,
    )
