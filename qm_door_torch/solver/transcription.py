"""Multiple-shooting transcription: linearization + equality projection
(port of the batched path of qm_door_tpu/solver/transcription.py).

Per node: RK2 (Heun) discrete dynamics, closed-form analytic derivatives of
the centroidal flow map, foot-velocity equalities and EE error
(``lin_tangents`` "analytic" / "analytic_bf16"), ``frozen`` RK2
sensitivities, and the cost quadratization. ``linearize_ocp`` maps the node
function over (B, N) with ``torch.func.vmap``.

The projection is the Cholesky projector of the batched path: one
(B*N, 12, 12) x 49-RHS SPD solve (kernel K1 on CUDA) and the blockwise
substitution du = p + Pu u_red + Px dx with Pu = blkdiag(diag(fm), P) and
Px = [0; Px_v].
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import torch
from torch.func import jacfwd, jacrev, vmap

from ..models import centroidal, kinematics, spatial
from ..models.spatial import fmm, fmv
from ..models.dynamics import centroidal_momentum_matrix, com_position
from ..models.model import RobotModel
from ..ocp import constraints as cons
from ..ocp.problem import (OcpConfig, StageData, StageRow, _ee_error,
                           quadratize_stage, quadratize_terminal)
from ..ops.spd_solve import spd_solve

NX = 30
NU = 30
NV_JOINTS = 18
NC_ROWS = 12  # masked foot-velocity rows

LIN_TANGENTS = ("f32", "bf16", "analytic", "analytic_bf16")
SENSITIVITIES = ("frozen", "rk2")


def check_linearization(tangents: str, sensitivity: str) -> None:
    """Reject unknown linearization settings, and known ones not ported yet."""
    if tangents not in LIN_TANGENTS:
        raise ValueError(f"lin_tangents={tangents!r}: expected one of {LIN_TANGENTS}")
    if sensitivity not in SENSITIVITIES:
        raise ValueError(f"sensitivity={sensitivity!r}: expected one of {SENSITIVITIES}")
    if not tangents.startswith("analytic"):
        raise NotImplementedError(f"lin_tangents={tangents!r} is not ported yet")
    if sensitivity != "frozen":
        raise NotImplementedError(f"sensitivity={sensitivity!r} is not ported yet")


def rk2_step(model: RobotModel, x, u, dt):
    """Heun / explicit midpoint (OCS2 SensitivityIntegrator RK2), input held
    constant over the interval."""
    k1 = centroidal.flow_map_any(model, x, u)
    k2 = centroidal.flow_map_any(model, x + dt * k1, u)
    return x + 0.5 * dt * (k1 + k2)


@dataclass(frozen=True)
class LqProblem:
    """Per-node LQ data in the full (dx, du) space, leading dims (..., N)."""

    A: torch.Tensor     # (..., N, 30, 30)
    B: torch.Tensor     # (..., N, 30, 30)
    d: torch.Tensor     # (..., N, 30) defects  Phi(x_k,u_k) - x_{k+1}
    lx: torch.Tensor    # (..., N, 30)   dt-scaled
    lu: torch.Tensor    # (..., N, 30)
    lxx: torch.Tensor   # (..., N, 30, 30)
    luu: torch.Tensor   # (..., N, 30, 30)
    lux: torch.Tensor   # (..., N, 30, 30)
    cost: torch.Tensor  # (...,) total cost of the current iterate
    g0: torch.Tensor    # (..., N, 12) masked velocity-constraint values
    Gx: torch.Tensor    # (..., N, 12, 30)
    Gv: torch.Tensor    # (..., N, 12, 18)
    lx_f: torch.Tensor  # (..., 30)
    lxx_f: torch.Tensor  # (..., 30, 30)


@dataclass(frozen=True)
class ProjectedLq:
    """LQ data in the reduced input space, ready for Riccati (B, N, ...).

    Input recovery du = p + Pu u_red + Px dx in structured form:
    Pu = blkdiag(diag(force_mask), P), Px = rows 12:30 <- Px_v.
    """

    A: torch.Tensor     # (B, N, 30, 30)  A + B Px
    B: torch.Tensor     # (B, N, 30, 30)  B Pu
    d: torch.Tensor     # (B, N, 30)      d + B p
    lx: torch.Tensor
    lu: torch.Tensor
    lxx: torch.Tensor
    luu: torch.Tensor
    lux: torch.Tensor
    lx_f: torch.Tensor
    lxx_f: torch.Tensor
    p: torch.Tensor           # (B, N, 30)
    P: torch.Tensor           # (B, N, 18, 18)
    Px_v: torch.Tensor        # (B, N, 18, 30)
    force_mask: torch.Tensor  # (B, N, 12)


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


def _cast_bf16(model: RobotModel, *tensors):
    """bfloat16 copies of the model and tensors: one f32 operand would
    silently promote the whole chain back to f32."""
    return (model.to(dtype=torch.bfloat16),) + tuple(t.to(torch.bfloat16) for t in tensors)


def _flow_q_jacobian_analytic(model, x, u, sweep: str = "f32"):
    """Closed-form d(flow)/dq (30, 24) at one node — no tangent sweep through
    the CMM.

    - ``hdot_lin`` rows: q-independent — zero.
    - ``hdot_ang`` rows: -(1/m) sum_i skew(F_i) (J_ci - Jcom), Jcom = A[:3]/m.
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


def _node_linearization(model, ocp: OcpConfig, dt, row: StageRow, x, u, x_next,
                        sensitivity: str = "frozen", tangents: str = "analytic"):
    """One node's LQ data: (A, B, d, l, lx, lu, lxx, luu, lux, g0, Gx, Gv),
    cost terms dt-scaled.

    The flow map, foot-velocity equalities and EE error are nonlinear only in
    q (24); they are LINEAR in the normalized momentum h (6) and the joint
    velocities v_j (18), so the q-columns come from the analytic pieces of
    :func:`_flow_q_jacobian_analytic` plus two small AD passes (a 21-tangent
    forward sweep through the FK-only foot-velocity chain and a 3-tangent
    quaternion-error differential), and the h / v_j / force columns are
    assembled from A_b^{-1}, A_j and the foot Jacobians. "analytic_bf16" runs
    the two sweeps in bfloat16; primals, defects and constraint values stay in
    the working dtype. ``frozen``: the second RK2 stage reuses the first
    stage's Jacobian (the defect stays exact RK2).
    """
    check_linearization(tangents, sensitivity)
    dtype, dev = x.dtype, x.device
    q_bar = x[6:30]
    flags = row.contact_flags
    zref = row.z_vel_ref
    sweep = "bf16" if tangents == "analytic_bf16" else "f32"

    dq_f1, A_cmm, v_bar_frozen, Jall = _flow_q_jacobian_analytic(model, x, u, sweep=sweep)
    f1 = centroidal.flow_map_any(model, x, u)
    g0 = cons.velocity_constraint(model, x, u, flags, zref)
    e = _ee_error(model, ocp, x, row.ee_pos_ref, row.ee_quat_ref)

    # foot-velocity rows: 21-tangent sweep through the FK-only chain
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
    mask = cons.velocity_row_mask(flags)
    Jlin = Jall[:4, :3, :].reshape(12, 24)  # the feet rows of Jall
    dvb_dq = dq_f1[6:12]
    z12_3 = torch.zeros((12, 3), dtype=dtype, device=dev)
    dq_g = mask[:, None] * (torch.cat([z12_3, Jfv_ej], dim=1) + Jlin[:, :6] @ dvb_dq)

    R_ee, _ = kinematics.ee_pose(model, q_bar)
    quat_ref = row.ee_quat_ref
    eye3 = torch.eye(3, dtype=dtype, device=dev)
    D_ori = jacfwd(lambda t: spatial.quat_error_ocs2(
        spatial.rot_to_quat((eye3 + spatial.skew(t)) @ R_ee), quat_ref
    ))(torch.zeros(3, dtype=dtype, device=dev))                      # (3, 3)
    Je_q = torch.cat([Jall[4, :3, :], D_ori @ Jall[4, 3:6, :]], dim=0)  # (6, 24)

    dvb_dh, dvb_dvj = _momentum_velocity_coeffs(model, q_bar, A=A_cmm)
    z6_6 = torch.zeros((6, 6), dtype=dtype, device=dev)
    z18_6 = torch.zeros((18, 6), dtype=dtype, device=dev)
    z6_18 = torch.zeros((6, 18), dtype=dtype, device=dev)
    df1_dh = torch.cat([z6_6, dvb_dh, z18_6], dim=0)                 # (30, 6)
    df1_dvj = torch.cat(
        [z6_18, dvb_dvj, torch.eye(18, dtype=dtype, device=dev)], dim=0)  # (30, 18)

    dg_dh = mask[:, None] * (Jlin[:, :6] @ dvb_dh)                   # (12, 6)
    dg_dvj = mask[:, None] * (Jlin[:, :6] @ dvb_dvj + Jlin[:, 6:])

    df1_dx = torch.cat([df1_dh, dq_f1], dim=1)                       # (30, 30)
    df1_du = torch.cat([_flow_force_cols(model, x), df1_dvj], dim=1)  # (30, 30)
    Gx = torch.cat([dg_dh, dq_g], dim=1)                             # (12, 30)
    Gv = dg_dvj
    Je = torch.cat([z6_6, Je_q], dim=1)

    # frozen sensitivity: the second stage's Jacobian is the first's
    f2 = centroidal.flow_map_any(model, x + dt * f1, u)
    df2_dx2, df2_du = df1_dx, df1_du

    # RK2 (Heun) discrete sensitivities: Phi = x + dt/2 (f1 + f2(x + dt f1, u))
    eye30 = torch.eye(30, dtype=dtype, device=dev)
    A = eye30 + 0.5 * dt * (df1_dx + df2_dx2 @ (eye30 + dt * df1_dx))
    B = 0.5 * dt * (df1_du + df2_du + dt * (df2_dx2 @ df1_du))
    d = x + 0.5 * dt * (f1 + f2) - x_next

    l, lx, lu, lxx, luu, lux = quadratize_stage(model, ocp, row, x, u, ee_lin=(e, Je))
    return A, B, d, dt * l, dt * lx, dt * lu, dt * lxx, dt * luu, dt * lux, g0, Gx, Gv


def linearize_ocp(model: RobotModel, ocp: OcpConfig, stage: StageData, dt, X, U,
                  sensitivity: str = "frozen", tangents: str = "analytic") -> LqProblem:
    """Linearization of dynamics/cost/constraints along X (B, N+1, 30) /
    U (B, N, 30), vmapped over the scenarios and the nodes (stage data
    shared)."""
    check_linearization(tangents, sensitivity)
    if X.dim() != 3:
        raise ValueError(f"X must be (B, N+1, 30), got {tuple(X.shape)}")
    N = U.shape[-2]
    node = vmap(vmap(partial(_node_linearization, model, ocp, dt,
                             sensitivity=sensitivity, tangents=tangents)),
                in_dims=(None, 0, 0, 0))
    term = vmap(partial(quadratize_terminal, model, ocp, stage))
    A, B, d, l, lx, lu, lxx, luu, lux, g0, Gx, Gv = node(
        stage.rows(slice(0, N)), X[:, :-1], U, X[:, 1:])
    lf, lx_f, lxx_f = term(X[:, -1])
    return LqProblem(
        A=A, B=B, d=d, lx=lx, lu=lu, lxx=lxx, luu=luu, lux=lux,
        cost=torch.sum(l, dim=-1) + lf,
        g0=g0, Gx=Gx, Gv=Gv, lx_f=lx_f, lxx_f=lxx_f,
    )


def project_ocp_batched(lq: LqProblem, flags, U, shift=1e-5) -> ProjectedLq:
    """Batch-major Cholesky-projector projection over (B, N, ...) LQ data.

    The single SPD solve runs as ONE (B*N, 12, 12) x 49-RHS call to K1.
    flags (B,N,4); U (B,N,30).
    """
    if U.shape[-1] != NU:
        raise NotImplementedError("only the 30-input problem is ported")
    dtype, dev = lq.g0.dtype, lq.g0.device
    B, N = flags.shape[0], flags.shape[1]
    active = cons.velocity_row_mask(flags)                          # (B,N,12)
    eye12 = torch.eye(NC_ROWS, dtype=dtype, device=dev)
    Gv = lq.Gv
    GvT = Gv.transpose(-1, -2)                                       # (B,N,18,12)
    # M = Gv Gv^T + diag(1 - active): symmetric by construction
    M = fmm(Gv, GvT) + (1.0 - active)[..., :, None] * eye12
    rhs = torch.cat([lq.g0[..., None], lq.Gx, Gv], dim=-1)          # (B,N,12,49)
    W = spd_solve(M.reshape(B * N, NC_ROWS, NC_ROWS).contiguous(),
                  rhs.reshape(B * N, NC_ROWS, -1).contiguous())
    W = W.reshape(B, N, NC_ROWS, -1)

    Minv_g0 = W[..., 0]                                              # (B,N,12)
    Minv_Gx = W[..., 1:1 + NX]                                       # (B,N,12,30)
    pinvT = W[..., 1 + NX:]                                          # (B,N,12,18)

    du_part = -torch.sum(Gv * Minv_g0[..., None], dim=-2)            # (B,N,18)
    Px_v = -fmm(GvT, Minv_Gx)                                        # (B,N,18,30)
    P = torch.eye(NV_JOINTS, dtype=dtype, device=dev) - fmm(GvT, pinvT)

    force_mask = torch.repeat_interleave(flags, 3, dim=-1)           # (B,N,12)
    p = torch.cat([-(1.0 - force_mask) * U[..., 0:12], du_part], dim=-1)
    return _apply_projection_structured(lq, p, P, Px_v, force_mask, shift=shift)


def _apply_projection_structured(lq: LqProblem, p, P, Px_v, fm, shift=1e-5) -> ProjectedLq:
    """Blockwise du = p + Pu u_red + Px dx substitution for the batched path.

    Pu = blkdiag(diag(fm), P) and Px = [0; Px_v]: the force block is an
    elementwise row/column scaling and only the 18-dim joint-velocity block
    carries dense products. p (B,N,30); P (B,N,18,18); Px_v (B,N,18,30);
    fm (B,N,12).
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

    luu_bar = torch.cat([
        torch.cat([FF_bar, Fv_bar], dim=-1),
        torch.cat([Fv_bar.transpose(-1, -2), vv_bar], dim=-1),
    ], dim=-2) + shift * torch.eye(nu, dtype=dtype, device=dev)
    return ProjectedLq(
        A=A_bar, B=torch.cat([B_F * fm_col, fmm(B_v, P)], dim=-1), d=d_bar,
        lx=lx_bar, lu=torch.cat([fm * lu_p[..., 0:12], fmv(PT, lu_p_v)], dim=-1),
        lxx=lxx_bar, luu=luu_bar, lux=torch.cat([lux_F_bar, lux_v_bar], dim=-2),
        lx_f=lq.lx_f, lxx_f=lq.lxx_f,
        p=p, P=P, Px_v=Px_v, force_mask=fm,
    )
