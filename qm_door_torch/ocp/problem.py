"""OCP definition: per-node stage data, cost evaluation and quadratization
(port of qm_door_tpu/ocp/problem.py).

The quadratization is closed-form: constant Q/R, Gauss-Newton for the EE
penalty (OCS2's Linear-order soft constraints), analytic barrier second
derivatives for the friction cone and the arm soft boxes.

Per-node functions take the node's stage row (:class:`StageRow`) instead
of the node index: the rows are gathered before ``torch.func.vmap`` and
vmapped alongside (x, u), so nothing indexes stage arrays with a batched
index. Stage arrays carry the node axis second to last (last for
``times`` and ``grasp_flags``), after an optional scenario axis.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as tnf

from ..models import centroidal, kinematics, spatial
from ..models.autodiff import jacfwd
from ..models.model import RobotModel
from . import collision, penalties
from .gait import GaitSchedule
from .reference import TargetTrajectories
from .swing import SwingConfig, compile_swing_references


@dataclass(frozen=True)
class OcpConfig:
    """Numeric config of the OCP (arrays precomputed at build time)."""

    Q: torch.Tensor            # (30,30)
    R: torch.Tensor            # (30,30) with the base->feet Jacobian mapping
    ee_mu_position: float
    ee_mu_orientation: float
    final_ee_mu_position: float
    final_ee_mu_orientation: float
    friction_coefficient: float
    cone_mu: float
    cone_delta: float
    cone_regularization: float
    limit_pos_mu: float
    limit_pos_delta: float
    limit_vel_mu: float
    limit_vel_delta: float
    arm_pos_lower: torch.Tensor  # (6,)
    arm_pos_upper: torch.Tensor
    arm_vel_lower: torch.Tensor
    arm_vel_upper: torch.Tensor
    # force-tracking only (ocp/force.py): soft box on the EE wrench input
    wrench_lower: Optional[torch.Tensor] = None  # (6,)
    wrench_upper: Optional[torch.Tensor] = None
    wrench_mu: float = 0.1
    wrench_delta: float = 1e-3
    # quad-only variant: arm velocity inputs pinned to zero in the
    # projection (a mask on the 30/30 problem, not a shape change)
    arm_locked: bool = False
    # self-collision soft constraint (ocp/collision.py); off at mu = 0
    self_collision_mu: float = 0.0
    self_collision_delta: float = 0.02
    self_collision_margin: float = 0.05


def make_ocp_config(model: RobotModel, cfg, dtype=None) -> OcpConfig:
    """OcpConfig from a QmConfig on the model's device, including the R
    leg-velocity mapping (QMInterface::initializeInputCostWeight)."""
    dtype = model.dtype if dtype is None else dtype
    dev = model.device
    c = cfg.cost
    r_task = np.concatenate(
        [np.full(12, c.r_forces), np.full(12, c.r_foot_velocity), np.full(6, c.r_arm_velocity)]
    ) * c.r_scaling
    R_task = np.diag(r_task)

    # base->feet Jacobian at the nominal (initial) configuration: rows = foot
    # linear Jacobian leg-joint columns (12x12)
    x0 = torch.as_tensor(cfg.initial_state(), dtype=model.dtype, device=dev)
    J = kinematics.frame_jacobians(model, centroidal.pinocchio_q(x0),
                                   model.contact_frame_ids)          # (4,6,24)
    base2feet = J[:, :3, 6:18].reshape(12, 12).cpu().numpy()
    R = R_task.copy()
    R[12:24, 12:24] = base2feet.T @ R_task[12:24, 12:24] @ base2feet

    jl = cfg.joint_limits
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=dev)  # noqa: E731
    return OcpConfig(
        Q=t(np.diag(c.q_diag)),
        R=t(R),
        ee_mu_position=c.ee_mu_position,
        ee_mu_orientation=c.ee_mu_orientation,
        final_ee_mu_position=c.final_ee_mu_position,
        final_ee_mu_orientation=c.final_ee_mu_orientation,
        friction_coefficient=cfg.friction.friction_coefficient,
        cone_mu=cfg.friction.barrier_mu,
        cone_delta=cfg.friction.barrier_delta,
        cone_regularization=cfg.friction.cone_regularization,
        limit_pos_mu=jl.position_mu,
        limit_pos_delta=jl.position_delta,
        limit_vel_mu=jl.velocity_mu,
        limit_vel_delta=jl.velocity_delta,
        arm_pos_lower=model.pos_lower[12:18].to(dtype),
        arm_pos_upper=model.pos_upper[12:18].to(dtype),
        arm_vel_lower=t(jl.arm_velocity_lower),
        arm_vel_upper=t(jl.arm_velocity_upper),
        arm_locked=cfg.model.arm_locked,
        self_collision_mu=cfg.self_collision.mu,
        self_collision_delta=cfg.self_collision.delta,
        self_collision_margin=cfg.self_collision.margin,
    )


class StageRow(NamedTuple):
    """The stage data one node's cost and constraints read (leading dims
    are the scenarios and nodes selected)."""

    contact_flags: torch.Tensor  # (..., 4)
    x_nom: torch.Tensor          # (..., 30)
    u_nom: torch.Tensor          # (..., 30)
    ee_pos_ref: torch.Tensor     # (..., 3)
    ee_quat_ref: torch.Tensor    # (..., 4)
    z_vel_ref: torch.Tensor      # (..., 4)


@dataclass(frozen=True)
class StageData:
    """Per-solve reference arrays over the N+1 node grid (all fixed-shape),
    shared by every scenario or with a leading scenario axis (B, N+1, ...).

    ``grasp_flags`` exists only on the force-tracking problem (u_nom widens
    to 36 there, see ocp/force.py): it gates the EE-wrench input as
    contact_flags gate the foot forces; the wrench reference lives in
    u_nom[..., 30:36].
    """

    times: torch.Tensor          # (N+1,)
    contact_flags: torch.Tensor  # (N+1, 4)
    x_nom: torch.Tensor          # (N+1, 30) desired state (tracking cost)
    u_nom: torch.Tensor          # (N+1, nu) weight-compensating input
    ee_pos_ref: torch.Tensor     # (N+1, 3)
    ee_quat_ref: torch.Tensor    # (N+1, 4) xyzw
    z_vel_ref: torch.Tensor      # (N+1, 4) swing normal-velocity reference
    z_pos_ref: torch.Tensor      # (N+1, 4)
    grasp_flags: Optional[torch.Tensor] = None  # (N+1,) 1 = EE wrench active

    def rows(self, index) -> StageRow:
        """The stage rows at node ``index`` (an int, a slice or an index
        tensor), on the node axis whether or not a scenario axis leads."""
        return StageRow(*(a[..., index, :] for a in (
            self.contact_flags, self.x_nom, self.u_nom, self.ee_pos_ref, self.ee_quat_ref,
            self.z_vel_ref)))


def build_stage_data(
    model: RobotModel,
    cfg,
    schedule: GaitSchedule,
    targets: TargetTrajectories,
    t0: float,
    horizon: Optional[float] = None,
    dt: Optional[float] = None,
    dtype=None,
    phase_heights=None,
) -> StageData:
    """Compile gait + targets into the solver's per-node arrays, on the
    targets' device. Gait timeline and swing references are host-side
    numpy; target interpolation runs on tensors."""
    horizon = cfg.mpc.time_horizon if horizon is None else horizon
    dt = cfg.sqp.dt if dt is None else dt
    dtype = model.dtype if dtype is None else dtype
    dev = targets.times.device
    timeline = schedule.compile_timeline(t0, horizon, dt)
    sw = cfg.swing
    swing_cfg = SwingConfig(
        lift_off_velocity=sw.lift_off_velocity,
        touch_down_velocity=sw.touch_down_velocity,
        swing_height=sw.swing_height,
        touchdown_after_horizon=sw.touchdown_after_horizon,
        swing_time_scale=sw.swing_time_scale,
    )
    z_pos, z_vel = compile_swing_references(
        schedule, timeline.times, swing_cfg, phase_heights=phase_heights)

    t = lambda a: torch.as_tensor(a, dtype=dtype, device=dev)  # noqa: E731
    times = t(timeline.times)
    flags = t(timeline.contact_flags)
    desired = targets.desired_state(times)                # (N+1, 37)
    ee_pos, ee_quat = targets.ee_pose(times)
    return StageData(
        times=times,
        contact_flags=flags,
        x_nom=desired[:, :30],
        u_nom=centroidal.weight_compensating_input(model, flags, dtype=dtype),
        ee_pos_ref=ee_pos,
        ee_quat_ref=ee_quat,
        z_vel_ref=t(z_vel),
        z_pos_ref=t(z_pos),
    )


# ---------------------------------------------------------------------------
# cost evaluation (one node; vmap over nodes)
# ---------------------------------------------------------------------------

def _ee_error(model: RobotModel, ocp: OcpConfig, x, ee_pos_ref, ee_quat_ref):
    """6-dim EE pose error [position; ocs2 quaternion error]
    (EndEffectorConstraint::getValue)."""
    R, p = kinematics.ee_pose(model, centroidal.pinocchio_q(x))
    quat = spatial.rot_to_quat(R)
    return torch.cat([p - ee_pos_ref, spatial.quat_error_ocs2(quat, ee_quat_ref)], dim=-1)


def _cone_h(ocp: OcpConfig, F):
    """Friction-cone margin h = mu Fz - sqrt(Fx^2 + Fy^2 + reg) per foot (4,)."""
    s = torch.sqrt(F[..., 0] ** 2 + F[..., 1] ** 2 + ocp.cone_regularization)
    return ocp.friction_coefficient * F[..., 2] - s


def _tracking_cost(ocp: OcpConfig, dx, du):
    return (0.5 * torch.sum(dx * spatial.fmv(ocp.Q, dx), dim=-1)
            + 0.5 * torch.sum(du * spatial.fmv(ocp.R, du), dim=-1))


def _has_wrench_box(ocp: OcpConfig, u) -> bool:
    return u.shape[-1] == 36 and ocp.wrench_lower is not None


def _soft_limits_cost(ocp: OcpConfig, x, u):
    pos = penalties.box_barrier(
        x[..., 24:30], ocp.arm_pos_lower, ocp.arm_pos_upper,
        ocp.limit_pos_mu, ocp.limit_pos_delta)
    vel = penalties.box_barrier(
        u[..., 24:30], ocp.arm_vel_lower, ocp.arm_vel_upper,
        ocp.limit_vel_mu, ocp.limit_vel_delta)
    c = torch.sum(pos, dim=-1) + torch.sum(vel, dim=-1)
    if _has_wrench_box(ocp, u):
        c = c + torch.sum(penalties.box_barrier(
            u[..., 30:36], ocp.wrench_lower, ocp.wrench_upper, ocp.wrench_mu,
            ocp.wrench_delta), dim=-1)
    return c


def _cone_cost(ocp: OcpConfig, u, contact_flags):
    h = _cone_h(ocp, centroidal.contact_forces(u))
    p = penalties.relaxed_barrier(h, ocp.cone_mu, ocp.cone_delta)
    return torch.sum(contact_flags * p, dim=-1)


def _ee_weights(ocp: OcpConfig, final: bool, like):
    mu_p = ocp.final_ee_mu_position if final else ocp.ee_mu_position
    mu_o = ocp.final_ee_mu_orientation if final else ocp.ee_mu_orientation
    w = torch.empty(6, dtype=like.dtype, device=like.device)
    w[:3] = mu_p
    w[3:] = mu_o
    return w


def ee_stage_cost(model, ocp: OcpConfig, x, ee_pos_ref, ee_quat_ref, final=False):
    e = _ee_error(model, ocp, x, ee_pos_ref, ee_quat_ref)
    return 0.5 * torch.sum(_ee_weights(ocp, final, x) * e * e, dim=-1)


def stage_cost(model: RobotModel, ocp: OcpConfig, row: StageRow, x, u):
    """Scalar stage cost L(t_k, x, u) (un-scaled by dt)."""
    c = _tracking_cost(ocp, x - row.x_nom, u - row.u_nom)
    c = c + ee_stage_cost(model, ocp, x, row.ee_pos_ref, row.ee_quat_ref)
    c = c + _cone_cost(ocp, u, row.contact_flags)
    c = c + _soft_limits_cost(ocp, x, u)
    if ocp.self_collision_mu > 0.0:
        c = c + collision.self_collision_cost(model, ocp, x)
    return c


def terminal_cost(model: RobotModel, ocp: OcpConfig, stage: StageData, x):
    """Final-node cost: EE pose penalty only (no terminal Q)."""
    return ee_stage_cost(model, ocp, x, stage.ee_pos_ref[..., -1, :],
                         stage.ee_quat_ref[..., -1, :], final=True)


# ---------------------------------------------------------------------------
# closed-form quadratization (one node; vmap over nodes)
# ---------------------------------------------------------------------------

def _cone_derivs(ocp: OcpConfig, F):
    """Per-foot cone h gradient (4,3) and Hessian (4,3,3) w.r.t. F."""
    fx, fy = F[..., 0], F[..., 1]
    s = torch.sqrt(fx * fx + fy * fy + ocp.cone_regularization)
    dh = torch.stack([-fx / s, -fy / s, torch.full_like(fx, ocp.friction_coefficient)], dim=-1)
    s3 = s * s * s
    hxx = -(s * s - fx * fx) / s3
    hyy = -(s * s - fy * fy) / s3
    hxy = fx * fy / s3
    zero = torch.zeros_like(fx)
    H = torch.stack([
        torch.stack([hxx, hxy, zero], dim=-1),
        torch.stack([hxy, hyy, zero], dim=-1),
        torch.stack([zero, zero, zero], dim=-1),
    ], dim=-2)
    return dh, H


def _block_diag4(HF):
    """(4,3,3) foot blocks -> (12,12) block diagonal."""
    eye4 = torch.eye(4, dtype=HF.dtype, device=HF.device)
    return (eye4[:, None, :, None] * HF[:, :, None, :]).reshape(12, 12)


def quadratize_stage(model: RobotModel, ocp: OcpConfig, row: StageRow, x, u,
                     ee_lin=None):
    """(l, lx, lu, lxx, luu, lux) of the stage cost at one node (x, u).

    Exact for the quadratic tracking term and the barrier terms;
    Gauss-Newton for the EE penalty. ``ee_lin``: optional precomputed
    (e, Je) from the linearization.
    """
    nu = u.shape[-1]  # 30 nominal, 36 force-tracking (EE wrench appended)
    dx = x - row.x_nom
    du = u - row.u_nom

    l = _tracking_cost(ocp, dx, du)
    lx = spatial.fmv(ocp.Q, dx)
    lu = spatial.fmv(ocp.R, du)
    lxx = ocp.Q
    luu = ocp.R
    lux = torch.zeros((nu, 30), dtype=x.dtype, device=x.device)

    # EE penalty (Gauss-Newton on the 6-dim error)
    if ee_lin is None:
        def err_fn(x_):
            return _ee_error(model, ocp, x_, row.ee_pos_ref, row.ee_quat_ref)

        e = err_fn(x)
        Je = jacfwd(err_fn)(x)  # (6,30)
    else:
        e, Je = ee_lin
    w = _ee_weights(ocp, False, x)
    l = l + 0.5 * torch.sum(w * e * e)
    lx = lx + spatial.fmv(Je.mT, w * e)
    lxx = lxx + spatial.fmm(Je.mT, w[:, None] * Je)

    # friction cone barrier (exact)
    flags = row.contact_flags
    F = centroidal.contact_forces(u)
    h = _cone_h(ocp, F)
    p = penalties.relaxed_barrier(h, ocp.cone_mu, ocp.cone_delta)
    dp = penalties.relaxed_barrier_d(h, ocp.cone_mu, ocp.cone_delta)
    ddp = penalties.relaxed_barrier_dd(h, ocp.cone_mu, ocp.cone_delta)
    dh, Hh = _cone_derivs(ocp, F)
    l = l + torch.sum(flags * p)
    gF = flags[:, None] * dp[:, None] * dh  # (4,3)
    HF = flags[:, None, None] * (
        ddp[:, None, None] * dh[:, :, None] * dh[:, None, :] + dp[:, None, None] * Hh
    )  # (4,3,3)
    lu = lu + tnf.pad(gF.reshape(12), (0, nu - 12))
    luu = luu + tnf.pad(_block_diag4(HF), (0, nu - 12, 0, nu - 12))

    # soft box limits (exact, diagonal)
    arm_q = x[24:30]
    arm_v = u[24:30]
    l = l + _soft_limits_cost(ocp, x, u)
    lx = lx + tnf.pad(penalties.box_barrier_d(
        arm_q, ocp.arm_pos_lower, ocp.arm_pos_upper, ocp.limit_pos_mu, ocp.limit_pos_delta), (24, 0))
    lu = lu + tnf.pad(penalties.box_barrier_d(
        arm_v, ocp.arm_vel_lower, ocp.arm_vel_upper, ocp.limit_vel_mu, ocp.limit_vel_delta),
        (24, nu - 30))
    dxx = penalties.box_barrier_dd(
        arm_q, ocp.arm_pos_lower, ocp.arm_pos_upper, ocp.limit_pos_mu, ocp.limit_pos_delta)
    duu = penalties.box_barrier_dd(
        arm_v, ocp.arm_vel_lower, ocp.arm_vel_upper, ocp.limit_vel_mu, ocp.limit_vel_delta)
    lxx = lxx + torch.diag_embed(tnf.pad(dxx, (24, 0)))
    luu = luu + torch.diag_embed(tnf.pad(duu, (24, nu - 30)))

    # EE wrench soft box (force tracking only; its value is in
    # _soft_limits_cost already)
    if _has_wrench_box(ocp, u):
        w_ = u[30:36]
        args = (ocp.wrench_lower, ocp.wrench_upper, ocp.wrench_mu, ocp.wrench_delta)
        lu = lu + tnf.pad(penalties.box_barrier_d(w_, *args), (30, 0))
        luu = luu + torch.diag_embed(tnf.pad(penalties.box_barrier_dd(w_, *args), (30, 0)))

    if ocp.self_collision_mu > 0.0:
        lc, lcx, lcxx = collision.quadratize_self_collision(model, ocp, x)
        l = l + lc
        lx = lx + lcx
        lxx = lxx + lcxx
    return l, lx, lu, lxx, luu, lux


def quadratize_terminal(model: RobotModel, ocp: OcpConfig, stage: StageData, x):
    """(l, lx, lxx) of the terminal EE cost (Gauss-Newton) at one state."""
    return quadratize_terminal_ref(model, ocp, stage.ee_pos_ref[-1], stage.ee_quat_ref[-1], x)


def quadratize_terminal_ref(model: RobotModel, ocp: OcpConfig, ee_pos_ref, ee_quat_ref, x):
    """:func:`quadratize_terminal` from the final node's EE references (the
    form ``torch.func.vmap`` maps over scenarios with their own stage data)."""
    def err_fn(x_):
        return _ee_error(model, ocp, x_, ee_pos_ref, ee_quat_ref)

    e = err_fn(x)
    Je = jacfwd(err_fn)(x)
    w = _ee_weights(ocp, True, x)
    l = 0.5 * torch.sum(w * e * e)
    lx = spatial.fmv(Je.mT, w * e)
    lxx = spatial.fmm(Je.mT, w[:, None] * Je)
    return l, lx, lxx
