"""Rigid-body dynamics quantities (port of qm_door_tpu/models/dynamics.py).

- Mass matrix from the kinetic-energy identity
      M(q) = sum_i [ m_i Jc_i^T Jc_i + Jw_i^T I_i^w Jw_i ]
  over all 19 lumped bodies (world-aligned com-point Jacobians).
- Nonlinear effects from the Lagrangian identity
      h(q, v) = Mdot v - d/dq (1/2 v^T M v) + g(q),
  with ``torch.func.jvp`` for Mdot and a vjp for the gradients.
- Centroidal momentum matrix (CMM) about the robot com, world axes
  (Orin/Wensing construction, assembled from subtree aggregates):
      A_lin = sum_i m_i Jc_i,
      A_ang = sum_i [ I_i^w Jw_i + m_i skew(c_i - c) Jc_i ];
  Adot via ``torch.func.jvp``.

Functions take q (and v) with any leading batch dims; a gradient is taken
per sample (the samples are independent, so the vjp of the per-sample
values with a cotangent of ones is each sample's gradient).
"""
from __future__ import annotations

import numpy as np
import torch

from . import autodiff, spatial
from .kinematics import fk, joint_world_axes, point_jacobian
from .model import GRAVITY, RobotModel


def body_com_kinematics(model: RobotModel, q):
    """World com positions (...,19,3), world inertias about com (...,19,3,3),
    and com-point Jacobians (...,19,6,24)."""
    axes, origins, (R, p) = joint_world_axes(model, q)
    coms = spatial.fmv(R, model.body_com) + p
    Iw = spatial.fmm(spatial.fmm(R, model.body_inertia), R.transpose(-1, -2))
    Js = [point_jacobian(model, q, b, coms[..., b, :], (axes, origins))
          for b in range(model.nj + 1)]
    return coms, Iw, torch.stack(Js, dim=-3)


def _grad(fn, q):
    """d fn / d q for each sample of a batch of per-sample scalars fn(q) (...)."""
    with autodiff.LOCK:
        out, vjp = torch.func.vjp(fn, q)
        return vjp(torch.ones_like(out))[0]


def mass_matrix(model: RobotModel, q):
    """(...,24,24) joint-space mass matrix (crba equivalent, exact)."""
    _, Iw, J = body_com_kinematics(model, q)
    Jlin, Jang = J[..., :3, :], J[..., 3:, :]
    m = model.body_mass[:, None, None]
    M = torch.einsum("...bki,...bkj->...ij", Jlin * m, Jlin) + torch.einsum(
        "...bki,...bkl,...blj->...ij", Jang, Iw, Jang)
    return 0.5 * (M + M.transpose(-1, -2))


def potential_energy(model: RobotModel, q):
    R, p = fk(model, q)
    coms = spatial.fmv(R, model.body_com) + p
    return GRAVITY * torch.sum(model.body_mass * coms[..., 2], dim=-1)


def gravity_vector(model: RobotModel, q):
    return _grad(lambda qq: potential_energy(model, qq), q)


def kinetic_energy(model: RobotModel, q, v):
    return 0.5 * torch.sum(v * spatial.fmv(mass_matrix(model, q), v), dim=-1)


def nonlinear_effects(model: RobotModel, q, v):
    """h(q,v) = C(q,v)v + g(q)  (pinocchio nonLinearEffects equivalent)."""
    _, Mdot = autodiff.jvp(lambda qq: mass_matrix(model, qq), (q,), (v,))
    kinetic_grad = _grad(lambda qq: kinetic_energy(model, qq, v), q)
    return spatial.fmv(Mdot, v) - kinetic_grad + gravity_vector(model, q)


def inverse_dynamics(model: RobotModel, q, v, a):
    """tau = M(q) a + h(q, v): generalized forces for a given acceleration."""
    return spatial.fmv(mass_matrix(model, q), a) + nonlinear_effects(model, q, v)


def forward_dynamics(model: RobotModel, q, v, tau_gen):
    """a = M^{-1}(tau_gen - h): unconstrained forward dynamics; ``tau_gen`` is
    the full 24-dim generalized force (contact forces already mapped through
    J^T by the caller). ``solve_ex``: no host read of the factorization's
    status (a singular M gives non-finite a, as jnp.linalg.solve does)."""
    M = mass_matrix(model, q)
    h = nonlinear_effects(model, q, v)
    return torch.linalg.solve_ex(M, (tau_gen - h)[..., None])[0][..., 0]


def com_position(model: RobotModel, q):
    R, p = fk(model, q)
    coms = spatial.fmv(R, model.body_com) + p
    m = model.body_mass
    return torch.sum(m[:, None] * coms, dim=-2) / torch.sum(m)


def _subtree_table(joint_parent) -> np.ndarray:
    """(nj, nb) static 0/1 table: body b is in the subtree of joint j."""
    nj = len(joint_parent)
    table = np.zeros((nj, nj + 1), dtype=bool)
    for i in range(nj):
        j = i
        while True:
            table[j, 1 + i] = True
            parent_body = joint_parent[j]
            if parent_body == 0:
                break
            j = parent_body - 1
    return table


def _reverse_topological(joint_parent) -> tuple:
    """Body indices 1..nb-1 ordered leaves-first (child before parent).

    URDF joint order places parent_body < child_body, so descending index is
    a valid reverse-topological order; the invariant is checked."""
    nj = len(joint_parent)
    for i in range(nj):
        if joint_parent[i] >= 1 + i:
            raise ValueError("joint order must place parents first")
    return tuple(range(nj, 0, -1))


def centroidal_momentum_matrix(model: RobotModel, q):
    """(...,6,24) CMM A(q): h = A v, h = [linear momentum; angular momentum
    about the com], world axes (pinocchio ccrba equivalent)."""
    axes, origins, (R, p) = joint_world_axes(model, q)
    return cmm_from_fk(model, q, axes, origins, R, p)


def cmm_from_fk(model: RobotModel, q, axes, origins, R, p):
    """CMM assembly from precomputed FK."""
    m = model.body_mass
    coms = spatial.fmv(R, model.body_com) + p                       # (...,19,3)
    Iw = spatial.fmm(spatial.fmm(R, model.body_inertia), R.transpose(-1, -2))
    eye = torch.eye(3, dtype=q.dtype, device=q.device)
    # per-body inertia about the world origin
    cc = torch.sum(coms * coms, dim=-1)
    I_origin = Iw + m[:, None, None] * (
        cc[..., None, None] * eye - coms[..., :, None] * coms[..., None, :])
    s_body = m[:, None] * coms                                      # (...,19,3)

    # subtree aggregates by suffix accumulation along the tree (leaves first)
    parents = tuple(model.joint_parent)
    nj = len(parents)
    sub_m = [m[b] for b in range(nj + 1)]
    sub_s = [s_body[..., b, :] for b in range(nj + 1)]
    sub_J = [I_origin[..., b, :, :] for b in range(nj + 1)]
    for b in _reverse_topological(parents):
        pb = parents[b - 1]  # parent body of body b
        if pb != 0:          # joint aggregates never need the base body's row
            sub_m[pb] = sub_m[pb] + sub_m[b]
            sub_s[pb] = sub_s[pb] + sub_s[b]
            sub_J[pb] = sub_J[pb] + sub_J[b]
    M_sub = torch.stack([sub_m[1 + j] for j in range(nj)])           # (18,)
    s_sub = torch.stack([sub_s[1 + j] for j in range(nj)], dim=-2)   # (...,18,3)
    J_sub = torch.stack([sub_J[1 + j] for j in range(nj)], dim=-3)   # (...,18,3,3)

    # joint columns about the origin
    lever = s_sub - M_sub[:, None] * origins
    P_cols = spatial.cross(axes, lever)                 # (...,18,3)
    so = torch.sum(s_sub * origins, dim=-1)
    L_cols = (
        spatial.fmv(J_sub, axes)
        - so[..., None] * axes
        + origins * torch.sum(s_sub * axes, dim=-1)[..., None]
    )

    # base columns: translation then euler-rate rotation about base origin
    M_tot = torch.sum(m)
    s_tot = torch.sum(s_body, dim=-2)
    J_tot = torch.sum(I_origin, dim=-3)
    ET = spatial.zyx_rates_to_world_angvel_matrix(q[..., 3:6]).transpose(-1, -2)
    base_p = q[..., 0:3]
    P_rot = spatial.cross(
        ET, (s_tot - M_tot * base_p)[..., None, :])           # rows per col
    so_b = torch.sum(s_tot * base_p, dim=-1)
    L_rot = (
        spatial.fmm(ET, J_tot.transpose(-1, -2))
        - so_b[..., None, None] * ET
        + base_p[..., None, :] * spatial.fmv(ET, s_tot)[..., :, None]
    )

    P = torch.cat([(M_tot * eye).expand_as(P_rot), P_rot.transpose(-1, -2),
                   P_cols.transpose(-1, -2)], dim=-1)                 # (...,3,24)
    L_O = torch.cat([spatial.skew(s_tot), L_rot.transpose(-1, -2),
                     L_cols.transpose(-1, -2)], dim=-1)
    # shift the momentum reference from the world origin to the com
    com = s_tot / M_tot
    L = L_O - spatial.fmm(spatial.skew(com), P)
    return torch.cat([P, L], dim=-2)


def centroidal_momentum_matrix_dot(model: RobotModel, q, v):
    """dA/dt along qdot = v (pinocchio dccrba equivalent)."""
    _, Adot = autodiff.jvp(lambda qq: centroidal_momentum_matrix(model, qq), (q,), (v,))
    return Adot


def centroidal_momentum(model: RobotModel, q, v):
    return spatial.fmv(centroidal_momentum_matrix(model, q), v)
