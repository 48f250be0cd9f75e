"""Hard (projected) state-input equality constraints of the OCP (port of
qm_door_tpu/ocp/constraints.py).

Per node: zero contact force for swing feet (eliminated analytically by the
solver), zero foot velocity for stance feet, swing-foot normal velocity
tracking. Fixed shapes with masks: the velocity rows are a masked 12-row
constraint
  g(x, u) = M .* (v_feet(x, u) - b_ref)         (M from contact flags)
with per-foot rows (x, y, z); stance feet activate all 3 rows with b=0,
swing feet only the z row with b = swing z-velocity reference.
"""
from __future__ import annotations

import torch

from ..models import centroidal, kinematics, spatial
from ..models.autodiff import jacfwd
from ..models.model import RobotModel


def velocity_row_mask(contact_flags):
    """(..., 12) row mask: stance -> (1,1,1), swing -> (0,0,1)."""
    f = contact_flags
    mask = torch.stack([f, f, torch.ones_like(f)], dim=-1)  # (...,4,3)
    return mask.reshape(*f.shape[:-1], 12)


def velocity_rhs(contact_flags, z_vel_ref):
    """(..., 12) right-hand side b: 0 for stance rows, swing z-vel ref on z rows."""
    f = contact_flags
    zeros = torch.zeros_like(f)
    b = torch.stack([zeros, zeros, (1.0 - f) * z_vel_ref], dim=-1)
    return b.reshape(*f.shape[:-1], 12)


def foot_velocities(model: RobotModel, x, u):
    """(..., 12) stacked foot linear velocities in contact order."""
    q = centroidal.pinocchio_q(x)
    v = centroidal.pinocchio_v(model, x, u)
    J = kinematics.frame_jacobians(model, q, model.contact_frame_ids)  # (...,4,6,24)
    return spatial.fmv(J[..., :3, :], v[..., None, :]).reshape(*x.shape[:-1], 12)


def velocity_constraint(model: RobotModel, x, u, contact_flags, z_vel_ref):
    """Masked 12-row equality g(x,u) = 0."""
    mask = velocity_row_mask(contact_flags)
    b = velocity_rhs(contact_flags, z_vel_ref)
    return mask * (foot_velocities(model, x, u) - b)


def velocity_constraint_linearization(model: RobotModel, x, u, contact_flags, z_vel_ref):
    """(g, Gx, Gv) at one node, Gv the Jacobian w.r.t. the joint-velocity
    block u[12:30] (the force block never enters foot velocities)."""
    def fun(x_, u_):
        return velocity_constraint(model, x_, u_, contact_flags, z_vel_ref)

    g = fun(x, u)
    Gx, Gu = jacfwd(fun, argnums=(0, 1))(x, u)
    return g, Gx, Gu[:, 12:30]
