"""Self-collision soft constraint (port of qm_door_tpu/ocp/collision.py;
the ocs2_self_collision role).

The reference declares a PinocchioGeometryInterface for self-collision
(QMInterface.h:19,50,89) but never instantiates the constraint; as in the
JAX package it is OFF by default (cfg.self_collision.mu = 0).

Geometry: spheres attached to the kinematic tree, pairs = the arm's distal
spheres against the legs. Penalty: a relaxed barrier on h = dist(pair) -
(r_i + r_j + margin), quadratized Gauss-Newton (exact gradient, J^T p'' J
Hessian), as the EE soft constraint.

Functions take q / x with any leading batch dims, or run under
``torch.func.vmap`` (the linearization maps ``quadratize_self_collision``
over scenarios and nodes; its Jacobian is ``torch.func.jacfwd``, through
``models/autodiff.py``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as tnf

from ..models import kinematics
from ..models.autodiff import jacfwd
from ..models.model import RobotModel
from . import penalties

# sphere attachments: (kind, index, radius)
#   kind "body" = body origin (1..18 joint child bodies), "foot" = contact
#   frame, "ee" = end-effector frame
# arm distal spheres: elbow-forward link (body 15), wrist (body 17), gripper
ARM_SPHERES = (("body", 15, 0.05), ("body", 17, 0.05), ("ee", 0, 0.06))
# leg spheres: calves (KFE child bodies 3/6/9/12) and feet
LEG_SPHERES = (("body", 3, 0.045), ("body", 6, 0.045), ("body", 9, 0.045),
               ("body", 12, 0.045),
               ("foot", 0, 0.02), ("foot", 1, 0.02), ("foot", 2, 0.02),
               ("foot", 3, 0.02))


def _sphere_positions(model: RobotModel, q):
    """Stacked world positions (..., 11, 3) of ARM_SPHERES + LEG_SPHERES."""
    _, p_bodies = kinematics.fk(model, q)
    p_feet = kinematics.contact_positions(model, q)
    _, p_ee = kinematics.ee_pose(model, q)

    def pos(kind, idx):
        if kind == "body":
            return p_bodies[..., idx, :]
        if kind == "foot":
            return p_feet[..., idx, :]
        return p_ee

    return torch.stack([pos(k, i) for (k, i, _) in ARM_SPHERES + LEG_SPHERES], dim=-2)


def pair_clearances(model: RobotModel, q, margin: float = 0.0):
    """(..., n_arm * n_leg) signed clearances h = dist - r_sum - margin."""
    pts = _sphere_positions(model, q)
    na = len(ARM_SPHERES)
    arm, leg = pts[..., :na, :], pts[..., na:, :]
    r_arm = torch.tensor([r for (_, _, r) in ARM_SPHERES], dtype=q.dtype, device=q.device)
    r_leg = torch.tensor([r for (_, _, r) in LEG_SPHERES], dtype=q.dtype, device=q.device)
    d = torch.linalg.vector_norm(arm[..., :, None, :] - leg[..., None, :, :] + 1e-12, dim=-1)
    h = d - (r_arm[:, None] + r_leg[None, :]) - margin
    return h.reshape(*h.shape[:-2], -1)


def self_collision_cost(model: RobotModel, ocp, x):
    """Stage-cost contribution (...,): the relaxed barriers summed over the
    pairs."""
    h = pair_clearances(model, x[..., 6:30], ocp.self_collision_margin)
    return torch.sum(penalties.relaxed_barrier(h, ocp.self_collision_mu,
                                               ocp.self_collision_delta), dim=-1)


def quadratize_self_collision(model: RobotModel, ocp, x):
    """(l, lx (30,), lxx (30, 30)) of one state's cost, Gauss-Newton (the
    ocs2 Linear-order soft-constraint convention: exact gradient, J^T p'' J
    Hessian, no second kinematic derivatives)."""
    q = x[6:30]
    mu, delta = ocp.self_collision_mu, ocp.self_collision_delta

    def h_fn(qq):
        return pair_clearances(model, qq, ocp.self_collision_margin)

    h = h_fn(q)
    J = jacfwd(h_fn)(q)                            # (P, 24)
    p = torch.sum(penalties.relaxed_barrier(h, mu, delta))
    pd = penalties.relaxed_barrier_d(h, mu, delta)
    pdd = penalties.relaxed_barrier_dd(h, mu, delta)

    g_q = J.mT @ pd                                # (24,)
    H_q = (J.mT * pdd[None, :]) @ J                # (24, 24) GN
    return p, tnf.pad(g_q, (6, 0)), tnf.pad(H_q, (6, 0, 6, 0))
