"""Forward kinematics and frame Jacobians (port of
qm_door_tpu/models/kinematics.py).

Functions take q with any leading batch dims (or run under
``torch.func.vmap``). All Jacobians are LOCAL_WORLD_ALIGNED: rows
[linear(3); angular(3)], world axes, taken at the frame origin; columns in
the generalized-velocity chart of models/model.py.
"""
from __future__ import annotations

import numpy as np
import torch

from . import spatial
from .model import RobotModel


def _axis_rot(axis, angle):
    """Rodrigues rotation about a (constant) unit axis."""
    K = spatial.skew(axis)
    s = torch.sin(angle)[..., None, None]
    c = torch.cos(angle)[..., None, None]
    eye = torch.eye(3, dtype=angle.dtype, device=angle.device)
    return eye + s * K + (1.0 - c) * spatial.fmm(K, K)


def fk(model: RobotModel, q):
    """Body poses in world frame: (R (...,19,3,3), p (...,19,3)).

    Body 0 is the floating base; body 1+i is the child body of joint i.
    """
    Rs = [spatial.zyx_to_rot(q[..., 3:6])]
    ps = [q[..., 0:3]]
    for i in range(model.nj):
        par = model.joint_parent[i]
        Rp, pp = Rs[par], ps[par]
        Rj = spatial.fmm(Rp, model.joint_rot[i])
        ps.append(spatial.fmv(Rp, model.joint_trans[i]) + pp)
        Rs.append(spatial.fmm(Rj, _axis_rot(model.joint_axis[i], q[..., 6 + i])))
    return torch.stack(Rs, dim=-3), torch.stack(ps, dim=-2)


def joint_world_axes(model: RobotModel, q):
    """World-frame joint axes and joint-origin positions, (...,18,3) each,
    plus the FK output they were built from."""
    R, p = fk(model, q)
    axes, origins = [], []
    for i in range(model.nj):
        par = model.joint_parent[i]
        Rp = R[..., par, :, :]
        axes.append(spatial.fmv(Rp, model.joint_rot[i] @ model.joint_axis[i]))
        origins.append(spatial.fmv(Rp, model.joint_trans[i]) + p[..., par, :])
    return torch.stack(axes, dim=-2), torch.stack(origins, dim=-2), (R, p)


def _ancestor_mask(joint_parent) -> np.ndarray:
    """(n_bodies, nj) static 0/1 table: joint j moves body b (body 1+i is
    moved by joint i and every ancestor joint of i)."""
    nj = len(joint_parent)
    mask = np.zeros((nj + 1, nj), dtype=bool)
    for i in range(nj):
        j = i
        while True:
            mask[1 + i, j] = True
            parent_body = joint_parent[j]
            if parent_body == 0:
                break
            j = parent_body - 1
    return mask


def point_jacobian(model: RobotModel, q, body_idx, point_w, axes_origins=None):
    """(...,6,24) LWA Jacobian of a world point attached to a body."""
    if axes_origins is None:
        axes, origins, _ = joint_world_axes(model, q)
    else:
        axes, origins = axes_origins
    E = spatial.zyx_rates_to_world_angvel_matrix(q[..., 3:6])
    r = point_w - q[..., 0:3]
    zeros33 = torch.zeros_like(E)
    Jlin = [torch.eye(3, dtype=q.dtype, device=q.device).expand_as(E),
            -spatial.fmm(spatial.skew(r), E)]
    Jang = [zeros33, E]
    # static sparsity: only ancestor joints contribute
    mask = _ancestor_mask(model.joint_parent)[body_idx]
    zero3 = torch.zeros_like(point_w)
    cols_lin, cols_ang = [], []
    for i in range(model.nj):
        if mask[i]:
            a = axes[..., i, :]
            cols_ang.append(a)
            cols_lin.append(spatial.cross(a, point_w - origins[..., i, :]))
        else:
            cols_ang.append(zero3)
            cols_lin.append(zero3)
    Jlin.append(torch.stack(cols_lin, dim=-1))
    Jang.append(torch.stack(cols_ang, dim=-1))
    return torch.cat([torch.cat(Jlin, dim=-1), torch.cat(Jang, dim=-1)], dim=-2)


def frame_placements(model: RobotModel, q, fk_out=None):
    """World poses of all exported frames: (...,F,3,3), (...,F,3)."""
    R, p = fk(model, q) if fk_out is None else fk_out
    Rf, pf = [], []
    for f in range(len(model.frame_names)):
        par = model.frame_parent[f]
        Rp = R[..., par, :, :]
        Rf.append(spatial.fmm(Rp, model.frame_rot[f]))
        pf.append(spatial.fmv(Rp, model.frame_trans[f]) + p[..., par, :])
    return torch.stack(Rf, dim=-3), torch.stack(pf, dim=-2)


def frame_jacobians(model: RobotModel, q, frame_ids=None):
    """Stacked (...,F,6,24) LWA Jacobians for the requested frames (default:
    all), rows [linear; angular]."""
    if frame_ids is None:
        frame_ids = tuple(range(len(model.frame_names)))
    axes, origins, fk_out = joint_world_axes(model, q)
    _, pf = frame_placements(model, q, fk_out)
    return torch.stack([
        point_jacobian(model, q, model.frame_parent[f], pf[..., f, :], (axes, origins))
        for f in frame_ids
    ], dim=-3)


def frame_jacobians_dot(model: RobotModel, q, v, frame_ids=None):
    """dJ/dt for the requested frames: the jvp of :func:`frame_jacobians`
    along qdot = v (in this chart qdot == v)."""
    _, Jdot = torch.func.jvp(lambda qq: frame_jacobians(model, qq, frame_ids), (q,), (v,))
    return Jdot


def frame_velocities(model: RobotModel, q, v, frame_ids=None):
    """(...,F,6) spatial velocities [linear; angular] in world axes."""
    return spatial.fmv(frame_jacobians(model, q, frame_ids), v[..., None, :])


def contact_positions(model: RobotModel, q):
    """(...,4,3) world positions of the feet in contact order LF, RF, LH, RH."""
    _, pf = frame_placements(model, q)
    return torch.stack([pf[..., i, :] for i in model.contact_frame_ids], dim=-2)


def ee_pose(model: RobotModel, q):
    """(R, p) of the arm end-effector frame."""
    Rf, pf = frame_placements(model, q)
    return Rf[..., model.ee_frame_id, :, :], pf[..., model.ee_frame_id, :]
