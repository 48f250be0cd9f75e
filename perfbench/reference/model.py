"""Plain rigid-body model of the quadruped manipulator, for the benchmark's
reference: forward kinematics from the model file's kinematic tree, the
centroidal momentum matrix from its definition, and the centroidal flow map.

One sample at a time (no batch axis); callers map it with
``torch.func.vmap``. The generalized coordinates are
q (24) = [base position (3); base ZYX euler (3); joints (18)] and their
velocity chart is qdot itself, so every velocity Jacobian here is the
derivative of a position with respect to q, taken by forward-mode AD.
"""
from __future__ import annotations

import json
from dataclasses import dataclass

import torch
from torch.func import jacfwd, jvp

GRAVITY = 9.81
CONTACT_FRAMES = ("LF_FOOT", "RF_FOOT", "LH_FOOT", "RH_FOOT")
EE_FRAME = "z1_end_effector"


@dataclass(frozen=True)
class Model:
    joint_parent: tuple
    frame_parent: tuple
    contact_ids: tuple
    ee_id: int
    joint_rot: torch.Tensor     # (18, 3, 3)
    joint_trans: torch.Tensor   # (18, 3)
    joint_axis: torch.Tensor    # (18, 3)
    body_mass: torch.Tensor     # (19,)
    body_com: torch.Tensor      # (19, 3)
    body_inertia: torch.Tensor  # (19, 3, 3)
    frame_rot: torch.Tensor     # (F, 3, 3)
    frame_trans: torch.Tensor   # (F, 3)
    pos_lower: torch.Tensor     # (18,)
    pos_upper: torch.Tensor

    @property
    def mass(self):
        return torch.sum(self.body_mass)


def load(path, dtype=torch.float64, device="cpu") -> Model:
    with open(path) as f:
        d = json.load(f)
    t = lambda k: torch.tensor(d[k], dtype=dtype, device=device)  # noqa: E731
    names = list(d["frame_names"])
    return Model(
        joint_parent=tuple(int(i) for i in d["joint_parent"]),
        frame_parent=tuple(int(i) for i in d["frame_parent"]),
        contact_ids=tuple(names.index(n) for n in CONTACT_FRAMES),
        ee_id=names.index(EE_FRAME),
        joint_rot=t("joint_rot"), joint_trans=t("joint_trans"), joint_axis=t("joint_axis"),
        body_mass=t("body_mass"), body_com=t("body_com"), body_inertia=t("body_inertia"),
        frame_rot=t("frame_rot"), frame_trans=t("frame_trans"),
        pos_lower=t("pos_lower"), pos_upper=t("pos_upper"))


def skew(v):
    z = torch.zeros_like(v[0])
    return torch.stack([torch.stack([z, -v[2], v[1]]),
                        torch.stack([v[2], z, -v[0]]),
                        torch.stack([-v[1], v[0], z])])


def vee(S):
    return torch.stack([S[2, 1], S[0, 2], S[1, 0]])


def axis_angle(axis, angle):
    """Rotation by ``angle`` about the unit ``axis`` (Rodrigues)."""
    K = skew(axis)
    eye = torch.eye(3, dtype=angle.dtype, device=angle.device)
    return eye + torch.sin(angle) * K + (1.0 - torch.cos(angle)) * (K @ K)


def zyx_rotation(zyx):
    """R = Rz(yaw) Ry(pitch) Rx(roll)."""
    eye = torch.eye(3, dtype=zyx.dtype, device=zyx.device)
    return axis_angle(eye[2], zyx[0]) @ axis_angle(eye[1], zyx[1]) @ axis_angle(eye[0], zyx[2])


def bodies(m: Model, q):
    """World rotations (19, 3, 3) and origins (19, 3) of the base (0) and of
    the child body of each joint (1 + i)."""
    R = [zyx_rotation(q[3:6])]
    p = [q[0:3]]
    for i, par in enumerate(m.joint_parent):
        p.append(R[par] @ m.joint_trans[i] + p[par])
        R.append(R[par] @ m.joint_rot[i] @ axis_angle(m.joint_axis[i], q[6 + i]))
    return torch.stack(R), torch.stack(p)


def frames(m: Model, q):
    """World rotations and positions of the model's named frames."""
    R, p = bodies(m, q)
    Rf = torch.stack([R[b] @ m.frame_rot[f] for f, b in enumerate(m.frame_parent)])
    pf = torch.stack([R[b] @ m.frame_trans[f] + p[b] for f, b in enumerate(m.frame_parent)])
    return Rf, pf


def body_coms(m: Model, q):
    R, p = bodies(m, q)
    return torch.einsum("bij,bj->bi", R, m.body_com) + p


def com(m: Model, q):
    return torch.sum(m.body_mass[:, None] * body_coms(m, q), dim=0) / m.mass


def feet(m: Model, q):
    return frames(m, q)[1][list(m.contact_ids)]


def ee_pose(m: Model, q):
    Rf, pf = frames(m, q)
    return Rf[m.ee_id], pf[m.ee_id]


def momentum_matrix(m: Model, q):
    """A(q) (6, 24) with [linear momentum; angular momentum about the com] =
    A qdot: each body's com velocity Jc = d c_i / dq and angular velocity
    Jw from dR_i R_i^T, summed with its mass and world inertia."""
    def pose(q_):
        R, p = bodies(m, q_)
        return R, torch.einsum("bij,bj->bi", R, m.body_com) + p

    (R, c), (dR, dc) = pose(q), jacfwd(pose)(q)         # dR (19,3,3,24), dc (19,3,24)
    Jw = torch.stack([dR[..., k] @ R.transpose(-1, -2) for k in range(q.shape[0])], dim=-1)
    Jw = torch.stack([Jw[:, 2, 1], Jw[:, 0, 2], Jw[:, 1, 0]], dim=1)          # (19,3,24)
    Iw = R @ m.body_inertia @ R.transpose(-1, -2)
    c_tot = torch.sum(m.body_mass[:, None] * c, dim=0) / m.mass
    lin = torch.sum(m.body_mass[:, None, None] * dc, dim=0)
    ang = torch.sum(Iw @ Jw + m.body_mass[:, None, None] * torch.stack(
        [skew(ci - c_tot) for ci in c]) @ dc, dim=0)
    return torch.cat([lin, ang], dim=0)


def base_velocity(m: Model, x, u):
    """Base velocity (6) from the normalized momentum: A_b v_b = m h - A_j v_j.
    (By the inverse: forward AD of torch.linalg.solve under vmap gave NaN.)"""
    A = momentum_matrix(m, x[6:30])
    return torch.linalg.inv(A[:, :6]) @ (m.mass * x[0:6] - A[:, 6:] @ u[12:30])


def flow(m: Model, x, u):
    """xdot = f(x, u): momentum rates from the foot forces (and, with 36
    inputs, the end-effector wrench), base velocity, joint velocities."""
    q = x[6:30]
    F = u[0:12].reshape(4, 3)
    c = com(m, q)
    force = torch.sum(F, dim=0)
    torque = torch.sum(torch.linalg.cross(feet(m, q) - c, F, dim=-1), dim=0)
    if u.shape[0] == 36:
        W = u[30:36]
        force = force + W[0:3]
        torque = torque + torch.linalg.cross(ee_pose(m, q)[1] - c, W[0:3], dim=-1) + W[3:6]
    gravity = torch.tensor([0.0, 0.0, GRAVITY], dtype=x.dtype, device=x.device)
    return torch.cat([force / m.mass - gravity, torque / m.mass, base_velocity(m, x, u),
                      u[12:30]])


def foot_velocities(m: Model, x, u):
    """(12) linear velocities of the four feet: d feet / dq along qdot."""
    qdot = torch.cat([base_velocity(m, x, u), u[12:30]])
    return jvp(lambda q_: feet(m, q_).reshape(12), (x[6:30],), (qdot,))[1]
