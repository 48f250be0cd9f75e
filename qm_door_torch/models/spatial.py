"""Spatial algebra / rotation utilities (port of qm_door_tpu/models/spatial.py).

Every function broadcasts over leading dims and runs under
``torch.func.vmap``/``jacfwd``/``jacrev``.

Conventions:

- Base orientation is parametrized by ZYX Euler angles ``(z, y, x)`` =
  (yaw, pitch, roll); ``R = Rz(z) @ Ry(y) @ Rx(x)`` maps base-frame vectors
  into the world frame.
- The floating-base generalized velocity uses the Euler-rate chart:
  ``v_base = [v_world(3); zyx_rates(3)]``.
- Quaternions are xyzw.
"""
from __future__ import annotations

import torch


def fmm(A, B):
    """Small-matrix product. The single place where the model's and the
    solver's contractions happen (the JAX package writes it as a broadcast
    sum to dodge TPU tile padding; here it is a plain matmul)."""
    return torch.matmul(A, B)


def fmv(A, x):
    """Small matrix-vector product (see fmm)."""
    return torch.matmul(A, x.unsqueeze(-1)).squeeze(-1)


def cross(a, b):
    """Cross product over the last dim, broadcasting the leading dims."""
    return torch.linalg.cross(*torch.broadcast_tensors(a, b), dim=-1)


def _stack2(rows):
    """3x3 (or nxm) matrix from a list of row lists of equal-shape tensors."""
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def inv3(M):
    """Adjugate inverse of a (batched) 3x3 matrix — elementwise ops only.
    Intended for well-conditioned physical matrices (inertia blocks, Euler
    kinematics maps)."""
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    A = e * i - f * h
    B = -(d * i - f * g)
    C = d * h - e * g
    det = a * A + b * B + c * C
    adjT = _stack2([
        [A, -(b * i - c * h), b * f - c * e],
        [B, a * i - c * g, -(a * f - c * d)],
        [C, -(a * h - b * g), a * e - b * d],
    ])
    return adjT / det[..., None, None]


def solve6_block(A6, rhs):
    """Solve ``A6 @ x = rhs`` for a (batched) 6x6 block matrix via the Schur
    complement of the top-left 3x3 block, using :func:`inv3`.

    ``A6`` (..., 6, 6); ``rhs`` (..., 6) or (..., 6, k). Built for the CMM
    base block (top-left = M_tot * I3, Schur complement = locked angular
    inertia composed with the Euler-rate map)."""
    vec = rhs.dim() == A6.dim() - 1
    r = rhs[..., None] if vec else rhs
    P, B = A6[..., 0:3, 0:3], A6[..., 0:3, 3:6]
    C, D = A6[..., 3:6, 0:3], A6[..., 3:6, 3:6]
    Pi = inv3(P)
    CPi = fmm(C, Pi)
    S = D - fmm(CPi, B)
    r1, r2 = r[..., 0:3, :], r[..., 3:6, :]
    y2 = fmm(inv3(S), r2 - fmm(CPi, r1))
    y1 = fmm(Pi, r1 - fmm(B, y2))
    out = torch.cat([y1, y2], dim=-2)
    return out[..., 0] if vec else out


def skew(v):
    """Cross-product matrix: skew(v) @ u == cross(v, u)."""
    z = torch.zeros_like(v[..., 0])
    return _stack2([
        [z, -v[..., 2], v[..., 1]],
        [v[..., 2], z, -v[..., 0]],
        [-v[..., 1], v[..., 0], z],
    ])


def rot_x(a):
    c, s = torch.cos(a), torch.sin(a)
    o, z = torch.ones_like(a), torch.zeros_like(a)
    return _stack2([[o, z, z], [z, c, -s], [z, s, c]])


def rot_y(a):
    c, s = torch.cos(a), torch.sin(a)
    o, z = torch.ones_like(a), torch.zeros_like(a)
    return _stack2([[c, z, s], [z, o, z], [-s, z, c]])


def rot_z(a):
    c, s = torch.cos(a), torch.sin(a)
    o, z = torch.ones_like(a), torch.zeros_like(a)
    return _stack2([[c, -s, z], [s, c, z], [z, z, o]])


def rpy_to_rot(rpy):
    """URDF fixed-axis roll-pitch-yaw -> rotation matrix: Rz(y)Ry(p)Rx(r)."""
    return fmm(fmm(rot_z(rpy[..., 2]), rot_y(rpy[..., 1])), rot_x(rpy[..., 0]))


def zyx_to_rot(zyx):
    """ZYX Euler angles (yaw, pitch, roll) -> rotation matrix Rz Ry Rx."""
    return fmm(fmm(rot_z(zyx[..., 0]), rot_y(zyx[..., 1])), rot_x(zyx[..., 2]))


def rot_to_zyx(R):
    """Rotation matrix -> ZYX Euler angles (yaw, pitch, roll), away from the
    pitch = +-pi/2 singularity."""
    yaw = torch.atan2(R[..., 1, 0], R[..., 0, 0])
    pitch = torch.atan2(-R[..., 2, 0], torch.hypot(R[..., 2, 1], R[..., 2, 2]))
    roll = torch.atan2(R[..., 2, 1], R[..., 2, 2])
    return torch.stack([yaw, pitch, roll], dim=-1)


def zyx_rates_to_world_angvel_matrix(zyx):
    """E(zyx) with omega_world = E @ d/dt(zyx): columns e_z | Rz e_y | Rz Ry e_x."""
    z, y = zyx[..., 0], zyx[..., 1]
    cz, sz = torch.cos(z), torch.sin(z)
    cy, sy = torch.cos(y), torch.sin(y)
    zero = torch.zeros_like(z)
    one = torch.ones_like(z)
    col0 = torch.stack([zero, zero, one], dim=-1)
    col1 = torch.stack([-sz, cz, zero], dim=-1)
    col2 = torch.stack([cz * cy, sz * cy, -sy], dim=-1)
    return torch.stack([col0, col1, col2], dim=-1)


def world_angvel_to_zyx_rates(zyx, omega_world):
    """d/dt(zyx) = E(zyx)^-1 omega_world (analytic inverse)."""
    z, y = zyx[..., 0], zyx[..., 1]
    cz, sz = torch.cos(z), torch.sin(z)
    cy, sy = torch.cos(y), torch.sin(y)
    inv_cy = 1.0 / cy
    one, zero = torch.ones_like(z), torch.zeros_like(z)
    Einv = _stack2([
        [cz * sy * inv_cy, sz * sy * inv_cy, one],
        [-sz, cz, zero],
        [cz * inv_cy, sz * inv_cy, zero],
    ])
    return fmv(Einv, omega_world)


def zyx_rates_to_world_angvel(zyx, zyx_rates):
    return fmv(zyx_rates_to_world_angvel_matrix(zyx), zyx_rates)


def world_angacc_from_zyx(zyx, zyx_rates, zyx_rates_dot):
    """omega_dot_world = E zyxddot + Edot zyxdot, with Edot the jvp of E
    along the Euler rates (ocs2
    getGlobalAngularAccelerationFromEulerAnglesZyxDerivatives equivalent)."""
    E, Edot = torch.func.jvp(zyx_rates_to_world_angvel_matrix, (zyx,), (zyx_rates,))
    return fmv(E, zyx_rates_dot) + fmv(Edot, zyx_rates)


def quat_to_rot(q_xyzw):
    x, y, z, w = q_xyzw[..., 0], q_xyzw[..., 1], q_xyzw[..., 2], q_xyzw[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    return _stack2([
        [1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy)],
        [2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx)],
        [2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy)],
    ])


def rot_to_quat(R):
    """Rotation matrix -> quaternion (xyzw), branchless Shepperd: the four
    candidate constructions, picked by the largest pivot.

    Entries are taken as (..., 1) slices, never 0-d: under torch.func's
    forward AD a 0-d float32 tangent combined with a Python scalar is
    promoted to float64."""
    def e(i, j):
        return R[..., i, j:j + 1]

    m00, m11, m22 = e(0, 0), e(1, 1), e(2, 2)
    tr = m00 + m11 + m22
    qw0 = torch.sqrt(torch.clamp(1.0 + tr, min=1e-12)) / 2.0
    qx1 = torch.sqrt(torch.clamp(1.0 + m00 - m11 - m22, min=1e-12)) / 2.0
    qy2 = torch.sqrt(torch.clamp(1.0 - m00 + m11 - m22, min=1e-12)) / 2.0
    qz3 = torch.sqrt(torch.clamp(1.0 - m00 - m11 + m22, min=1e-12)) / 2.0

    c0 = torch.cat([
        (e(2, 1) - e(1, 2)) / (4 * qw0),
        (e(0, 2) - e(2, 0)) / (4 * qw0),
        (e(1, 0) - e(0, 1)) / (4 * qw0),
        qw0,
    ], dim=-1)
    c1 = torch.cat([
        qx1,
        (e(0, 1) + e(1, 0)) / (4 * qx1),
        (e(0, 2) + e(2, 0)) / (4 * qx1),
        (e(2, 1) - e(1, 2)) / (4 * qx1),
    ], dim=-1)
    c2 = torch.cat([
        (e(0, 1) + e(1, 0)) / (4 * qy2),
        qy2,
        (e(1, 2) + e(2, 1)) / (4 * qy2),
        (e(0, 2) - e(2, 0)) / (4 * qy2),
    ], dim=-1)
    c3 = torch.cat([
        (e(0, 2) + e(2, 0)) / (4 * qz3),
        (e(1, 2) + e(2, 1)) / (4 * qz3),
        qz3,
        (e(1, 0) - e(0, 1)) / (4 * qz3),
    ], dim=-1)
    pivots = torch.cat([tr, m00 - m11 - m22, -m00 + m11 - m22, -m00 - m11 + m22], dim=-1)
    idx = torch.argmax(pivots, dim=-1)
    cands = torch.stack([c0, c1, c2, c3], dim=-2)
    sel = idx[..., None, None].expand(*idx.shape, 1, 4)
    return torch.gather(cands, -2, sel)[..., 0, :]


def quat_slerp(qa, qb, t):
    """Spherical interpolation from qa (t=0) to qb (t=1), shortest arc."""
    dot = torch.sum(qa * qb, dim=-1, keepdim=True)
    qb = torch.where(dot < 0, -qb, qb)
    dot = torch.clamp(torch.abs(dot), -1.0, 1.0)
    theta = torch.arccos(torch.clamp(dot, 0.0, 1.0 - 1e-9))
    sin_theta = torch.sin(theta)
    small = sin_theta < 1e-6
    safe = torch.where(small, torch.ones_like(sin_theta), sin_theta)
    wa = torch.where(small, 1.0 - t, torch.sin((1.0 - t) * theta) / safe)
    wb = torch.where(small, t, torch.sin(t * theta) / safe)
    out = wa * qa + wb * qb
    return out / torch.linalg.norm(out, dim=-1, keepdim=True)


def quat_mul(a, b):
    """Hamilton product (xyzw)."""
    ax, ay, az, aw = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bx, by, bz, bw = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return torch.stack([
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
        aw * bw - ax * bx - ay * by - az * bz,
    ], dim=-1)


def quat_conj(q):
    return torch.cat([-q[..., :3], q[..., 3:]], dim=-1)


def quat_log3(q_xyzw):
    """SO(3) log map of a quaternion -> rotation vector (angle*axis)."""
    v = q_xyzw[..., :3]
    w = q_xyzw[..., 3]
    nv = torch.linalg.norm(v, dim=-1)
    angle = 2.0 * torch.atan2(nv, torch.abs(w))
    one = torch.ones_like(w)
    sign = torch.where(w < 0, -one, one)
    small = nv < 1e-9
    scale = torch.where(small, 2.0 * sign,
                        sign * angle / torch.where(small, torch.ones_like(nv), nv))
    return v * scale[..., None]


def log3(R):
    """SO(3) log map of a rotation matrix -> rotation vector."""
    return quat_log3(rot_to_quat(R))


def rotation_error_world(R_ref, R_meas):
    """World-frame rotation error log(R_ref @ R_meas^T) as a rotation vector
    (ocs2 rotationErrorInWorld, the WBC's base and EE angular tasks)."""
    return log3(fmm(R_ref, R_meas.transpose(-1, -2)))


def quat_distance(qa, qb):
    """Rotation-vector distance between two quaternions."""
    return quat_log3(quat_mul(qb, quat_conj(qa)))


def quat_error_ocs2(q, q_ref):
    """ocs2 quaternionDistance(q, qRef) = w qRef.vec - wRef q.vec + q.vec x qRef.vec
    (the EE soft constraint's orientation error)."""
    return (
        q[..., 3:4] * q_ref[..., :3]
        - q_ref[..., 3:4] * q[..., :3]
        + cross(q[..., :3], q_ref[..., :3])
    )
