"""Lateral-collision world library: mazes, tunnels, v-chimney (port of
qm_door_tpu/sim/world.py).

Point-vs-triangle penalty contact over the extracted world meshes
(``assets/worlds.json``, this package's own copy): the 4 feet and four
trunk proxy spheres against every triangle of the world. A world has a
fixed triangle count (28..410), so the query is one broadcast over
(batch, sphere, triangle): a spring-damper normal force on every triangle
a sphere overlaps (two-sided walls) with Coulomb-clamped tangential
damping (mu 0.7, mazes/maze1.xacro:20-21).
"""
from __future__ import annotations

import json
import os
from functools import lru_cache
from typing import NamedTuple

import numpy as np
import torch

from ..device import resolve_device
from ..models import kinematics, spatial
from ..models.model import RobotModel

_ASSET = os.path.join(os.path.dirname(__file__), "..", "assets", "worlds.json")

# trunk proxy spheres (base-frame centers, shared radius): the AlienGo trunk
# is 0.65 x 0.28 m with the hip/shoulder volumes just outside; four corner
# spheres cover the same footprint
TRUNK_POINTS = np.array([
    [0.33, 0.15, 0.0],
    [0.33, -0.15, 0.0],
    [-0.33, 0.15, 0.0],
    [-0.33, -0.15, 0.0],
])
# ~4 cm of clearance a side when centered in tunnel50's 0.98 m passage
TRUNK_RADIUS = 0.12
FOOT_RADIUS = 0.02


class WorldMesh(NamedTuple):
    v0: torch.Tensor   # (T, 3) first vertex
    e1: torch.Tensor   # (T, 3) v1 - v0
    e2: torch.Tensor   # (T, 3) v2 - v0
    n: torch.Tensor    # (T, 3) unit normal (from winding)


@lru_cache(maxsize=None)
def _load_raw():
    with open(_ASSET) as f:
        return json.load(f)


def world_names():
    return sorted(_load_raw().keys())


@lru_cache(maxsize=None)
def load_world(name: str, offset: tuple = (0.0, 0.0, 0.0), dtype=torch.float64,
               device=None) -> WorldMesh:
    """World mesh, optionally translated by ``offset`` (world placement), in
    ``dtype`` on ``device`` (built once per placement, dtype and device).
    ``device=None`` means CUDA (see device.resolve_device)."""
    device = resolve_device(device)
    tris = np.asarray(_load_raw()[name], dtype=np.float64).reshape(-1, 3, 3)
    tris = tris + np.asarray(offset)
    v0, v1, v2 = tris[:, 0], tris[:, 1], tris[:, 2]
    e1, e2 = v1 - v0, v2 - v0
    n = np.cross(e1, e2)
    norm = np.linalg.norm(n, axis=-1, keepdims=True)
    keep = norm[:, 0] > 1e-9  # drop degenerate triangles
    return WorldMesh(*(torch.tensor(a, dtype=dtype, device=device)
                       for a in (v0[keep], e1[keep], e2[keep], n[keep] / norm[keep])))


def sphere_mesh_force(mesh: WorldMesh, p, v_p, radius, stiffness, damping,
                      mu=0.7, tangential_damping=200.0):
    """(..., 3) contact force on spheres (centers p (..., 3), velocities
    v_p (..., 3)) from the mesh, summed over its triangles.

    Per triangle: signed plane distance d, face-interior test by
    barycentric coordinates; engaged when |d| < radius with the closest
    plane point inside the face. Normal direction sign(d) * n (two-sided
    walls); spring-damper normal and velocity-damped tangential force with
    a Coulomb clamp, as the ground model in sim.py:_contact_forces.
    """
    v0, e1, e2, n = (a.to(dtype=p.dtype, device=p.device) for a in mesh)

    w = p[..., None, :] - v0                  # (..., T, 3)
    d = torch.sum(w * n, dim=-1)              # (..., T) signed plane distance
    # barycentric coordinates of the in-plane projection
    a = torch.sum(e1 * e1, dim=-1)
    b = torch.sum(e1 * e2, dim=-1)
    c = torch.sum(e2 * e2, dim=-1)
    du = torch.sum(w * e1, dim=-1)
    dv = torch.sum(w * e2, dim=-1)
    det = torch.clamp(a * c - b * b, min=1e-12)
    s = (c * du - b * dv) / det
    t = (a * dv - b * du) / det
    inside = (s >= -1e-3) & (t >= -1e-3) & (s + t <= 1.0 + 1e-3)

    pen = radius - torch.abs(d)               # > 0 when overlapping
    engaged = inside & (pen > 0.0)
    n_dir = torch.sign(d)[..., None] * n      # outward (toward the sphere)

    vn = torch.sum(v_p[..., None, :] * n_dir, dim=-1)
    fn = torch.clamp(torch.where(engaged, stiffness * pen - damping * vn,
                                 torch.zeros_like(pen)), min=0.0)

    v_t = v_p[..., None, :] - vn[..., None] * n_dir
    ft = -tangential_damping * v_t * engaged[..., None]
    ft_norm = torch.linalg.norm(ft, dim=-1, keepdim=True)
    ft_max = mu * fn[..., None]
    scale = torch.where(ft_norm > ft_max, ft_max / torch.clamp(ft_norm, min=1e-9),
                        torch.ones_like(ft_norm))

    F = fn[..., None] * n_dir + ft * scale    # (..., T, 3)
    return torch.sum(F, dim=-2)


@lru_cache(maxsize=None)
def _sphere_constants(dtype, device):
    """The trunk spheres' base-frame centers (4, 3) and the eight radii (8,)."""
    return (torch.tensor(TRUNK_POINTS, dtype=dtype, device=device),
            torch.tensor([FOOT_RADIUS] * 4 + [TRUNK_RADIUS] * 4, dtype=dtype, device=device))


def body_spheres(model: RobotModel, q, axes, origins, pf):
    """The robot's collision spheres, the 4 feet then the 4 trunk proxy
    spheres: centers (..., 8, 3), the linear rows of their LWA Jacobians
    (..., 8, 3, 24) and radii (8,). ``axes``, ``origins`` and ``pf`` are
    kinematics.joint_world_axes' axes and origins and
    kinematics.frame_placements' positions at q."""
    J_feet = torch.stack([
        kinematics.point_jacobian(model, q, model.frame_parent[f], pf[..., f, :],
                                  (axes, origins))[..., :3, :]
        for f in model.contact_frame_ids], dim=-3)                 # (..., 4, 3, 24)
    p_feet = torch.stack([pf[..., f, :] for f in model.contact_frame_ids], dim=-2)
    # trunk proxy spheres, attached to the base body: one Jacobian call for
    # the four (the base body has no joint columns)
    r_local, radius = _sphere_constants(q.dtype, q.device)
    R_base = spatial.zyx_to_rot(q[..., 3:6])
    p_trunk = q[..., None, 0:3] + spatial.fmv(R_base[..., None, :, :], r_local)
    q4 = q[..., None, :].expand(*q.shape[:-1], len(TRUNK_POINTS), q.shape[-1])
    J_trunk = kinematics.point_jacobian(model, q4, 0, p_trunk, (None, None))[..., :3, :]
    return (torch.cat([p_feet, p_trunk], dim=-2), torch.cat([J_feet, J_trunk], dim=-3),
            radius)


def world_generalized_forces(model: RobotModel, mesh: WorldMesh, q, v,
                             stiffness=20000.0, damping=300.0, mu=0.7):
    """(..., 24) generalized force from wall contacts on the feet and the
    trunk spheres, all eight in one query."""
    axes, origins, fk_out = kinematics.joint_world_axes(model, q)
    _, pf = kinematics.frame_placements(model, q, fk_out)
    p, J, radius = body_spheres(model, q, axes, origins, pf)
    vel = spatial.fmv(J, v[..., None, :])
    F = sphere_mesh_force(mesh, p, vel, radius[:, None], stiffness, damping, mu)  # (..., 8, 3)
    return torch.einsum("...cij,...ci->...j", J, F)
