"""Articulated door model for the door-opening scenario (port of
qm_door_tpu/sim/door.py).

World-library parity for qm_description/urdf/doors/door_{push,pull}.urdf:
a door panel on a vertical hinge (frame-door joint: damping 0.2, travel
[-2, 0] rad, door_push.urdf:66-69) with a lever handle (door-lever joint:
travel [-0.5236, 0], :99-102). The door is a one-DoF (panel) + one-DoF
(lever) second-order system coupled to the robot's end-effector through a
stiff grasp spring.

Batch-native like sim/sim.py: every field of ``DoorState`` has the leading
shape of the simulation state's batch (or none), and q, v carry the same
leading axes. The door stays in the model's dtype on the model's device, so
a coupled step never promotes the physics to another dtype.

Sign convention: panel angle 0 = closed, negative = opening (push door).
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache
from typing import NamedTuple

import torch

from ..device import resolve_device
from ..models import kinematics, spatial
from ..models.model import RobotModel
from .world import body_spheres


class DoorConfig(NamedTuple):
    hinge_pos: tuple = (0.0, 0.0)        # world (x, y) of the hinge axis
    hinge_yaw: float = 0.0               # door frame heading at angle 0
    # Tuned lumped parameter, NOT URDF-derived: door_push.urdf's inertial
    # tags (panel 0.1 kg, lever 5 kg, frame 100 kg) are placeholder values
    # that Gazebo's constraint solver masks; this inertia gives a realistic
    # interior door (~25 kg slab, 0.9 m wide: m w^2 / 3 ~ 7-9 kg m^2).
    panel_inertia: float = 8.53          # kg m^2 about the hinge
    panel_damping: float = 0.2           # door_push.urdf:66
    panel_lower: float = -2.0            # door_push.urdf:69
    panel_upper: float = 0.0
    lever_inertia: float = 0.01
    lever_damping: float = 0.05
    lever_spring: float = 2.0            # returns the handle to 0
    lever_lower: float = -0.5236         # door_push.urdf:102
    lever_upper: float = 0.0
    # Handle point in the door frame (x along the panel); magnitude matches
    # the URDF lever placement (|x| = 0.796 there, opposite sign convention
    # since our x axis points hinge -> handle), height tuned for the robot.
    handle_offset: tuple = (0.8, -0.05, 1.0)
    grasp_stiffness: float = 2000.0      # EE-handle coupling spring
    grasp_damping: float = 50.0
    latch_release: float = -0.4          # lever angle that frees the panel
    # Panel slab geometry for robot-body contact (door_push.urdf panel
    # collision box: 0.9 x 0.04 x 2.0 roughly; the handle sits at |x|=0.8):
    panel_width: float = 0.9             # hinge -> free edge extent (m)
    panel_height: float = 2.0
    panel_thickness: float = 0.05
    contact_stiffness: float = 20000.0   # matches sim/world.py wall params
    contact_damping: float = 300.0
    contact_mu: float = 0.7


@dataclass(frozen=True)
class DoorState:
    """The door's state; every field has the same leading shape (``batch``)."""

    angle: torch.Tensor       # panel hinge angle
    rate: torch.Tensor
    lever: torch.Tensor       # handle lever angle
    lever_rate: torch.Tensor

    @staticmethod
    def init(dtype=torch.float32, batch=(), device=None) -> "DoorState":
        """Closed and at rest. ``device=None`` means CUDA (device.resolve_device)."""
        z = torch.zeros(batch, dtype=dtype, device=resolve_device(device))
        return DoorState(angle=z, rate=z, lever=z, lever_rate=z)


def handle_position(cfg: DoorConfig, state: DoorState):
    """(..., 3) world position of the handle point for the panel angle."""
    yaw = cfg.hinge_yaw + state.angle
    c, s = torch.cos(yaw), torch.sin(yaw)
    ox, oy, oz = cfg.handle_offset
    hx = cfg.hinge_pos[0] + c * ox - s * oy
    hy = cfg.hinge_pos[1] + s * ox + c * oy
    return torch.stack([hx, hy, torch.full_like(hx, oz)], dim=-1)


def handle_velocity(cfg: DoorConfig, state: DoorState):
    """(..., 3) world velocity of the handle point (panel rotation only)."""
    yaw = cfg.hinge_yaw + state.angle
    c, s = torch.cos(yaw), torch.sin(yaw)
    ox, oy, _ = cfg.handle_offset
    # d/dt of the rotated offset
    vx = (-s * ox - c * oy) * state.rate
    vy = (c * ox - s * oy) * state.rate
    return torch.stack([vx, vy, torch.zeros_like(vx)], dim=-1)


def _kinematics(model: RobotModel, q):
    """What the grasp and the panel contact read of one robot pose: the
    joints' world axes and origins and every frame's position."""
    axes, origins, fk_out = kinematics.joint_world_axes(model, q)
    return axes, origins, kinematics.frame_placements(model, q, fk_out)[1]


def grasp_wrench(model: RobotModel, cfg: DoorConfig, state: DoorState, q, v, kin=None):
    """Force the grasp spring applies ON the robot EE (world frame, (..., 3)),
    the EE position (..., 3) and its Jacobian (..., 6, 24).

    Equal and opposite force acts on the door at the handle point. ``kin``:
    _kinematics(model, q), when the caller has it."""
    axes, origins, pf = _kinematics(model, q) if kin is None else kin
    f = model.ee_frame_id
    p_ee = pf[..., f, :]
    J_ee = kinematics.point_jacobian(model, q, model.frame_parent[f], p_ee, (axes, origins))
    v_ee = spatial.fmv(J_ee[..., :3, :], v)
    p_h = handle_position(cfg, state)
    v_h = handle_velocity(cfg, state)
    F_on_ee = -cfg.grasp_stiffness * (p_ee - p_h) - cfg.grasp_damping * (v_ee - v_h)
    return F_on_ee, p_ee, J_ee


@lru_cache(maxsize=None)
def _hinge(hinge_pos: tuple, dtype, device):
    return torch.tensor([hinge_pos[0], hinge_pos[1], 0.0], dtype=dtype, device=device)


def panel_contact_forces(model: RobotModel, cfg: DoorConfig, state: DoorState, q, v,
                         kin=None):
    """Penalty contact of the robot BODY against the door panel slab.

    The grasp spring couples only the EE to the handle; this adds what
    Gazebo's collision pipeline gives the reference (QMHWSim.cpp:71-96 reads
    ContactManager over the URDF collision boxes, door_push.urdf:63-107):
    the four feet and the four trunk proxy spheres (sim/world.py:
    body_spheres, all eight at once) vs the panel treated as a vertical slab
    of ``panel_thickness`` spanning [0, panel_width] x [0, panel_height] in
    the door frame at the current hinge angle. Same spring-damper +
    Coulomb-clamped tangential model as sim/world.py:sphere_mesh_force.

    Returns (tau_gen (..., 24) on the robot, tau_hinge (...) reaction torque
    on the panel about the hinge axis). The JAX package sums the eight
    spheres one at a time; here they are summed at once, so the two agree
    to rounding, not bit for bit.
    """
    yaw = cfg.hinge_yaw + state.angle
    c, s = torch.cos(yaw), torch.sin(yaw)
    z = torch.zeros_like(c)
    u = torch.stack([c, s, z], dim=-1)[..., None, :]       # hinge -> free edge
    n = torch.stack([-s, c, z], dim=-1)[..., None, :]      # panel normal
    hinge = _hinge(tuple(cfg.hinge_pos), q.dtype, q.device)
    half_t = 0.5 * cfg.panel_thickness

    axes, origins, pf = _kinematics(model, q) if kin is None else kin
    p, J, radius = body_spheres(model, q, axes, origins, pf)  # (..., 8, 3), (..., 8, 3, 24)
    v_p = spatial.fmv(J, v[..., None, :])

    rel = p - hinge
    d = torch.sum(rel * n, dim=-1)                        # signed normal distance
    span = torch.sum(rel * u, dim=-1)                     # along-panel coordinate
    inside = ((span >= 0.0) & (span <= cfg.panel_width)
              & (p[..., 2] >= 0.0) & (p[..., 2] <= cfg.panel_height))
    pen = radius + half_t - torch.abs(d)
    engaged = inside & (pen > 0.0)
    n_dir = torch.sign(d)[..., None] * n                  # toward the sphere side
    # panel surface point velocity: hinge rotation at rate about z
    v_panel = state.rate[..., None, None] * torch.stack(
        [-rel[..., 1], rel[..., 0], torch.zeros_like(d)], dim=-1)
    v_rel = v_p - v_panel
    vn = torch.sum(v_rel * n_dir, dim=-1)
    fn = torch.clamp(torch.where(engaged, cfg.contact_stiffness * pen
                                 - cfg.contact_damping * vn, torch.zeros_like(pen)), min=0.0)
    v_t = v_rel - vn[..., None] * n_dir
    ft = -200.0 * v_t * engaged[..., None]
    ft_norm = torch.linalg.norm(ft, dim=-1, keepdim=True)
    ft_max = cfg.contact_mu * fn[..., None]
    ft = ft * torch.where(ft_norm > ft_max, ft_max / torch.clamp(ft_norm, min=1e-9),
                          torch.ones_like(ft_norm))
    F = fn[..., None] * n_dir + ft                        # (..., 8, 3)

    tau = torch.einsum("...cij,...ci->...j", J, F)
    tau_hinge = torch.sum(rel[..., 0] * (-F[..., 1]) - rel[..., 1] * (-F[..., 0]), dim=-1)
    return tau, tau_hinge


def door_step(cfg: DoorConfig, state: DoorState, F_on_door, p_applied, dt,
              latched=True, tau_hinge_extra=0.0) -> DoorState:
    """Advance the door one step under a world force at a point on the panel.

    F_on_door (..., 3): force the robot applies to the door (minus the grasp
    force on the EE). ``latched``: when True the panel only moves if the
    lever is pulled past ``latch_release`` (door_push latch behavior); the
    lever itself is driven by the z-component of the applied force acting at
    the handle lever arm (0.1 m).
    """
    # torque about the vertical hinge: (p - hinge) x F, z row
    rx = p_applied[..., 0] - cfg.hinge_pos[0]
    ry = p_applied[..., 1] - cfg.hinge_pos[1]
    tau_panel = rx * F_on_door[..., 1] - ry * F_on_door[..., 0] + tau_hinge_extra

    # lever: -z force on the handle turns it (0.1 m lever arm), spring return
    tau_lever = (0.1 * F_on_door[..., 2] - cfg.lever_spring * state.lever
                 - cfg.lever_damping * state.lever_rate)
    lever_acc = tau_lever / cfg.lever_inertia
    lever_rate = state.lever_rate + dt * lever_acc
    lever = torch.clamp(state.lever + dt * lever_rate, cfg.lever_lower, cfg.lever_upper)
    # zero only the limit-violating velocity direction
    lever_rate = torch.where(
        ((lever <= cfg.lever_lower) & (lever_rate < 0))
        | ((lever >= cfg.lever_upper) & (lever_rate > 0)),
        torch.zeros_like(lever_rate), lever_rate)

    unlatched = (lever < cfg.latch_release) | (state.angle < -1e-3)
    if not isinstance(latched, bool):
        unlatched = unlatched | ~torch.as_tensor(latched, device=lever.device)
    elif not latched:
        unlatched = torch.ones_like(unlatched)
    acc = torch.where(unlatched, (tau_panel - cfg.panel_damping * state.rate) / cfg.panel_inertia,
                      torch.zeros_like(tau_panel))
    rate = torch.where(unlatched, state.rate + dt * acc, torch.zeros_like(state.rate))
    angle = torch.clamp(state.angle + dt * rate, cfg.panel_lower, cfg.panel_upper)
    rate = torch.where(
        ((angle <= cfg.panel_lower) & (rate < 0))
        | ((angle >= cfg.panel_upper) & (rate > 0)),
        torch.zeros_like(rate), rate)
    return DoorState(angle=angle, rate=rate, lever=lever, lever_rate=lever_rate)


def coupled_step(model: RobotModel, sim_cfg, door_cfg: DoorConfig, sim_state,
                 door_state: DoorState, command_stack, latched=True, grasp_on=1.0,
                 body_contact=True):
    """One physics step of robot + door with the grasp coupling active.

    ``command_stack`` (B, 5, 18) as sim.sim_step takes it. Returns
    (sim_state, door_state). The grasp spring force acts on the robot EE
    (via J_ee^T) and, with opposite sign, on the door at the EE application
    point. ``grasp_on`` in [0, 1] (a number, or a tensor of the batch's
    shape) gates the coupling (0 before the hand closes on the handle).
    ``body_contact`` adds trunk/feet vs panel-slab penalty contact (Gazebo
    collision parity: a closed panel stops a walking robot; the grasp
    spring alone cannot represent that).
    """
    from .sim import sim_step

    q, v = sim_state.q, sim_state.v
    kin = _kinematics(model, q)
    F_on_ee, p_ee, J_ee = grasp_wrench(model, door_cfg, door_state, q, v, kin)
    if isinstance(grasp_on, (int, float)):
        F_on_ee = grasp_on * F_on_ee
    else:
        F_on_ee = torch.as_tensor(grasp_on, dtype=q.dtype, device=q.device)[..., None] * F_on_ee
    tau_extra = spatial.fmv(J_ee[..., :3, :].transpose(-1, -2), F_on_ee)
    tau_hinge_extra = 0.0
    if body_contact:
        tau_body, tau_hinge_extra = panel_contact_forces(model, door_cfg, door_state, q, v, kin)
        tau_extra = tau_extra + tau_body
    sim_new = sim_step(model, sim_cfg, sim_state, command_stack, tau_gen_extra=tau_extra)
    door_new = door_step(door_cfg, door_state, -F_on_ee, p_ee, sim_cfg.dt, latched=latched,
                         tau_hinge_extra=tau_hinge_extra)
    return sim_new, door_new
