"""Batched rigid-body simulation (port of qm_door_tpu/sim/sim.py).

Full whole-body dynamics M(q) a = tau_gen + J_c^T F_contact - h(q, v) with
spring-damper ground contacts and Coulomb-clamped tangential friction,
semi-implicit Euler at the physics rate. The actuator model reproduces
QMHWSim::writeSim (QMHWSim.cpp:98-116): a command delay ring (default.yaml
gazebo/delay: 9 ms), then tau = kp (q_d - q) + kd (v_d - v) + ff, clamped
to the URDF effort limits.

Batch-native: every field of ``SimState`` has a leading scenario axis and
one ``sim_step`` advances every scenario. The ring index is a tensor, so a
step reads nothing back to the host.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import NamedTuple

import torch

from ..models import centroidal, dynamics, kinematics
from ..models.model import RobotModel
from .terrain import terrain_height


class SimConfig(NamedTuple):
    dt: float = 0.001
    contact_stiffness: float = 40000.0
    # explicit-integration stability: c * dt / m_foot_effective < 1
    contact_damping: float = 500.0
    friction_coefficient: float = 0.8
    tangential_velocity_damping: float = 200.0
    # optional stiction anchor spring (off by default): with pure velocity
    # damping, stance feet creep at v_t = F_t / c. When > 0, each foot in
    # contact anchors a lateral spring at its touchdown point, the anchor
    # dragged along the Coulomb circle when the clamp saturates.
    tangential_stiffness: float = 0.0
    delay_steps: int = 9  # 9 ms at 1 kHz (qm_gazebo/config/default.yaml:2)
    # terrain: the static name selects the height field; the params are data
    terrain: str = "flat"
    terrain_params: tuple = (0.0,)
    # lateral-collision world mesh (sim/world.py: mazes/tunnels/v-chimney);
    # "none" disables the wall-contact query entirely
    world: str = "none"
    world_offset: tuple = (0.0, 0.0, 0.0)
    wall_stiffness: float = 20000.0
    wall_damping: float = 300.0
    wall_friction: float = 0.7  # mazes/maze1.xacro:20-21

    @property
    def terrain_height(self):
        """Mean flat height (spawn grounding); exact only for flat terrain."""
        return self.terrain_params[0] if self.terrain == "flat" else 0.0


@dataclass(frozen=True)
class SimState:
    """B scenarios' physics state; every field leads with the batch axis."""

    q: torch.Tensor           # (B, 24)
    v: torch.Tensor           # (B, 24)
    t: torch.Tensor           # (B,)
    cmd_buffer: torch.Tensor  # (B, delay_steps+1, 5, 18) hybrid command history
    buf_head: torch.Tensor    # (B,) int64 ring index
    anchor: torch.Tensor      # (B, 4, 2) stiction anchor xy per foot (world)


def sim_init(model: RobotModel, q0, v0=None, cfg: SimConfig = SimConfig()) -> SimState:
    """q0 (B, 24), v0 (B, 24) or None (at rest)."""
    B = q0.shape[0]
    v0 = torch.zeros_like(q0) if v0 is None else v0
    nbuf = cfg.delay_steps + 1
    # the ring starts full of "hold position, zero gains" commands
    buf = torch.zeros(B, nbuf, 5, 18, dtype=q0.dtype, device=q0.device)
    buf[:, :, 0, :] = q0[:, None, 6:24]
    return SimState(
        q=q0, v=v0, t=torch.zeros(B, dtype=q0.dtype, device=q0.device), cmd_buffer=buf,
        buf_head=torch.zeros(B, dtype=torch.int64, device=q0.device),
        anchor=kinematics.contact_positions(model, q0)[..., 0:2],
    )


def _contact_forces(model: RobotModel, cfg: SimConfig, q, v, anchor=None):
    """(..., 4, 3) ground-reaction forces on the feet (world frame).

    ``anchor`` (..., 4, 2): stiction anchor points (SimConfig.
    tangential_stiffness). Returns (F, J, in_contact, anchor_new)."""
    axes, origins, fk_out = kinematics.joint_world_axes(model, q)
    _, pf = kinematics.frame_placements(model, q, fk_out)
    p = torch.stack([pf[..., f, :] for f in model.contact_frame_ids], dim=-2)  # (..., 4, 3)
    J = torch.stack([
        kinematics.point_jacobian(model, q, model.frame_parent[f], pf[..., f, :],
                                  (axes, origins))[..., :3, :]
        for f in model.contact_frame_ids], dim=-3)                            # (..., 4, 3, 24)
    vel = torch.matmul(J, v[..., None, :, None])[..., 0]                       # (..., 4, 3)
    ground = terrain_height(cfg.terrain, p[..., 0], p[..., 1], cfg.terrain_params)
    depth = ground - p[..., 2]                                # > 0 when penetrating
    in_contact = depth > 0
    contact = in_contact[..., None].to(q.dtype)
    fz = torch.where(in_contact, cfg.contact_stiffness * depth
                     - cfg.contact_damping * vel[..., 2], torch.zeros_like(depth))
    fz = torch.clamp(fz, min=0.0)
    k_t = cfg.tangential_stiffness
    stiction = anchor is not None and k_t != 0.0
    if not stiction:
        ft = -cfg.tangential_velocity_damping * vel[..., :2] * contact
        anchor_new = p[..., 0:2]
    else:
        # swing feet carry their anchor along (touchdown re-anchors there),
        # but only clearly airborne ones (2 mm): standing feet micro-hop
        # through depth = 0, and re-anchoring on every hop would ratchet
        # the anchor along at the creep rate
        airborne = depth < -0.002
        anchor_eff = torch.where(airborne[..., None], p[..., 0:2], anchor)
        ft = (-k_t * (p[..., 0:2] - anchor_eff)
              - cfg.tangential_velocity_damping * vel[..., :2]) * contact
        anchor_new = anchor_eff
    # Coulomb clamp
    ft_norm = torch.linalg.norm(ft, dim=-1, keepdim=True)
    ft_max = cfg.friction_coefficient * fz[..., None]
    scale = torch.where(ft_norm > ft_max, ft_max / torch.clamp(ft_norm, min=1e-9),
                        torch.ones_like(ft_norm))
    ft = ft * scale
    if stiction:
        # a saturated clamp is kinetic sliding: drag the anchor so that the
        # spring alone gives exactly the clamped force
        slide = scale < 1.0
        anchor_slid = p[..., 0:2] + (ft + cfg.tangential_velocity_damping * vel[..., :2]) / k_t
        anchor_new = torch.where(slide & in_contact[..., None], anchor_slid, anchor_new)
    return torch.cat([ft, fz[..., None]], dim=-1), J, in_contact, anchor_new


def push_command(state: SimState, command_stack) -> SimState:
    """Insert each scenario's new hybrid command (B, 5, 18) into its delay ring."""
    nbuf = state.cmd_buffer.shape[1]
    head = (state.buf_head + 1) % nbuf
    slot = torch.arange(nbuf, device=head.device) == head[:, None]            # (B, nbuf)
    buf = torch.where(slot[:, :, None, None], command_stack[:, None], state.cmd_buffer)
    return replace(state, cmd_buffer=buf, buf_head=head)


def _delayed_command(state: SimState):
    """The oldest command in each ring: the one delayed by delay_steps."""
    nbuf = state.cmd_buffer.shape[1]
    idx = (state.buf_head + 1) % nbuf
    return torch.gather(state.cmd_buffer, 1,
                        idx[:, None, None, None].expand(-1, 1, 5, 18))[:, 0]


def sim_step(model: RobotModel, cfg: SimConfig, state: SimState, command_stack,
             external_wrench=None, tau_gen_extra=None) -> SimState:
    """One physics step of every scenario. ``command_stack`` (B, 5, 18): rows
    (pos_des, vel_des, kp, kd, tau_ff). ``external_wrench`` (B, 6), optional:
    a disturbance on the base (world-frame force/torque at the base origin);
    ``tau_gen_extra`` (B, 24), optional: a generalized force (e.g. J_ee^T F
    of the door grasp coupling)."""
    state = push_command(state, command_stack)
    cmd = _delayed_command(state)

    q, v = state.q, state.v
    q_j, v_j = q[:, 6:24], v[:, 6:24]
    tau = cmd[:, 2] * (cmd[:, 0] - q_j) + cmd[:, 3] * (cmd[:, 1] - v_j) + cmd[:, 4]
    tau = torch.clamp(tau, -model.effort_limit, model.effort_limit)

    Fc, J, _, anchor_new = _contact_forces(model, cfg, q, v, state.anchor)
    tau_gen = torch.cat([torch.zeros_like(q[:, :6]), tau], dim=-1)
    tau_gen = tau_gen + torch.einsum("bcij,bci->bj", J, Fc)
    if cfg.world != "none":
        from .world import load_world, world_generalized_forces

        mesh = load_world(cfg.world, tuple(cfg.world_offset), q.dtype, q.device)
        tau_gen = tau_gen + world_generalized_forces(
            model, mesh, q, v, stiffness=cfg.wall_stiffness,
            damping=cfg.wall_damping, mu=cfg.wall_friction)
    if external_wrench is not None:
        Jb = kinematics.frame_jacobians(model, q, (model.base_frame_id,))[:, 0]
        tau_gen = tau_gen + torch.einsum("bij,bi->bj", Jb, external_wrench)
    if tau_gen_extra is not None:
        tau_gen = tau_gen + tau_gen_extra

    a = dynamics.forward_dynamics(model, q, v, tau_gen)
    v_new = v + cfg.dt * a
    q_new = q + cfg.dt * v_new
    return replace(state, q=q_new, v=v_new, t=state.t + cfg.dt, anchor=anchor_new)


def contact_flags_from_sim(model: RobotModel, q, threshold=0.002, cfg=None):
    """Ground-truth contact flags (..., 4) from foot height above the
    terrain (ContactSensor stand-in). Pass ``cfg`` on non-flat worlds:
    thresholding absolute z would never register stance on a raised step."""
    p = kinematics.contact_positions(model, q)
    if cfg is None:
        ground = 0.0
    else:
        ground = terrain_height(cfg.terrain, p[..., 0], p[..., 1], cfg.terrain_params)
    return (p[..., 2] - ground < threshold).to(q.dtype)


def measured_rbd(model: RobotModel, state: SimState):
    """Ground-truth estimator output (FromTopicStateEstimate equivalent), (B, 55)."""
    return centroidal.rbd_from_generalized(model, state.q, state.v)
