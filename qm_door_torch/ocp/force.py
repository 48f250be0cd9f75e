"""Force-tracking OCP extension: the EE wrench as a tracked input (port of
qm_door_tpu/ocp/force.py).

- input u (36) = [foot forces (12); joint velocities (18); EE wrench (6)]
  (models/centroidal.ee_wrench),
- the flow map adds the wrench's momentum-rate contribution
  (models/centroidal.flow_map_ft),
- the wrench is eliminated like a swing foot's force where the per-node
  ``grasp_flags`` gate is 0 (solver/projection.project_node_chol_ft), and is
  a free input tracked toward u_nom[..., 30:36] while grasping,
- its tracking weights live in the widened R (make_ocp_config_ft).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..models import centroidal
from ..models.model import RobotModel
from .gait import GaitSchedule
from .problem import OcpConfig, StageData, build_stage_data, make_ocp_config
from .reference import TargetTrajectories

NU_FT = 36


def make_ocp_config_ft(model: RobotModel, cfg, dtype=None) -> OcpConfig:
    """OcpConfig with R widened to (36, 36): the 30-input R plus the
    EE-wrench tracking weights of cfg.force_tracking."""
    base = make_ocp_config(model, cfg, dtype=dtype)
    ft = cfg.force_tracking
    r_w = np.concatenate([np.full(3, ft.r_ee_force), np.full(3, ft.r_ee_torque)])
    R36 = np.zeros((NU_FT, NU_FT))
    R36[:30, :30] = base.R.cpu().numpy()
    R36[30:, 30:] = np.diag(r_w * cfg.cost.r_scaling)
    return dataclasses.replace(
        base, R=torch.as_tensor(R36, dtype=base.R.dtype, device=base.R.device))


def widen_stage_data(stage: StageData, grasp_flags, wrench_ref, dtype=None) -> StageData:
    """Widen a 30-input StageData (shared, (N+1, ...)) to the force-tracking
    problem.

    grasp_flags: (N+1,) in [0, 1], the wrench input's gate a node;
    wrench_ref: (N+1, 6), the EE wrench wanted while grasping (the external
    wrench ON the robot EE). The stance feet share the reaction to the
    reference force, so the tracking cost has its unique minimum at
    (F = adjusted nominal, W = W_ref).
    """
    dtype = dtype or stage.u_nom.dtype
    dev = stage.u_nom.device
    grasp = torch.as_tensor(grasp_flags, dtype=dtype, device=dev)
    wref = torch.as_tensor(wrench_ref, dtype=dtype, device=dev) * grasp[:, None]
    flags = stage.contact_flags                                       # (N+1, 4)
    n_stance = torch.clamp(torch.sum(flags, dim=-1, keepdim=True), min=1.0)
    share = -wref[:, 0:3] / n_stance                                  # per stance foot
    dF = flags[..., None] * share[:, None, :]                         # (N+1, 4, 3)
    u_nom30 = torch.cat([stage.u_nom[:, 0:12] + dF.reshape(flags.shape[0], 12),
                         stage.u_nom[:, 12:]], dim=-1)
    return dataclasses.replace(stage, u_nom=torch.cat([u_nom30, wref], dim=-1),
                               grasp_flags=grasp)


def build_stage_data_ft(model: RobotModel, cfg, schedule: GaitSchedule,
                        targets: TargetTrajectories, t0: float, grasp_fn, wrench_fn,
                        dtype=None) -> StageData:
    """build_stage_data plus the grasp and wrench timeline: grasp_fn(times
    (N+1,)) -> (N+1,) gate, wrench_fn(times) -> (N+1, 6) reference, both
    evaluated on the host (numpy) per solve."""
    stage = build_stage_data(model, cfg, schedule, targets, t0, dtype=dtype)
    times = stage.times.cpu().numpy()
    return widen_stage_data(stage, grasp_fn(times), wrench_fn(times), dtype=dtype)


def weight_compensating_input_ft(model: RobotModel, contact_flags, dtype=None):
    """36-dim nominal input (..., 36): weight-compensating foot forces, zero
    wrench."""
    u30 = centroidal.weight_compensating_input(model, contact_flags, dtype=dtype)
    return torch.cat([u30, torch.zeros(*u30.shape[:-1], 6, dtype=u30.dtype,
                                       device=u30.device)], dim=-1)
