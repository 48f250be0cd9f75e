"""Carry state across from the JAX package: its objects, given as mappings
of field name -> numpy array (or plain value), become this package's
objects on one device in one dtype.

Nothing here imports JAX: a caller turns a JAX dataclass into a mapping,
e.g. ``{f.name: np.asarray(getattr(obj, f.name)) for f in
dataclasses.fields(obj)}`` (static metadata passes through as is).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .device import resolve_device
from .models.model import RobotModel, from_dict
from .ocp.problem import OcpConfig, StageData
from .ocp.reference import TargetTrajectories
from .solver.transcription import LqProblem


def _tensor_fields(cls, d, dtype, device):
    dev = resolve_device(device)
    out = {}
    for f in dataclasses.fields(cls):
        v = d[f.name]
        if isinstance(v, (bool, int, float, str, tuple)):
            out[f.name] = v
        else:
            out[f.name] = torch.tensor(np.asarray(v), dtype=dtype, device=dev)
    return out


def robot_model_from_numpy(d, device=None, dtype=torch.float64) -> RobotModel:
    """RobotModel from the JAX model's fields (or the asset's dict)."""
    return from_dict(d, dtype=dtype, device=device)


def ocp_config_from_numpy(d, device=None, dtype=torch.float64) -> OcpConfig:
    """OcpConfig from the JAX OcpConfig's fields. The options this package
    does not implement yet must be off."""
    if d.get("arm_locked", False):
        raise NotImplementedError("arm_locked (quad-only) is not ported yet")
    if d.get("self_collision_mu", 0.0) > 0.0:
        raise NotImplementedError("the self-collision cost is not ported yet")
    if d.get("wrench_lower") is not None:
        raise NotImplementedError("the force-tracking OCP is not ported yet")
    return OcpConfig(**_tensor_fields(OcpConfig, d, dtype, device))


def stage_data_from_numpy(d, device=None, dtype=torch.float64) -> StageData:
    """StageData from the JAX StageData's fields (30-input problem)."""
    if d.get("grasp_flags") is not None:
        raise NotImplementedError("the force-tracking stage data is not ported yet")
    return StageData(**_tensor_fields(StageData, d, dtype, device))


def target_trajectories_from_numpy(d, device=None, dtype=torch.float64) -> TargetTrajectories:
    return TargetTrajectories(**_tensor_fields(TargetTrajectories, d, dtype, device))


def lq_from_numpy(d, device=None, dtype=torch.float64) -> LqProblem:
    """LqProblem from the JAX LqProblem's fields (any leading batch dims)."""
    return LqProblem(**_tensor_fields(LqProblem, d, dtype, device))
