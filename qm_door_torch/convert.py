"""Carry state across from the JAX package: its objects, given as mappings
of field name -> numpy array (or plain value), become this package's
objects on one device in one dtype.

Nothing here imports JAX: a caller turns a JAX dataclass into a mapping,
e.g. ``{f.name: np.asarray(getattr(obj, f.name)) for f in
dataclasses.fields(obj)}`` (static metadata passes through as is).
"""
from __future__ import annotations

import dataclasses
from types import SimpleNamespace

import numpy as np
import torch

from .device import resolve_device
from .models.model import RobotModel, from_dict
from .ocp.problem import OcpConfig, StageData
from .ocp.reference import TargetTrajectories
from .sim.batched_rollout import RolloutCarry
from .sim.sim import SimConfig, SimState
from .sim.world import WorldMesh
from .solver.transcription import LqProblem, ProjectedLq
from .wbc.tasks import WbcData
from .wbc.wbc import WbcGains, WbcState


def _tensor_fields(cls, d, dtype, device):
    """The fields of ``cls`` found in ``d`` as tensors (plain values and None
    pass through); a field with a default may be absent from ``d``."""
    dev = resolve_device(device)
    out = {}
    for f in dataclasses.fields(cls):
        if f.name not in d:
            continue
        v = d[f.name]
        if v is None or isinstance(v, (bool, int, float, str, tuple)):
            out[f.name] = v
        else:
            out[f.name] = torch.tensor(np.asarray(v), dtype=dtype, device=dev)
    return out


def robot_model_from_numpy(d, device=None, dtype=torch.float64) -> RobotModel:
    """RobotModel from the JAX model's fields (or the asset's dict)."""
    return from_dict(d, dtype=dtype, device=device)


def ocp_config_from_numpy(d, device=None, dtype=torch.float64) -> OcpConfig:
    """OcpConfig from the JAX OcpConfig's fields (the 30- or 36-input
    problem, ``arm_locked`` or not, ``self_collision_{mu,delta,margin}``)."""
    return OcpConfig(**_tensor_fields(OcpConfig, d, dtype, device))


def stage_data_from_numpy(d, device=None, dtype=torch.float64) -> StageData:
    """StageData from the JAX StageData's fields (with ``grasp_flags`` on the
    force-tracking problem; a leading scenario axis passes through)."""
    return StageData(**_tensor_fields(StageData, d, dtype, device))


def target_trajectories_from_numpy(d, device=None, dtype=torch.float64) -> TargetTrajectories:
    return TargetTrajectories(**_tensor_fields(TargetTrajectories, d, dtype, device))


def lq_from_numpy(d, device=None, dtype=torch.float64) -> LqProblem:
    """LqProblem from the JAX LqProblem's fields (any leading batch dims)."""
    return LqProblem(**_tensor_fields(LqProblem, d, dtype, device))


def projected_lq_from_numpy(d, device=None, dtype=torch.float64) -> ProjectedLq:
    """ProjectedLq from the JAX ProjectedLq's fields: the structured recovery
    of the batch-major path (``P``, ``Px_v``, ``force_mask``, and
    ``grasp_gate`` at nu = 36) or the dense ``Pu`` / ``Px`` of the
    per-scenario path; the fields a form does not use may be None."""
    fields = {f.name: d.get(f.name) for f in dataclasses.fields(ProjectedLq)}
    return ProjectedLq(**_tensor_fields(ProjectedLq, fields, dtype, device))


def wbc_gains_from_numpy(d, device=None, dtype=torch.float64) -> WbcGains:
    """WbcGains from the fields of the JAX WbcGains or of config.WbcSettings."""
    fields = {k: np.array(v) if isinstance(v, np.ndarray) else v for k, v in d.items()}
    return WbcGains.from_settings(SimpleNamespace(**fields), dtype=dtype,
                                  device=resolve_device(device))


def wbc_state_from_numpy(d, device=None, dtype=torch.float64) -> WbcState:
    """WbcState from the JAX WbcState's fields (``input_last``, any leading
    batch dims)."""
    return WbcState(**_tensor_fields(WbcState, d, dtype, device))


def wbc_data_from_numpy(d, device=None, dtype=torch.float64) -> WbcData:
    """WbcData from the JAX WbcData's fields (any leading batch dims), so
    the port's task functions can take the JAX package's data."""
    return WbcData(**_tensor_fields(WbcData, d, dtype, device))


def sim_config_from_numpy(d) -> SimConfig:
    """SimConfig from the JAX SimConfig (a NamedTuple, passed through by
    field) or a mapping of its fields."""
    return SimConfig(**(d._asdict() if hasattr(d, "_asdict") else d))


def sim_state_from_numpy(d, device=None, dtype=torch.float64) -> SimState:
    """SimState from a JAX SimState batch's fields (leading B on each); the
    ring index becomes int64."""
    dev = resolve_device(device)
    out = _tensor_fields(SimState, d, dtype, device)
    out["buf_head"] = torch.tensor(np.asarray(d["buf_head"]), dtype=torch.int64, device=dev)
    return SimState(**out)


def rollout_carry_from_numpy(d, device=None, dtype=torch.float64) -> RolloutCarry:
    """RolloutCarry from a JAX RolloutCarry's fields, its ``sim`` a mapping
    of the SimState's fields; ``alive`` stays bool."""
    dev = resolve_device(device)
    out = _tensor_fields(RolloutCarry, {k: v for k, v in d.items() if k != "sim"}, dtype,
                         device)
    out["alive"] = torch.tensor(np.asarray(d["alive"]), dtype=torch.bool, device=dev)
    return RolloutCarry(sim=sim_state_from_numpy(d["sim"], device, dtype), **out)


def world_mesh_from_numpy(d, device=None, dtype=torch.float64) -> WorldMesh:
    """WorldMesh from the JAX WorldMesh (a NamedTuple) or a mapping of its
    fields."""
    d = d._asdict() if hasattr(d, "_asdict") else d
    dev = resolve_device(device)
    return WorldMesh(**{k: torch.tensor(np.asarray(d[k]), dtype=dtype, device=dev)
                        for k in WorldMesh._fields})
