"""RobotModel: the fixed-size constants every model function consumes
(port of qm_door_tpu/models/model.py).

The generalized-coordinate layout matches the reference's OCS2 centroidal
model:

  q (24) = [ base position world (3);
             base ZYX euler (yaw, pitch, roll) (3);
             leg joints LF,LH,RF,RH x (HAA,HFE,KFE) (12);
             arm joints z1_joint_1..6 (6) ]
  v (24) = [ base linear velocity world (3);
             ZYX euler rates (3);
             joint velocities (18) ]

Contact (foot) ordering is LF, RF, LH, RH (OCS2 ``contactNames3DoF``).
The static metadata stays Python tuples; the numeric fields are tensors on
one device in one dtype.
"""
from __future__ import annotations

import dataclasses
import json
import os
from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

from ..device import resolve_device

JOINT_NAMES = (
    "LF_HAA", "LF_HFE", "LF_KFE",
    "LH_HAA", "LH_HFE", "LH_KFE",
    "RF_HAA", "RF_HFE", "RF_KFE",
    "RH_HAA", "RH_HFE", "RH_KFE",
    "z1_joint_1", "z1_joint_2", "z1_joint_3",
    "z1_joint_4", "z1_joint_5", "z1_joint_6",
)

CONTACT_FRAMES = ("LF_FOOT", "RF_FOOT", "LH_FOOT", "RH_FOOT")
EE_FRAME = "z1_end_effector"
BASE_FRAME = "base"

NUM_JOINTS = 18
NQ = 24
NV = 24
NUM_CONTACTS = 4
STATE_DIM = 30  # [h_com/m (6); base pose (6); joints (18)]
INPUT_DIM = 30  # [contact forces (12); joint velocities (18)]
GRAVITY = 9.81

_STATIC = ("name", "joint_names", "joint_parent", "frame_names", "frame_parent",
           "contact_frame_ids", "ee_frame_id", "base_frame_id")


@dataclass(frozen=True)
class RobotModel:
    # --- static metadata ---
    name: str
    joint_names: Tuple[str, ...]
    joint_parent: Tuple[int, ...]      # body idx, 0 = base
    frame_names: Tuple[str, ...]
    frame_parent: Tuple[int, ...]
    contact_frame_ids: Tuple[int, ...]
    ee_frame_id: int
    base_frame_id: int

    # --- tensors ---
    joint_rot: torch.Tensor      # (18,3,3) joint frame rotation in parent body frame
    joint_trans: torch.Tensor    # (18,3)
    joint_axis: torch.Tensor     # (18,3) unit axis in joint frame
    body_mass: torch.Tensor      # (19,)  0 = base
    body_com: torch.Tensor       # (19,3) in body frame
    body_inertia: torch.Tensor   # (19,3,3) about body com, body frame
    frame_rot: torch.Tensor      # (F,3,3) in parent body frame
    frame_trans: torch.Tensor    # (F,3)
    effort_limit: torch.Tensor   # (18,)
    velocity_limit: torch.Tensor
    pos_lower: torch.Tensor
    pos_upper: torch.Tensor

    @property
    def nj(self) -> int:
        return len(self.joint_names)

    @property
    def total_mass(self):
        return torch.sum(self.body_mass)

    @property
    def dtype(self) -> torch.dtype:
        return self.body_mass.dtype

    @property
    def device(self) -> torch.device:
        return self.body_mass.device

    def to(self, device=None, dtype=None) -> "RobotModel":
        """Copy with every tensor moved to ``device`` and cast to ``dtype``."""
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name).to(device=device, dtype=dtype)
            for f in dataclasses.fields(self) if f.name not in _STATIC})


def from_dict(d, dtype=torch.float32, device=None) -> RobotModel:
    """Model from the asset's dict (or any mapping of the same fields).
    ``device=None`` means CUDA (see device.resolve_device)."""
    dev = resolve_device(device)
    frame_names = tuple(d["frame_names"])
    arrays = {
        f.name: torch.tensor(np.asarray(d[f.name]), dtype=dtype, device=dev)
        for f in dataclasses.fields(RobotModel) if f.name not in _STATIC
    }
    return RobotModel(
        name=d["name"],
        joint_names=tuple(d["joint_names"]),
        joint_parent=tuple(int(i) for i in d["joint_parent"]),
        frame_names=frame_names,
        frame_parent=tuple(int(i) for i in d["frame_parent"]),
        contact_frame_ids=tuple(frame_names.index(f) for f in CONTACT_FRAMES),
        ee_frame_id=frame_names.index(EE_FRAME) if EE_FRAME in frame_names else -1,
        base_frame_id=frame_names.index(BASE_FRAME) if BASE_FRAME in frame_names else -1,
        **arrays,
    )


def load_model(path, dtype=torch.float32, device=None) -> RobotModel:
    with open(path) as f:
        return from_dict(json.load(f), dtype=dtype, device=device)


_ASSET = os.path.join(os.path.dirname(__file__), "..", "assets", "aliengo_z1.json")


def aliengo_z1(dtype=torch.float32, device=None) -> RobotModel:
    """The flagship AlienGo + Z1 quadruped-manipulator model."""
    return load_model(_ASSET, dtype=dtype, device=device)
