"""The port's URDF compiler (qm_door_torch/models/urdf.py) against the JAX
package's on a small URDF written here: a root link, two revolute joints,
fixed joints whose children's inertias are merged into their actuated
ancestor, and named frames (the four feet, the end effector, the base).
The result is held key by key at 1e-12 and loads through
models/model.py:from_dict as a RobotModel."""
import json
import os

import numpy as np
import pytest
import torch

from qm_door_torch.models import model as t_model
from qm_door_torch.models import urdf as t_urdf
from qm_door_tpu.models import urdf as j_urdf
from torch_parity import F64, to_np

EXACT = dict(rtol=0.0, atol=1e-12)
ACTUATED = ["j1", "j2"]
FRAMES = ["base", "LF_FOOT", "RF_FOOT", "LH_FOOT", "RH_FOOT", "z1_end_effector"]

URDF = """<?xml version="1.0"?>
<robot name="two_link">
  <link name="base">
    <inertial>
      <origin xyz="0.01 -0.02 0.03" rpy="0.1 0.2 -0.3"/>
      <mass value="5.0"/>
      <inertia ixx="0.1" ixy="0.01" ixz="-0.02" iyy="0.2" iyz="0.005" izz="0.3"/>
    </inertial>
  </link>
  <link name="link1">
    <inertial>
      <origin xyz="0.0 0.0 -0.1"/>
      <mass value="1.5"/>
      <inertia ixx="0.02" iyy="0.02" izz="0.001"/>
    </inertial>
  </link>
  <link name="link2">
    <inertial>
      <origin xyz="0.05 0.0 -0.08" rpy="0.0 0.4 0.0"/>
      <mass value="0.8"/>
      <inertia ixx="0.01" ixy="0.001" iyy="0.012" izz="0.002"/>
    </inertial>
  </link>
  <link name="tip">
    <inertial>
      <origin xyz="0.0 0.01 -0.03"/>
      <mass value="0.3"/>
      <inertia ixx="0.0005" iyy="0.0004" izz="0.0002"/>
    </inertial>
  </link>
  <link name="LF_FOOT"/>
  <link name="RF_FOOT"/>
  <link name="LH_FOOT"/>
  <link name="RH_FOOT"/>
  <link name="z1_end_effector"/>
  <joint name="j1" type="revolute">
    <parent link="base"/>
    <child link="link1"/>
    <origin xyz="0.2 0.1 0.0" rpy="0.0 0.0 0.5"/>
    <axis xyz="0 1 1"/>
    <limit effort="30" velocity="12" lower="-1.2" upper="2.1"/>
  </joint>
  <joint name="j2" type="revolute">
    <parent link="link1"/>
    <child link="link2"/>
    <origin xyz="0.0 0.0 -0.25" rpy="0.3 0.0 0.0"/>
    <axis xyz="1 0 0"/>
    <limit effort="20" velocity="15" lower="-2.5" upper="0.5"/>
  </joint>
  <joint name="j2_tip" type="fixed">
    <parent link="link2"/>
    <child link="tip"/>
    <origin xyz="0.0 0.0 -0.2" rpy="0.0 -0.2 0.1"/>
  </joint>
  <joint name="lf" type="fixed"><parent link="link1"/><child link="LF_FOOT"/>
    <origin xyz="0.0 0.05 -0.3"/></joint>
  <joint name="rf" type="fixed"><parent link="link1"/><child link="RF_FOOT"/>
    <origin xyz="0.0 -0.05 -0.3"/></joint>
  <joint name="lh" type="fixed"><parent link="base"/><child link="LH_FOOT"/>
    <origin xyz="-0.2 0.1 -0.35"/></joint>
  <joint name="rh" type="continuous"><parent link="link2"/><child link="RH_FOOT"/>
    <origin xyz="0.0 -0.02 -0.25" rpy="0.0 0.0 0.7"/></joint>
  <joint name="ee" type="fixed"><parent link="tip"/><child link="z1_end_effector"/>
    <origin xyz="0.0 0.0 -0.05" rpy="0.2 0.0 0.0"/></joint>
</robot>
"""


@pytest.fixture
def urdf_path(tmp_path):
    path = tmp_path / "two_link.urdf"
    path.write_text(URDF)
    return str(path)


def _assert_same(ours, ref):
    assert list(ours) == list(ref)
    for key, value in ref.items():
        if isinstance(value, str) or (isinstance(value, list) and value
                                      and isinstance(value[0], str)):
            assert ours[key] == value, key
        else:
            np.testing.assert_allclose(np.asarray(ours[key], dtype=float),
                                       np.asarray(value, dtype=float), err_msg=key, **EXACT)


@pytest.mark.parametrize("root_link", [None, "base"])
def test_compile_urdf_matches_jax(urdf_path, root_link):
    ours = t_urdf.compile_urdf(urdf_path, ACTUATED, FRAMES, root_link=root_link)
    ref = j_urdf.compile_urdf(urdf_path, ACTUATED, FRAMES, root_link=root_link)
    _assert_same(ours, ref)
    json.dumps(ours)  # the dict is JSON as it stands


def test_fixed_children_merge_into_their_ancestor(urdf_path):
    out = t_urdf.compile_urdf(urdf_path, ACTUATED, FRAMES)
    np.testing.assert_allclose(out["body_mass"], [5.0, 1.5, 0.8 + 0.3], **EXACT)
    assert out["joint_parent"] == [0, 1]
    assert out["frame_parent"] == [0, 1, 1, 0, 2, 2]
    np.testing.assert_allclose(out["joint_axis"][0], np.array([0, 1, 1]) / np.sqrt(2), **EXACT)
    assert out["root_link"] == "base"


def test_a_compiled_urdf_loads_as_a_robot_model(urdf_path):
    out = t_urdf.compile_urdf(urdf_path, ACTUATED, FRAMES)
    asset = os.path.join(os.path.dirname(t_model.__file__), "..", "assets", "aliengo_z1.json")
    with open(asset) as f:
        assert sorted(out) == sorted(json.load(f))
    m = t_model.from_dict(out, dtype=F64, device="cpu")
    assert isinstance(m, t_model.RobotModel)
    assert m.nj == 2 and m.joint_names == ("j1", "j2") and m.frame_names == tuple(FRAMES)
    assert m.contact_frame_ids == (1, 2, 3, 4) and m.ee_frame_id == 5 and m.base_frame_id == 0
    for name in ("body_mass", "body_com", "body_inertia", "joint_rot", "frame_trans"):
        np.testing.assert_array_equal(to_np(getattr(m, name)), np.asarray(out[name]))
    assert getattr(m, "body_mass").dtype == torch.float64


@pytest.mark.parametrize("args,match", [
    ((["j1", "j9"], FRAMES), "actuated joints not found"),
    ((ACTUATED, FRAMES + ["nowhere"]), "frames not found"),
])
def test_errors_match_jax(urdf_path, args, match):
    for pkg in (t_urdf, j_urdf):
        with pytest.raises(ValueError, match=match):
            pkg.compile_urdf(urdf_path, *args)


def test_two_roots_are_refused(tmp_path):
    path = tmp_path / "two_roots.urdf"
    path.write_text(URDF.replace("</robot>", '  <link name="loose"/>\n</robot>'))
    for pkg in (t_urdf, j_urdf):
        with pytest.raises(ValueError, match="ambiguous root links"):
            pkg.compile_urdf(str(path), ACTUATED, FRAMES)


def test_helpers_match_jax():
    rng = np.random.default_rng(7)
    for _ in range(5):
        rpy = rng.uniform(-np.pi, np.pi, size=3)
        np.testing.assert_allclose(t_urdf._rpy_to_rot(rpy), j_urdf._rpy_to_rot(rpy), **EXACT)
        A, B = rng.normal(size=(2, 3, 3))
        bodies = (rng.uniform(0.1, 3.0), rng.normal(size=3), A @ A.T,
                  rng.uniform(0.1, 3.0), rng.normal(size=3), B @ B.T)
        for a, b in zip(t_urdf._merge_inertia(*bodies), j_urdf._merge_inertia(*bodies)):
            np.testing.assert_allclose(a, b, **EXACT)
    m, c, inertia = t_urdf._merge_inertia(0.0, np.zeros(3), np.zeros((3, 3)),
                                          0.0, np.ones(3), np.eye(3))
    assert m == 0.0 and not c.any() and not inertia.any()
