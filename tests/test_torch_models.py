"""Torch port's model core against the JAX package: the same numpy inputs
through both, in float64 on the CPU, at rtol = atol = 1e-10."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qm_door_torch import convert
from qm_door_torch.models import centroidal as t_cen
from qm_door_torch.models import dynamics as t_dyn
from qm_door_torch.models import kinematics as t_kin
from qm_door_torch.models import spatial as t_sp
from qm_door_torch.models.model import aliengo_z1 as t_aliengo_z1
from qm_door_tpu.models import aliengo_z1 as j_aliengo_z1
from qm_door_tpu.models import centroidal as j_cen
from qm_door_tpu.models import dynamics as j_dyn
from qm_door_tpu.models import kinematics as j_kin
from qm_door_tpu.models import spatial as j_sp
from torch_parity import F64, as_numpy_fields, to_np
from torch_parity import release_jax_executables  # noqa: F401 (autouse, module scope)

TOL = dict(rtol=1e-10, atol=1e-10)
NB = 5  # samples per check


@pytest.fixture(scope="module")
def models():
    return j_aliengo_z1(dtype=jnp.float64), t_aliengo_z1(dtype=F64, device="cpu")


def _close(t_out, j_out):
    if isinstance(j_out, (tuple, list)):
        assert len(t_out) == len(j_out)
        for a, b in zip(t_out, j_out):
            _close(a, b)
        return
    np.testing.assert_allclose(to_np(t_out), np.asarray(j_out), **TOL)


def _q(seed, n=NB):
    return np.random.default_rng(seed).normal(size=(n, 24)) * 0.5


def _xu(seed, n=NB):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 30)) * 0.3
    x[:, 8] += 0.4
    u = rng.normal(size=(n, 30))
    u[:, 0:12] = rng.normal(size=(n, 12)) * 20.0 + np.tile([0.0, 0.0, 80.0], 4)
    return x, u


def test_model_fields_match_jax(models):
    jm, tm = models
    for name in ("joint_rot", "joint_trans", "joint_axis", "body_mass", "body_com",
                 "body_inertia", "frame_rot", "frame_trans", "effort_limit",
                 "velocity_limit", "pos_lower", "pos_upper"):
        np.testing.assert_array_equal(to_np(getattr(tm, name)), np.asarray(getattr(jm, name)))
    for name in ("joint_parent", "frame_names", "frame_parent", "contact_frame_ids",
                 "ee_frame_id", "base_frame_id"):
        assert tuple(np.atleast_1d(getattr(tm, name))) == \
            tuple(np.atleast_1d(getattr(jm, name))), name


def test_robot_model_from_numpy_carries_the_jax_model(models):
    jm, tm = models
    conv = convert.robot_model_from_numpy(as_numpy_fields(jm), device="cpu")
    for f in dataclasses.fields(tm):
        a, b = getattr(conv, f.name), getattr(tm, f.name)
        if isinstance(b, torch.Tensor):
            assert a.dtype == F64 and torch.equal(a, b), f.name
        else:
            assert a == b, f.name


def test_model_to_casts_tensors_and_keeps_metadata(models):
    _, tm = models
    m32 = tm.to(dtype=torch.float32)
    assert m32.dtype == torch.float32 and m32.joint_rot.dtype == torch.float32
    assert m32.joint_parent == tm.joint_parent and m32.ee_frame_id == tm.ee_frame_id
    assert tm.dtype == F64


def test_entry_point_without_cuda_raises(monkeypatch):
    """device=None means CUDA: without CUDA it raises, never falls back."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        t_aliengo_z1()
    with pytest.raises(RuntimeError, match="CUDA"):
        t_aliengo_z1(device="cuda")
    assert t_aliengo_z1(device="cpu").device.type == "cpu"


def _spatial_cases():
    rng = np.random.default_rng(11)
    zyx = rng.uniform(-1.0, 1.0, size=(NB, 3))
    v3 = rng.normal(size=(NB, 3))
    M3 = rng.normal(size=(NB, 3, 3)) + 3 * np.eye(3)
    A6 = rng.normal(size=(NB, 6, 6)) * 0.3 + 4 * np.eye(6)
    rhs6 = rng.normal(size=(NB, 6, 4))
    quats = rng.normal(size=(NB, 4))
    quats /= np.linalg.norm(quats, axis=-1, keepdims=True)
    quats2 = rng.normal(size=(NB, 4))
    quats2 /= np.linalg.norm(quats2, axis=-1, keepdims=True)
    t = rng.uniform(size=(NB, 1))
    # rotations spanning every Shepperd branch (trace and each diagonal pivot)
    Rs = np.stack([np.eye(3), np.diag([1.0, -1.0, -1.0]), np.diag([-1.0, 1.0, -1.0]),
                   np.diag([-1.0, -1.0, 1.0]), np.asarray(j_sp.zyx_to_rot(jnp.asarray(zyx[0])))])
    return {
        "fmm": (M3, M3 + 1.0),
        "fmv": (M3, v3),
        "inv3": (M3,),
        "solve6_block": (A6, rhs6),
        "skew": (v3,),
        "rot_x": (zyx[:, 0],),
        "rot_y": (zyx[:, 1],),
        "rot_z": (zyx[:, 2],),
        "rpy_to_rot": (zyx,),
        "zyx_to_rot": (zyx,),
        "rot_to_zyx": (np.asarray(j_sp.zyx_to_rot(jnp.asarray(zyx))),),
        "zyx_rates_to_world_angvel_matrix": (zyx,),
        "world_angvel_to_zyx_rates": (zyx, v3),
        "zyx_rates_to_world_angvel": (zyx, v3),
        "quat_to_rot": (quats,),
        "rot_to_quat": (Rs,),
        "quat_slerp": (quats, quats2, t),
        "quat_error_ocs2": (quats, quats2),
    }


@pytest.mark.parametrize("name", sorted(_spatial_cases()))
def test_spatial_matches_jax(name):
    args = _spatial_cases()[name]
    j_out = getattr(j_sp, name)(*[jnp.asarray(a) for a in args])
    t_out = getattr(t_sp, name)(*[torch.as_tensor(a, dtype=F64) for a in args])
    _close(t_out, j_out)


def test_spatial_solve6_block_vector_rhs():
    rng = np.random.default_rng(2)
    A6 = rng.normal(size=(NB, 6, 6)) * 0.3 + 4 * np.eye(6)
    b = rng.normal(size=(NB, 6))
    t_out = t_sp.solve6_block(torch.as_tensor(A6), torch.as_tensor(b))
    np.testing.assert_allclose(np.einsum("bij,bj->bi", A6, to_np(t_out)), b, **TOL)


def _kin_cases(jm, tm):
    fids = tuple(jm.contact_frame_ids) + (jm.ee_frame_id,)
    return {
        "fk": (lambda q: j_kin.fk(jm, q), lambda q: t_kin.fk(tm, q)),
        "joint_world_axes": (lambda q: j_kin.joint_world_axes(jm, q)[:2],
                             lambda q: t_kin.joint_world_axes(tm, q)[:2]),
        "frame_placements": (lambda q: j_kin.frame_placements(jm, q),
                             lambda q: t_kin.frame_placements(tm, q)),
        "frame_jacobians_all": (lambda q: j_kin.frame_jacobians(jm, q),
                                lambda q: t_kin.frame_jacobians(tm, q)),
        "frame_jacobians_feet_ee": (lambda q: j_kin.frame_jacobians(jm, q, fids),
                                    lambda q: t_kin.frame_jacobians(tm, q, fids)),
        "point_jacobian": (lambda q: j_kin.point_jacobian(jm, q, 9, q[0:3] + 0.1),
                           lambda q: t_kin.point_jacobian(tm, q, 9, q[..., 0:3] + 0.1)),
        "contact_positions": (lambda q: j_kin.contact_positions(jm, q),
                              lambda q: t_kin.contact_positions(tm, q)),
        "ee_pose": (lambda q: j_kin.ee_pose(jm, q), lambda q: t_kin.ee_pose(tm, q)),
        "com_position": (lambda q: j_dyn.com_position(jm, q),
                         lambda q: t_dyn.com_position(tm, q)),
        "centroidal_momentum_matrix": (lambda q: j_dyn.centroidal_momentum_matrix(jm, q),
                                       lambda q: t_dyn.centroidal_momentum_matrix(tm, q)),
        "body_com_kinematics": (lambda q: j_dyn.body_com_kinematics(jm, q),
                                lambda q: t_dyn.body_com_kinematics(tm, q)),
    }


@pytest.mark.parametrize("name", [
    "fk", "joint_world_axes", "frame_placements", "frame_jacobians_all",
    "frame_jacobians_feet_ee", "point_jacobian", "contact_positions", "ee_pose",
    "com_position", "centroidal_momentum_matrix", "body_com_kinematics"])
def test_kinematics_dynamics_match_jax(models, name):
    """Batched torch call (leading batch dim) against the vmapped JAX function."""
    jm, tm = models
    j_fn, t_fn = _kin_cases(jm, tm)[name]
    q = _q(sum(map(ord, name)))
    _close(t_fn(torch.as_tensor(q)), jax.jit(jax.vmap(j_fn))(jnp.asarray(q)))


def test_static_tables_match_jax(models):
    jm, tm = models
    jp = tuple(jm.joint_parent)
    np.testing.assert_array_equal(t_kin._ancestor_mask(tm.joint_parent),
                                  j_kin._ancestor_mask_cached(jp))
    np.testing.assert_array_equal(t_dyn._subtree_table(tm.joint_parent),
                                  j_dyn._subtree_table(jp))
    assert t_dyn._reverse_topological(tm.joint_parent) == j_dyn._reverse_topological(jp)
    with pytest.raises(ValueError):
        t_dyn._reverse_topological((0, 2, 1))


def _cen_cases(jm, tm):
    return {
        "base_velocity": (lambda x, u: j_cen.base_velocity(jm, x, u),
                          lambda x, u: t_cen.base_velocity(tm, x, u)),
        "pinocchio_v": (lambda x, u: j_cen.pinocchio_v(jm, x, u),
                        lambda x, u: t_cen.pinocchio_v(tm, x, u)),
        "flow_map": (lambda x, u: j_cen.flow_map(jm, x, u),
                     lambda x, u: t_cen.flow_map(tm, x, u)),
        "flow_map_any": (lambda x, u: j_cen.flow_map_any(jm, x, u),
                         lambda x, u: t_cen.flow_map_any(tm, x, u)),
    }


@pytest.mark.parametrize("name", ["base_velocity", "pinocchio_v", "flow_map", "flow_map_any"])
def test_centroidal_matches_jax(models, name):
    jm, tm = models
    j_fn, t_fn = _cen_cases(jm, tm)[name]
    x, u = _xu(sum(map(ord, name)))
    _close(t_fn(torch.as_tensor(x), torch.as_tensor(u)),
           jax.jit(jax.vmap(j_fn))(jnp.asarray(x), jnp.asarray(u)))


def test_flow_map_under_torch_vmap(models):
    """The per-sample form under torch.func.vmap gives the batched result."""
    _, tm = models
    x, u = (torch.as_tensor(a) for a in _xu(4))
    np.testing.assert_allclose(
        to_np(torch.func.vmap(lambda a, b: t_cen.flow_map(tm, a, b))(x, u)),
        to_np(t_cen.flow_map(tm, x, u)), **TOL)


def test_weight_compensating_input_matches_jax(models):
    jm, tm = models
    from qm_door_tpu.ocp.gait import mode_to_flags

    flags = mode_to_flags(np.arange(16))                          # every mode
    j_out = np.stack([np.asarray(j_cen.weight_compensating_input(jm, f)) for f in flags])
    _close(t_cen.weight_compensating_input(tm, torch.as_tensor(flags)), j_out)
