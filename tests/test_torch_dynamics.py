"""The model core the whole-body controller needs, torch port against the JAX
package: the quaternion and log helpers, the angular acceleration from
Euler rates, frame Jacobian rates and velocities, the mass matrix,
nonlinear effects and the rest of models/dynamics.py, and the rbd state
conversions. The same numpy inputs go through both, in float64 on the CPU,
at rtol = atol = 1e-10."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

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
from torch_parity import F64, to_np
from torch_parity import release_jax_executables  # noqa: F401 (autouse, module scope)

TOL = dict(rtol=1e-10, atol=1e-10)
NB = 4  # samples per check


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


def _unit(a):
    return a / np.linalg.norm(a, axis=-1, keepdims=True)


def _spatial_cases():
    rng = np.random.default_rng(21)
    zyx = rng.uniform(-1.0, 1.0, size=(NB, 3))
    quats = _unit(rng.normal(size=(NB, 4)))
    quats2 = _unit(rng.normal(size=(NB, 4)))
    # w < 0, the identity (|v| < 1e-9) and a tiny rotation
    quats[1, 3] = -abs(quats[1, 3])
    quats[2] = (0.0, 0.0, 0.0, 1.0)
    quats[3] = _unit(np.array([1e-11, 0.0, 0.0, 1.0]))
    Rs = np.stack([np.asarray(j_sp.zyx_to_rot(jnp.asarray(z))) for z in zyx])
    Rs[1] = np.diag([1.0, -1.0, -1.0])  # a half turn: rot_to_quat's x pivot
    Rs2 = np.stack([np.asarray(j_sp.zyx_to_rot(jnp.asarray(z) * 0.5)) for z in zyx[::-1]])
    return {
        "quat_mul": (quats, quats2),
        "quat_conj": (quats,),
        "quat_log3": (quats,),
        "log3": (Rs,),
        "quat_distance": (quats, quats2),
        "rotation_error_world": (Rs2, Rs),
        "world_angacc_from_zyx": (zyx, rng.normal(size=(NB, 3)), rng.normal(size=(NB, 3))),
    }


@pytest.mark.parametrize("name", sorted(_spatial_cases()))
def test_spatial_matches_jax(name):
    args = _spatial_cases()[name]
    j_fn = getattr(j_sp, name)
    j_out = jax.vmap(j_fn)(*[jnp.asarray(a) for a in args])
    t_out = getattr(t_sp, name)(*[torch.as_tensor(a, dtype=F64) for a in args])
    _close(t_out, j_out)


def _qv(seed, n=NB):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(n, 24)) * 0.5, rng.normal(size=(n, 24))


def _dyn_cases(jm, tm):
    fids = tuple(jm.contact_frame_ids) + (jm.ee_frame_id, jm.base_frame_id)
    return {
        "frame_jacobians_dot": (lambda q, v: j_kin.frame_jacobians_dot(jm, q, v, fids),
                                lambda q, v: t_kin.frame_jacobians_dot(tm, q, v, fids)),
        "frame_jacobians_dot_all": (lambda q, v: j_kin.frame_jacobians_dot(jm, q, v),
                                    lambda q, v: t_kin.frame_jacobians_dot(tm, q, v)),
        "frame_velocities": (lambda q, v: j_kin.frame_velocities(jm, q, v, fids),
                             lambda q, v: t_kin.frame_velocities(tm, q, v, fids)),
        "mass_matrix": (lambda q, v: j_dyn.mass_matrix(jm, q),
                        lambda q, v: t_dyn.mass_matrix(tm, q)),
        "potential_energy": (lambda q, v: j_dyn.potential_energy(jm, q),
                             lambda q, v: t_dyn.potential_energy(tm, q)),
        "gravity_vector": (lambda q, v: j_dyn.gravity_vector(jm, q),
                           lambda q, v: t_dyn.gravity_vector(tm, q)),
        "centroidal_momentum_matrix_dot": (
            lambda q, v: j_dyn.centroidal_momentum_matrix_dot(jm, q, v),
            lambda q, v: t_dyn.centroidal_momentum_matrix_dot(tm, q, v)),
        "centroidal_momentum": (lambda q, v: j_dyn.centroidal_momentum(jm, q, v),
                                lambda q, v: t_dyn.centroidal_momentum(tm, q, v)),
        "kinetic_energy": (lambda q, v: j_dyn.kinetic_energy(jm, q, v),
                           lambda q, v: t_dyn.kinetic_energy(tm, q, v)),
        "rbd_from_generalized": (lambda q, v: j_cen.rbd_from_generalized(jm, q, v),
                                 lambda q, v: t_cen.rbd_from_generalized(tm, q, v)),
    }


@pytest.mark.parametrize("name", sorted(_dyn_cases(j_aliengo_z1(dtype=jnp.float64),
                                                   t_aliengo_z1(dtype=F64, device="cpu"))))
def test_dynamics_match_jax(models, name):
    """Batched torch call (leading batch dim) against the vmapped JAX function."""
    jm, tm = models
    j_fn, t_fn = _dyn_cases(jm, tm)[name]
    q, v = _qv(sum(map(ord, name)))
    jq, jv = jnp.asarray(q), jnp.asarray(v)
    _close(t_fn(torch.as_tensor(q), torch.as_tensor(v)), jax.vmap(j_fn)(jq, jv))


def test_nonlinear_effects_and_inverse_forward_dynamics_match_jax(models):
    """nonlinear_effects against JAX's; inverse_dynamics and
    forward_dynamics against their JAX bodies, M a + h and
    solve(M, tau - h), on JAX's M and h (JAX's own jitted wrappers would
    compile the whole nonlinear-effects graph twice more)."""
    jm, tm = models
    q, v = _qv(17)
    a = np.random.default_rng(5).normal(size=(NB, 24))
    jq, jv = jnp.asarray(q), jnp.asarray(v)
    h = np.asarray(jax.vmap(lambda qq, vv: j_dyn.nonlinear_effects(jm, qq, vv))(jq, jv))
    M = np.asarray(jax.vmap(lambda qq: j_dyn.mass_matrix(jm, qq))(jq))
    tq, tv, ta = (torch.as_tensor(x) for x in (q, v, a))
    _close(t_dyn.nonlinear_effects(tm, tq, tv), h)
    _close(t_dyn.inverse_dynamics(tm, tq, tv, ta), np.einsum("bij,bj->bi", M, a) + h)
    _close(t_dyn.forward_dynamics(tm, tq, tv, ta),
           np.linalg.solve(M, (a - h)[..., None])[..., 0])


def test_nonlinear_effects_under_torch_vmap(models):
    """The per-sample form (jvp and vjp nested in torch.func.vmap) gives the
    batched result, and h(q, v) = Mdot v - dT/dq + g holds against the
    identity tau(q, v, 0) = h."""
    _, tm = models
    q, v = (torch.as_tensor(a) for a in _qv(9))
    h = t_dyn.nonlinear_effects(tm, q, v)
    np.testing.assert_allclose(
        to_np(torch.func.vmap(lambda a, b: t_dyn.nonlinear_effects(tm, a, b))(q, v)),
        to_np(h), **TOL)
    np.testing.assert_allclose(to_np(t_dyn.inverse_dynamics(tm, q, v, torch.zeros_like(v))),
                               to_np(h), **TOL)


def _rbd(seed, n=NB):
    rng = np.random.default_rng(seed)
    rbd = rng.normal(size=(n, 55)) * 0.3
    rbd[:, 5] += 0.4
    return rbd


@pytest.mark.parametrize("name", ["rbd_to_generalized", "centroidal_state_from_rbd"])
def test_rbd_conversions_match_jax(models, name):
    jm, tm = models
    rbd = _rbd(sum(map(ord, name)))
    if name == "rbd_to_generalized":
        j_out = jax.vmap(j_cen.rbd_to_generalized)(jnp.asarray(rbd))
        t_out = t_cen.rbd_to_generalized(torch.as_tensor(rbd))
    else:
        j_out = jax.vmap(lambda r: j_cen.centroidal_state_from_rbd(jm, r))(jnp.asarray(rbd))
        t_out = t_cen.centroidal_state_from_rbd(tm, torch.as_tensor(rbd))
    _close(t_out, j_out)


def test_rbd_round_trip(models):
    """rbd_from_generalized then rbd_to_generalized gives (q, v) back."""
    _, tm = models
    q, v = (torch.as_tensor(a) for a in _qv(13))
    q2, v2 = t_cen.rbd_to_generalized(t_cen.rbd_from_generalized(tm, q, v))
    np.testing.assert_allclose(to_np(q2), to_np(q), **TOL)
    np.testing.assert_allclose(to_np(v2), to_np(v), **TOL)
