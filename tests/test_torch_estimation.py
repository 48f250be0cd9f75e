"""The estimation layer, torch port (qm_door_torch/estimation) against the
JAX package (qm_door_tpu/estimation) on the CPU in float64, on
tests/test_estimation.py's cases: mode_from_flags, assemble_rbd,
imu_from_state, GroundTruthEstimate, kf_init, kf_step with the slip gate on
and off, and one KalmanFilterEstimate sequence of 20 updates (a nonzero
initial yaw, changing contact flags and per-foot terrain heights).

Tolerance: 1e-10 (rtol = atol) for the closed-form functions, 1e-9 for the
filter steps (a 28 x 28 solve a step)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qm_door_torch.estimation import base as t_base
from qm_door_torch.estimation import kalman as t_kf
from qm_door_torch.models.model import aliengo_z1 as t_aliengo_z1
from qm_door_torch.sim import sim as t_sim
from qm_door_tpu.config import default_config
from qm_door_tpu.estimation import base as j_base
from qm_door_tpu.estimation import kalman as j_kf
from qm_door_tpu.models import aliengo_z1 as j_aliengo_z1
from qm_door_tpu.models import centroidal as j_cen
from qm_door_tpu.models import kinematics as j_kin
from qm_door_tpu.sim import sim as j_sim_mod
from torch_parity import F64, to_np
from torch_parity import release_jax_executables  # noqa: F401 (autouse, module scope)

TOL = dict(rtol=1e-10, atol=1e-10)
STEP_TOL = dict(rtol=1e-9, atol=1e-9)


@pytest.fixture(scope="module")
def models():
    return j_aliengo_z1(dtype=jnp.float64), t_aliengo_z1(dtype=F64, device="cpu")


def _t(a):
    return torch.tensor(np.asarray(a), dtype=F64)


def _close(out, ref, what, tol=TOL):
    np.testing.assert_allclose(to_np(out), np.asarray(ref), err_msg=what, **tol)


def _stance_q0(jm):
    """The nominal pose with its feet on the ground (test_estimation's)."""
    q0 = j_cen.pinocchio_q(jnp.asarray(default_config().initial_state()))
    feet_z = float(jnp.mean(j_kin.contact_positions(jm, q0)[:, 2]))
    return np.array(q0.at[2].add(-feet_z))


@pytest.mark.parametrize("flags, mode", [((1.0, 1, 1, 1), 15), ((0.0, 0, 0, 0), 0),
                                         ((1.0, 0, 0, 1), 9), ((0.0, 1, 1, 0), 6)])
def test_mode_from_flags(flags, mode):
    out = t_base.mode_from_flags(torch.tensor(flags))
    assert int(out) == mode == int(j_base.mode_from_flags(jnp.asarray(flags)))
    assert out.dtype == torch.int32


def test_assemble_rbd_imu_and_ground_truth_match_jax(models):
    """assemble_rbd, imu_from_state and GroundTruthEstimate (update and
    update_from_sim) at a perturbed pose with random velocities, against
    JAX: 1e-10."""
    jm, tm = models
    rng = np.random.default_rng(3)
    q = _stance_q0(jm) + 0.05 * rng.normal(size=24)
    v = 0.1 * rng.normal(size=24)
    a_w = rng.normal(size=3)
    j_imu = j_base.imu_from_state(jm, jnp.asarray(q), jnp.asarray(v), jnp.asarray(a_w))
    t_imu = t_base.imu_from_state(tm, _t(q), _t(v), _t(a_w))
    for name, a, b in zip(("zyx", "omega_world", "acc_body"), t_imu, j_imu):
        _close(a, b, f"imu_from_state.{name}")
    zyx, omega_w = np.asarray(j_imu[0]), np.asarray(j_imu[1])
    args = (zyx, q[0:3], omega_w, v[0:3], q[6:24], v[6:24])
    ref = j_base.assemble_rbd(jm, *(jnp.asarray(a) for a in args))
    _close(t_base.assemble_rbd(tm, *(_t(a) for a in args)), ref, "assemble_rbd")
    _close(t_base.GroundTruthEstimate(tm).update(*(_t(a) for a in args)), ref,
           "GroundTruthEstimate.update")
    j_sim = j_base.GroundTruthEstimate(jm).update_from_sim(
        j_sim_mod.sim_init(jm, jnp.asarray(q), jnp.asarray(v)))
    t_state = t_sim.sim_init(tm, _t(q)[None], _t(v)[None])
    _close(t_base.GroundTruthEstimate(tm).update_from_sim(t_state)[0], j_sim,
           "GroundTruthEstimate.update_from_sim")


def _slide_inputs(jm):
    """test_kf_slip_gate_rejects_sliding_foot's inputs: the base standing
    still, LF's encoders reporting a 0.3 m/s slide in +x."""
    q0 = _stance_q0(jm)
    J_lf = j_kin.frame_jacobians(jm, jnp.asarray(q0), jm.contact_frame_ids)[0, :3, 6:9]
    vj_leg = jnp.linalg.lstsq(J_lf, jnp.array([0.3, 0.0, 0.0]))[0]
    vj = np.zeros(18)
    vj[0:3] = np.asarray(vj_leg)
    zyx, omega_w, acc = (np.asarray(a) for a in j_base.imu_from_state(
        jm, jnp.asarray(q0), jnp.zeros(24), jnp.zeros(3)))
    return q0, vj, zyx, omega_w, acc


@pytest.mark.parametrize("gate", ["off", "on"])
def test_kf_init_and_steps_match_jax(models, gate):
    """kf_init, then 5 kf_steps (flags alternating stance and a trot pair,
    terrain height a number, then per foot) on the sliding-foot inputs,
    with the slip gate off (the default) and on (0.15, 200): the state and
    the rbd of every step against JAX's at 1e-9."""
    jm, tm = models
    params = dict(slip_gate=0.15, slip_inflation=200.0) if gate == "on" else {}
    jp, tp = j_kf.KfParams(**params), t_kf.KfParams(**params)
    q0, vj, zyx, omega_w, acc = _slide_inputs(jm)
    js, ts = j_kf.kf_init(jm, jnp.asarray(q0), jp), t_kf.kf_init(tm, _t(q0), tp)
    _close(ts.xe, js.xe, "kf_init.xe")
    _close(ts.P, js.P, "kf_init.P")
    rng = np.random.default_rng(7)
    for k in range(5):
        flags = np.array([1.0, 1, 1, 1]) if k % 2 == 0 else np.array([1.0, 0, 0, 1])
        th = 0.01 * k if k < 3 else 0.01 * rng.normal(size=4)
        qj = q0[6:24] + 0.01 * rng.normal(size=18)
        args = (zyx + 0.01 * rng.normal(size=3), omega_w + 0.05 * rng.normal(size=3),
                acc + 0.2 * rng.normal(size=3), qj, vj, flags)
        js, jrbd = j_kf.kf_step(jm, jp, js, *(jnp.asarray(a) for a in args), 0.002,
                                terrain_height=jnp.asarray(th))
        ts, trbd = t_kf.kf_step(tm, tp, ts, *(_t(a) for a in args), 0.002,
                                terrain_height=th)
        for name, a, b in (("xe", ts.xe, js.xe), ("P", ts.P, js.P), ("rbd", trbd, jrbd)):
            _close(a, b, f"kf_step {k}: {name}", STEP_TOL)
    if gate == "on":  # the gate acted: the sliding foot's innovation is past it
        assert float(torch.linalg.norm(ts.xe[3:6])) < 0.05


def test_kalman_filter_estimate_sequence_matches_jax(models):
    """KalmanFilterEstimate (reset at a pose with yaw 0.7, then 20 updates
    of a slowly moving robot: flags switching every 5 updates, per-foot
    terrain heights) against JAX's: every rbd and the final state at
    1e-9."""
    jm, tm = models
    rng = np.random.default_rng(11)
    q0 = _stance_q0(jm)
    q0[3] = 0.7
    j_est, t_est = j_kf.KalmanFilterEstimate(jm), t_kf.KalmanFilterEstimate(tm)
    j_est.reset(jnp.asarray(q0))
    t_est.reset(_t(q0))
    q, v = q0.copy(), np.zeros(24)
    for k in range(20):
        a_w = 0.3 * rng.normal(size=3)
        v[0:3] += 0.002 * a_w
        v[3:24] = 0.05 * rng.normal(size=21)
        q = q + 0.002 * v
        imu = [np.asarray(a) for a in j_base.imu_from_state(
            jm, jnp.asarray(q), jnp.asarray(v), jnp.asarray(a_w))]
        flags = np.array([1.0, 1, 1, 1]) if (k // 5) % 2 == 0 else np.array([0.0, 1, 1, 0])
        th = 0.005 * rng.normal(size=4)
        args = (*imu, q[6:24], v[6:24], flags)
        jrbd = j_est.update(*(jnp.asarray(a) for a in args), 0.002, terrain_height=th)
        trbd = t_est.update(*(_t(a) for a in args), 0.002, terrain_height=_t(th))
        _close(trbd, jrbd, f"KalmanFilterEstimate.update {k}", STEP_TOL)
    _close(t_est.state.xe, j_est.state.xe, "state.xe", STEP_TOL)
    _close(t_est.state.P, j_est.state.P, "state.P", STEP_TOL)
