"""Torch port's OCP layer against the JAX package, float64 on the CPU:
penalties, constraints, gait/swing copies, targets, stage data, OCP config,
stage/terminal costs and their quadratization, trajectory evaluation — at
rtol = atol = 1e-10."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import vmap

from qm_door_torch import convert
from qm_door_torch.ocp import constraints as t_cons
from qm_door_torch.ocp import penalties as t_pen
from qm_door_torch.ocp import problem as t_prob
from qm_door_torch.ocp.gait import GAIT_LIBRARY as T_GAITS
from qm_door_torch.ocp.gait import GaitSchedule as TGaitSchedule
from qm_door_torch.ocp.reference import TargetTrajectories as TTargets
from qm_door_torch.ocp.swing import SwingConfig as TSwingConfig
from qm_door_torch.ocp.swing import compile_swing_references as t_swing
from qm_door_torch.solver.sqp import evaluate_trajectory as t_evaluate
from qm_door_tpu.ocp import constraints as j_cons
from qm_door_tpu.ocp import penalties as j_pen
from qm_door_tpu.ocp import problem as j_prob
from qm_door_tpu.ocp.gait import GAIT_LIBRARY as J_GAITS
from qm_door_tpu.ocp.gait import GaitSchedule as JGaitSchedule
from qm_door_tpu.ocp.reference import TargetTrajectories as JTargets
from qm_door_tpu.ocp.swing import SwingConfig as JSwingConfig
from qm_door_tpu.ocp.swing import compile_swing_references as j_swing
from qm_door_tpu.solver.sqp import evaluate_trajectory as j_evaluate
from torch_parity import F64, Problem, as_numpy_fields, to_np
from torch_parity import release_jax_executables  # noqa: F401 (autouse, module scope)

TOL = dict(rtol=1e-10, atol=1e-10)


def _close(t_out, j_out):
    if isinstance(j_out, (tuple, list)):
        for a, b in zip(t_out, j_out):
            _close(a, b)
        return
    np.testing.assert_allclose(to_np(t_out), np.asarray(j_out), **TOL)


@pytest.fixture(scope="module")
def P():
    return Problem(B=2, seed=7, x_scale=0.05)


@pytest.fixture(scope="module")
def nodes(P):
    """Per-node (x, u) with perturbed inputs so every cost term is active."""
    rng = np.random.default_rng(5)
    X = P.X[0] + rng.normal(size=P.X[0].shape) * 0.01
    U = P.U[0] + rng.normal(size=P.U[0].shape) * 1.0
    return X, U


@pytest.mark.parametrize("name", ["relaxed_barrier", "relaxed_barrier_d", "relaxed_barrier_dd"])
def test_relaxed_barrier_matches_jax(name):
    h = np.linspace(-1.0, 2.0, 41)
    _close(getattr(t_pen, name)(torch.as_tensor(h), 0.1, 0.3),
           getattr(j_pen, name)(jnp.asarray(h), 0.1, 0.3))


@pytest.mark.parametrize("name", ["box_barrier", "box_barrier_d", "box_barrier_dd"])
def test_box_barrier_matches_jax(name):
    z = np.linspace(-1.5, 1.5, 31)
    lo, hi = -np.ones(31), np.ones(31)
    _close(getattr(t_pen, name)(*(torch.as_tensor(a) for a in (z, lo, hi)), 0.1, 1e-3),
           getattr(j_pen, name)(*(jnp.asarray(a) for a in (z, lo, hi)), 0.1, 1e-3))
    assert float(t_pen.quadratic(torch.tensor(2.0), 3.0)) == float(j_pen.quadratic(2.0, 3.0))


def test_velocity_row_mask_and_rhs_match_jax():
    from qm_door_tpu.ocp.gait import mode_to_flags

    flags = mode_to_flags(np.arange(16))
    zref = np.random.default_rng(0).normal(size=(16, 4))
    _close(t_cons.velocity_row_mask(torch.as_tensor(flags)),
           j_cons.velocity_row_mask(jnp.asarray(flags)))
    _close(t_cons.velocity_rhs(torch.as_tensor(flags), torch.as_tensor(zref)),
           j_cons.velocity_rhs(jnp.asarray(flags), jnp.asarray(zref)))


@pytest.mark.parametrize("k", [0, 4, 9])
def test_velocity_constraint_linearization_matches_jax(P, nodes, k):
    X, U = nodes
    row = P.tstage.rows(k)
    t_out = t_cons.velocity_constraint_linearization(
        P.tmodel, torch.as_tensor(X[k]), torch.as_tensor(U[k]), row.contact_flags, row.z_vel_ref)
    j_out = j_cons.velocity_constraint_linearization(
        P.jmodel, jnp.asarray(X[k]), jnp.asarray(U[k]),
        P.jstage.contact_flags[k], P.jstage.z_vel_ref[k])
    _close(t_out, j_out)


@pytest.mark.parametrize("gait", ["trot", "standing_trot", "flying_trot", "static_walk"])
def test_gait_timeline_and_swing_copies_match_jax(gait):
    out = []
    for Sched, lib, Cfg, swing in ((JGaitSchedule, J_GAITS, JSwingConfig, j_swing),
                                   (TGaitSchedule, T_GAITS, TSwingConfig, t_swing)):
        s = Sched()
        s.insert_template(lib[gait], 0.2, 3.0)
        tl = s.compile_timeline(0.1, 1.0, 0.015)
        out.append((tl.times, tl.modes, tl.contact_flags) + tuple(swing(s, tl.times, Cfg())))
    for a, b in zip(*out):
        np.testing.assert_array_equal(a, b)


def _two_knot_targets():
    rng = np.random.default_rng(9)
    states = rng.normal(size=(2, 37)) * 0.1
    for s in states:
        q = rng.normal(size=4)
        s[33:37] = q / np.linalg.norm(q)
    return np.array([0.0, 0.5]), states, rng.normal(size=(2, 30))


def test_target_trajectories_match_jax():
    times, states, inputs = _two_knot_targets()
    jt = JTargets.create(jnp.asarray(times), jnp.asarray(states), jnp.asarray(inputs))
    tt = TTargets.create(*(torch.as_tensor(a) for a in (times, states, inputs)))
    _close((tt.times, tt.states, tt.inputs), (jt.times, jt.states, jt.inputs))
    ts = np.linspace(-0.1, 0.8, 13)
    _close(tt.desired_state(torch.as_tensor(ts)), jax.vmap(jt.desired_state)(jnp.asarray(ts)))
    _close(tt.ee_pose(torch.as_tensor(ts)), jax.vmap(jt.ee_pose)(jnp.asarray(ts)))
    with pytest.raises(ValueError):
        TTargets.create(*(torch.zeros(9, *a.shape[1:]) for a in (times, states, inputs)))


def test_build_stage_data_matches_jax(P):
    times, states, inputs = _two_knot_targets()
    jt = JTargets.create(jnp.asarray(times), jnp.asarray(states), jnp.asarray(inputs))
    tt = TTargets.create(*(torch.as_tensor(a) for a in (times, states, inputs)))
    out = []
    for build, model, cfg, targets, Sched, lib in (
            (j_prob.build_stage_data, P.jmodel, P.jcfg, jt, JGaitSchedule, J_GAITS),
            (t_prob.build_stage_data, P.tmodel, P.tcfg, tt, TGaitSchedule, T_GAITS)):
        s = Sched()
        s.insert_template(lib["trot"], 0.0, 5.0)
        out.append(build(model, cfg, s, targets, 0.05))
    js, ts = out
    for name in ("times", "contact_flags", "x_nom", "u_nom", "ee_pos_ref", "ee_quat_ref",
                 "z_vel_ref", "z_pos_ref"):
        _close(getattr(ts, name), getattr(js, name))


def test_make_ocp_config_matches_jax(P):
    jd = as_numpy_fields(P.jocp)
    for name in ("Q", "R", "arm_pos_lower", "arm_pos_upper", "arm_vel_lower", "arm_vel_upper"):
        _close(getattr(P.tocp, name), jd[name])
    for name in ("ee_mu_position", "cone_mu", "cone_delta", "limit_vel_delta",
                 "friction_coefficient", "final_ee_mu_orientation"):
        assert getattr(P.tocp, name) == jd[name]
    converted = convert.ocp_config_from_numpy(jd, device="cpu")
    _close(converted.R, jd["R"])


def test_unported_options_raise(P):
    """The self-collision cost is the one OCP option not ported."""
    cfg = P.tcfg.__class__()
    cfg.self_collision.mu = 1.0
    with pytest.raises(NotImplementedError, match="self-collision"):
        t_prob.make_ocp_config(P.tmodel, cfg)
    jd = as_numpy_fields(P.jocp)
    with pytest.raises(NotImplementedError, match="self-collision"):
        convert.ocp_config_from_numpy(dict(jd, self_collision_mu=1.0), device="cpu")


@pytest.mark.parametrize("k", [0, 3, 9])
def test_stage_cost_and_quadratization_match_jax(P, nodes, k):
    X, U = nodes
    x, u = torch.as_tensor(X[k]), torch.as_tensor(U[k])
    row = P.tstage.rows(k)
    _close(t_prob.stage_cost(P.tmodel, P.tocp, row, x, u),
           j_prob.stage_cost(P.jmodel, P.jocp, P.jstage, k, jnp.asarray(X[k]), jnp.asarray(U[k])))
    j_q = jax.jit(lambda x_, u_: j_prob.quadratize_stage(P.jmodel, P.jocp, P.jstage, k, x_, u_))
    _close(t_prob.quadratize_stage(P.tmodel, P.tocp, row, x, u),
           j_q(jnp.asarray(X[k]), jnp.asarray(U[k])))


def test_quadratize_stage_under_vmap(P, nodes):
    """Vmapped over the nodes with gathered stage rows = node by node."""
    X, U = nodes
    N = U.shape[0]
    x, u = torch.as_tensor(X[:N]), torch.as_tensor(U)
    rows = P.tstage.rows(slice(0, N))
    batched = vmap(lambda r, a, b: t_prob.quadratize_stage(P.tmodel, P.tocp, r, a, b))(rows, x, u)
    for k in (1, 6):
        single = t_prob.quadratize_stage(P.tmodel, P.tocp, P.tstage.rows(k), x[k], u[k])
        for a, b in zip(batched, single):
            np.testing.assert_allclose(to_np(a[k]), to_np(b), **TOL)


def test_terminal_cost_and_quadratization_match_jax(P, nodes):
    X, _ = nodes
    x = jnp.asarray(X[-1])
    _close(t_prob.terminal_cost(P.tmodel, P.tocp, P.tstage, torch.as_tensor(X[-1])),
           j_prob.terminal_cost(P.jmodel, P.jocp, P.jstage, x))
    _close(t_prob.quadratize_terminal(P.tmodel, P.tocp, P.tstage, torch.as_tensor(X[-1])),
           jax.jit(lambda a: j_prob.quadratize_terminal(P.jmodel, P.jocp, P.jstage, a))(x))


def test_evaluate_trajectory_matches_jax(P, nodes):
    X, U = nodes
    Xb = np.stack([X, X + 0.002])
    Ub = np.stack([U, U - 0.5])
    j_fn = jax.jit(jax.vmap(lambda a, b: j_evaluate(
        P.jmodel, P.jocp, P.jstage, P.jcfg.sqp.dt, a, b)))
    _close(t_evaluate(P.tmodel, P.tocp, P.tstage, P.tcfg.sqp.dt,
                      torch.as_tensor(Xb), torch.as_tensor(Ub)),
           j_fn(jnp.asarray(Xb), jnp.asarray(Ub)))


def test_convert_round_trips_stage_and_targets(P):
    sd = as_numpy_fields(P.jstage)
    for name in ("times", "contact_flags", "x_nom", "u_nom", "ee_quat_ref", "z_pos_ref"):
        np.testing.assert_array_equal(to_np(getattr(P.tstage, name)), sd[name])
    assert P.tstage.x_nom.dtype == F64 and P.ttargets.states.shape == (8, 37)
