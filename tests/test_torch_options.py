"""Two options of the torch port's batched solver against the JAX package,
float64 on the CPU: ``arm_locked`` (the quad-only variant,
config.quad_only_config) — the OCP config, the node projection, both
projections and the trajectory merit at 1e-10 / 1e-9, and the whole batched
iteration at rtol 1e-8 / atol 1e-9 with the arm velocities pinned to
exactly 0 — and per-scenario stage data (``stage_batched``,
``BatchedMpc(shared_stage=False)``), the whole iteration at the same bar."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qm_door_torch import convert
from qm_door_torch.ocp import problem as t_prob
from qm_door_torch.parallel.batched import BatchedMpc as TBatchedMpc
from qm_door_torch.solver import batched_sqp as t_bsqp
from qm_door_torch.solver import projection as t_proj
from qm_door_torch.solver import transcription as t_tr
from qm_door_torch.solver.sqp import SqpSolver as TSqpSolver
from qm_door_torch.solver.sqp import _settings_static as t_settings
from qm_door_torch.solver.sqp import evaluate_trajectory as t_evaluate
from qm_door_tpu.ocp.gait import GAIT_LIBRARY, GaitSchedule
from qm_door_tpu.ocp.problem import build_stage_data
from qm_door_tpu.parallel.batched import BatchedMpc as JBatchedMpc
from qm_door_tpu.solver import batched_sqp as j_bsqp
from qm_door_tpu.solver import projection as j_proj
from qm_door_tpu.solver import transcription as j_tr
from qm_door_tpu.solver.sqp import SqpSolver as JSqpSolver
from qm_door_tpu.solver.sqp import _settings_static as j_settings
from qm_door_tpu.solver.sqp import evaluate_trajectory as j_evaluate
from torch_parity import Problem, as_numpy_fields, shared_reference, to_np
from torch_parity import release_jax_executables  # noqa: F401 (autouse, module scope)

TOL = dict(rtol=1e-10, atol=1e-10)
TOL9 = dict(rtol=1e-9, atol=1e-9)
ITER_TOL = dict(rtol=1e-8, atol=1e-9)
PLQ_FIELDS = ("A", "B", "d", "lx", "lu", "lxx", "luu", "lux", "lx_f", "lxx_f", "p", "P",
              "Px_v", "force_mask")


def _close(t_out, j_out, tol=TOL, msg=""):
    if isinstance(j_out, (tuple, list)):
        for i, (a, b) in enumerate(zip(t_out, j_out)):
            _close(a, b, tol, f"{msg}[{i}]")
        return
    np.testing.assert_allclose(to_np(t_out), np.asarray(j_out), err_msg=msg, **tol)


@pytest.fixture(scope="module")
def Q():
    """The quad-only problem; the arm velocities of the perturbed iterate
    are nonzero, so the lock has work to do."""
    Q = Problem(B=2, seed=4, x_scale=0.03, quad_only=True)
    rng = np.random.default_rng(9)
    Q.Xp = Q.X + rng.normal(size=Q.X.shape) * 0.01
    Q.Up = Q.U + rng.normal(size=Q.U.shape) * 1.0
    return Q


def test_quad_only_config_matches_jax(Q):
    assert Q.tocp.arm_locked and Q.jocp.arm_locked
    jd = as_numpy_fields(Q.jocp)
    for name in ("Q", "R", "arm_vel_lower"):
        _close(getattr(Q.tocp, name), jd[name], msg=name)
    for name in ("ee_mu_position", "final_ee_mu_orientation", "wrench_mu", "wrench_delta"):
        assert getattr(Q.tocp, name) == jd[name], name
    converted = convert.ocp_config_from_numpy(jd, device="cpu")
    assert converted.arm_locked and converted.ee_mu_position == 0.0


@pytest.fixture(scope="module")
def j_lq(tmp_path_factory, Q):
    return shared_reference(
        tmp_path_factory, "linearize_ocp arm_locked analytic frozen",
        lambda: jax.jit(jax.vmap(lambda X, U: j_tr.linearize_ocp(
            Q.jmodel, Q.jocp, Q.jstage, Q.jcfg.sqp.dt, X, U, sensitivity="frozen",
            tangents="analytic")))(jnp.asarray(Q.Xp), jnp.asarray(Q.Up)), Q.Xp, Q.Up)


@pytest.fixture(scope="module")
def t_lq(j_lq):
    return convert.lq_from_numpy(as_numpy_fields(j_lq), device="cpu")


def test_project_node_chol_arm_locked_matches_jax(Q, j_lq, t_lq):
    b, N = 0, Q.N
    flags = np.asarray(Q.jstage.contact_flags[:N])
    j_out = jax.vmap(lambda f, F, g0, Gx, Gv, v: j_proj.project_node_chol(
        f, F, g0, Gx, Gv, 1e-5, v_arm=v, arm_locked=True))(
        flags, Q.Up[b, :, :12], j_lq.g0[b], j_lq.Gx[b], j_lq.Gv[b], Q.Up[b, :, 24:30])
    t_out = t_proj.project_node_chol(Q.t(flags), Q.t(Q.Up[b, :, :12]), t_lq.g0[b],
                                     t_lq.Gx[b], t_lq.Gv[b], 1e-5,
                                     v_arm=Q.t(Q.Up[b, :, 24:30]), arm_locked=True)
    _close(t_out, j_out)
    # the arm-velocity inputs are pinned: u + du has zero arm velocity
    p, Pu, Px, _ = t_out
    du = p + Pu @ torch.ones(30, dtype=p.dtype) + Px @ torch.ones(30, dtype=p.dtype)
    np.testing.assert_allclose(to_np(du[:, 24:30]), -Q.Up[b, :, 24:30], **TOL)


def test_project_ocp_arm_locked_matches_jax(Q, j_lq, t_lq):
    b = 1
    j_lq1 = jax.tree.map(lambda a: a[b], j_lq)
    t_lq1 = t_tr.LqProblem(**{k: v[b] for k, v in vars(t_lq).items()})
    j_plq = jax.jit(lambda lq, U: j_tr.project_ocp(lq, Q.jstage, U, shift=1e-5,
                                                   arm_locked=True))(j_lq1, Q.Up[b])
    t_plq = t_tr.project_ocp(t_lq1, Q.tstage, Q.t(Q.Up[b]), shift=1e-5, arm_locked=True)
    for f in ("A", "B", "d", "lx", "lu", "lxx", "luu", "lux", "p", "Pu", "Px"):
        _close(getattr(t_plq, f), getattr(j_plq, f), TOL9, f)
    with pytest.raises(ValueError, match="chol"):
        t_tr.project_ocp(t_lq1, Q.tstage, Q.t(Q.Up[b]), method="qr", arm_locked=True)


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_project_batched_arm_locked_matches_jax(Q, j_lq, t_lq, backend):
    flags = np.broadcast_to(np.asarray(Q.jstage.contact_flags[:Q.N]), (2, Q.N, 4))
    j_plq = jax.jit(lambda lq, f, U: j_tr.project_ocp_batched(
        lq, f, U, shift=1e-5, backend=backend, arm_locked=True))(j_lq, flags, Q.Up)
    t_plq = t_tr.project_ocp_batched(t_lq, Q.t(flags), Q.t(Q.Up), shift=1e-5, arm_locked=True)
    for f in PLQ_FIELDS:
        _close(getattr(t_plq, f), getattr(j_plq, f), TOL9, f)


def test_evaluate_trajectory_arm_locked_matches_jax(Q):
    fn = jax.jit(jax.vmap(lambda a, b: j_evaluate(Q.jmodel, Q.jocp, Q.jstage,
                                                  Q.jcfg.sqp.dt, a, b)))
    _close(t_evaluate(Q.tmodel, Q.tocp, Q.tstage, Q.tcfg.sqp.dt, Q.t(Q.Xp), Q.t(Q.Up)),
           fn(jnp.asarray(Q.Xp), jnp.asarray(Q.Up)))


def test_iteration_arm_locked_matches_jax(Q):
    """bm_k1 and bm_fused against JAX bm_xla from the cold iterate; the arm
    velocities stay exactly 0."""
    settings = j_settings(Q.jcfg.sqp)
    ref = jax.jit(lambda x, X, U: j_bsqp.batched_sqp_iteration(
        Q.jmodel, Q.jocp, Q.jstage, Q.jcfg.sqp.dt, settings, x, X, U, backend="bm_xla"))(
        jnp.asarray(Q.xb), jnp.asarray(Q.X), jnp.asarray(Q.U))
    assert float(np.abs(Q.U[..., 24:30]).max()) == 0.0
    for backend in ("bm_k1", "bm_fused"):
        Xt, Ut, st = t_bsqp.batched_sqp_iteration(
            Q.tmodel, Q.tocp, Q.tstage, Q.tcfg.sqp.dt, t_settings(Q.tcfg.sqp), Q.t(Q.xb),
            Q.t(Q.X), Q.t(Q.U), backend=backend)
        _close(Xt, ref[0], ITER_TOL, f"{backend} X")
        _close(Ut, ref[1], ITER_TOL, f"{backend} U")
        _close(st, ref[2], ITER_TOL, f"{backend} stats")
        assert float(st[2].min()) > 0.0
        np.testing.assert_array_equal(to_np(Ut[..., 24:30]), 0.0)


def test_lq_fused_refuses_arm_locked(Q):
    with pytest.raises(ValueError, match="arm_locked"):
        t_bsqp.batched_sqp_iteration(
            Q.tmodel, Q.tocp, Q.tstage, Q.tcfg.sqp.dt, t_settings(Q.tcfg.sqp), Q.t(Q.xb),
            Q.t(Q.X), Q.t(Q.U), backend="lq_fused")


# ---------------------------------------------------------------------------
# per-scenario stage data
# ---------------------------------------------------------------------------

T0S = (0.0, 0.21)  # the second scenario's gait is in another phase


@pytest.fixture(scope="module")
def S():
    """Two scenarios, each with its own stage data (the trot from another
    start time), stacked on a leading axis in both packages."""
    S = Problem(B=2, seed=6, x_scale=0.03)
    sched = GaitSchedule()
    sched.insert_template(GAIT_LIBRARY["trot"], 0.0, 5.0)
    stages = [build_stage_data(S.jmodel, S.jcfg, sched, S.jtargets, t0,
                               horizon=S.jcfg.mpc.time_horizon) for t0 in T0S]
    S.jstage_b = jax.tree.map(lambda *a: jnp.stack(a), *stages)
    S.tstage_b = convert.stage_data_from_numpy(as_numpy_fields(S.jstage_b), device="cpu")
    assert not np.array_equal(np.asarray(stages[0].contact_flags),
                              np.asarray(stages[1].contact_flags))
    S.U = np.stack([np.asarray(s.u_nom[:S.N]) for s in stages])
    return S


def _scenario(stage, b):
    """Scenario b's own stage data out of per-scenario stage data."""
    return dataclasses.replace(stage, **{k: v[b] for k, v in vars(stage).items()
                                         if v is not None})


def _t_step_b(S, backend):
    return t_bsqp.batched_sqp_iteration(
        S.tmodel, S.tocp, S.tstage_b, S.tcfg.sqp.dt, t_settings(S.tcfg.sqp), S.t(S.xb),
        S.t(S.X), S.t(S.U), stage_batched=True, backend=backend)


def test_iteration_stage_batched_matches_jax(S):
    """bm_k1, bm_fused and BatchedMpc(shared_stage=False) against JAX bm_xla
    with stage_batched=True."""
    settings = j_settings(S.jcfg.sqp)
    ref = jax.jit(lambda st, x, X, U: j_bsqp.batched_sqp_iteration(
        S.jmodel, S.jocp, st, S.jcfg.sqp.dt, settings, x, X, U, stage_batched=True,
        backend="bm_xla"))(S.jstage_b, jnp.asarray(S.xb), jnp.asarray(S.X), jnp.asarray(S.U))
    mpc = TBatchedMpc(TSqpSolver(S.tmodel, S.tocp, S.tcfg), shared_stage=False)
    outs = {b: _t_step_b(S, b) for b in ("bm_k1", "bm_fused")}
    outs["BatchedMpc"] = mpc.step(S.tstage_b, S.t(S.xb), S.t(S.X), S.t(S.U))
    for name, (Xt, Ut, st) in outs.items():
        _close(Xt, ref[0], ITER_TOL, f"{name} X")
        _close(Ut, ref[1], ITER_TOL, f"{name} U")
        _close(st, ref[2], ITER_TOL, f"{name} stats")
        assert float(st[2].min()) > 0.0


def test_stage_batched_is_each_scenario_alone(S):
    """Each scenario's row of the per-scenario-stage iteration = the shared
    iteration of that scenario with its own stage data."""
    Xb, Ub, sb = _t_step_b(S, "bm_k1")
    for b in range(2):
        stage = _scenario(S.tstage_b, b)
        Xs, Us, ss = t_bsqp.batched_sqp_iteration(
            S.tmodel, S.tocp, stage, S.tcfg.sqp.dt, t_settings(S.tcfg.sqp), S.t(S.xb[b:b + 1]),
            S.t(S.X[b:b + 1]), S.t(S.U[b:b + 1]))
        np.testing.assert_allclose(to_np(Xs[0]), to_np(Xb[b]), **TOL)
        np.testing.assert_allclose(to_np(Us[0]), to_np(Ub[b]), **TOL)
        for a, c in zip(ss, sb):
            np.testing.assert_allclose(to_np(a[0]), to_np(c[b]), **TOL)


def test_cold_start_per_scenario_stage_matches_jax(S):
    js = JSqpSolver(S.jmodel, S.jocp, S.jcfg)
    ts = TSqpSolver(S.tmodel, S.tocp, S.tcfg)
    j_out = JBatchedMpc(js, shared_stage=False).cold_start(S.jstage_b, jnp.asarray(S.xb))
    t_out = TBatchedMpc(ts, shared_stage=False).cold_start(S.tstage_b, S.t(S.xb))
    for a, b in zip(t_out, j_out):
        np.testing.assert_array_equal(to_np(a), np.asarray(b))


def test_stage_batched_flag_must_match_the_stage(S):
    with pytest.raises(ValueError, match="stage_batched"):
        t_tr.linearize_ocp(S.tmodel, S.tocp, S.tstage_b, 0.015, S.t(S.X), S.t(S.U))
    with pytest.raises(ValueError, match="stage_batched"):
        t_tr.linearize_ocp(S.tmodel, S.tocp, S.tstage, 0.015, S.t(S.X), S.t(S.U),
                           stage_batched=True)


def test_quadratize_stage_row_of_batched_stage(S):
    """StageData.rows indexes the node axis behind a scenario axis."""
    rows = S.tstage_b.rows(3)
    for b in range(2):
        one = _scenario(S.tstage_b, b)
        for a, c in zip(one.rows(3), rows):
            np.testing.assert_array_equal(to_np(a), to_np(c[b]))
    _close(t_prob.terminal_cost(S.tmodel, S.tocp, S.tstage_b, S.t(S.X[:, -1])),
           np.array([float(t_prob.terminal_cost(
               S.tmodel, S.tocp, _scenario(S.tstage_b, b), S.t(S.X[b, -1])))
               for b in range(2)]))
