"""The torch port's per-scenario solver against the JAX package, float64 on
the CPU: the row permutation, the QR node projection and the Cholesky
projector, ``project_ocp`` with the dense substitution (chol, qr and the
force-tracking projector) and the per-scenario Riccati sweeps at 1e-10 /
1e-9; one ``sqp_iteration`` and ``SqpSolver.solve`` from a cold start and
warm-started (``warm_start``) against JAX's jitted solve at rtol 1e-8 /
atol 1e-9; the settings the port refuses."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qm_door_torch import convert
from qm_door_torch.solver import projection as t_proj
from qm_door_torch.solver import riccati as t_ric
from qm_door_torch.solver import transcription as t_tr
from qm_door_torch.solver.sqp import SqpSolver as TSqpSolver
from qm_door_torch.solver.sqp import _settings_static as t_settings
from qm_door_torch.solver.sqp import sqp_iteration as t_sqp_iteration
from qm_door_tpu.solver import projection as j_proj
from qm_door_tpu.solver import riccati as j_ric
from qm_door_tpu.solver import transcription as j_tr
from qm_door_tpu.solver.sqp import SqpSolver as JSqpSolver
from torch_parity import Problem, ProblemFT, as_numpy_fields, shared_reference, to_np
from torch_parity import release_jax_executables  # noqa: F401 (autouse, module scope)

TOL = dict(rtol=1e-10, atol=1e-10)
TOL9 = dict(rtol=1e-9, atol=1e-9)
ITER_TOL = dict(rtol=1e-8, atol=1e-9)
DENSE_FIELDS = ("A", "B", "d", "lx", "lu", "lxx", "luu", "lux", "lx_f", "lxx_f", "p", "Pu",
                "Px")


def _close(t_out, j_out, tol=TOL, msg=""):
    if isinstance(j_out, (tuple, list)):
        for i, (a, b) in enumerate(zip(t_out, j_out)):
            _close(a, b, tol, f"{msg}[{i}]")
        return
    np.testing.assert_allclose(to_np(t_out), np.asarray(j_out), err_msg=msg, **tol)


def _perturb(P, seed):
    rng = np.random.default_rng(seed)
    return (P.X[0] + rng.normal(size=P.X[0].shape) * 0.01,
            P.U[0] + rng.normal(size=P.U[0].shape) * 1.0)


@pytest.fixture(scope="module")
def P():
    P = Problem(B=1, seed=2, x_scale=0.03)
    P.Xp, P.Up = _perturb(P, 12)
    return P


@pytest.fixture(scope="module")
def lqs(tmp_path_factory, P):
    """One scenario's LQ data from JAX (once per test run), in both packages."""
    j_lq = shared_reference(
        tmp_path_factory, "linearize_ocp one scenario analytic frozen",
        lambda: jax.jit(lambda X, U: j_tr.linearize_ocp(
            P.jmodel, P.jocp, P.jstage, P.jcfg.sqp.dt, X, U, sensitivity="frozen",
            tangents="analytic"))(jnp.asarray(P.Xp), jnp.asarray(P.Up)), P.Xp, P.Up)
    return j_lq, convert.lq_from_numpy(as_numpy_fields(j_lq), device="cpu")


def test_row_permutation_matches_jax(P):
    from qm_door_tpu.ocp.gait import mode_to_flags

    flags = mode_to_flags(np.arange(16)).astype(float)               # every mode
    perm, act, r = t_tr._row_permutation(P.t(flags))
    j_perm, j_act, j_r = jax.vmap(j_tr._row_permutation)(jnp.asarray(flags))
    np.testing.assert_array_equal(to_np(perm), np.asarray(j_perm))
    np.testing.assert_array_equal(to_np(act), np.asarray(j_act))
    np.testing.assert_array_equal(to_np(r), np.asarray(j_r))


NODE_FNS = {"qr": (t_tr._project_node, j_tr._project_node),
            "chol": (t_proj.project_node_chol, j_proj.project_node_chol)}


@pytest.mark.parametrize("method", list(NODE_FNS))
def test_project_node_matches_jax(P, lqs, method):
    """The node projection over every node of the horizon (every contact
    count the trot visits), and on every mode at one node's constraint data."""
    j_lq, t_lq = lqs
    t_fn, j_fn = NODE_FNS[method]
    N = P.N
    flags = np.asarray(P.jstage.contact_flags[:N])
    j_out = jax.vmap(lambda f, F, g0, Gx, Gv: j_fn(f, F, g0, Gx, Gv, 1e-5))(
        flags, P.Up[:, :12], j_lq.g0, j_lq.Gx, j_lq.Gv)
    _close(t_fn(P.t(flags), P.t(P.Up[:, :12]), t_lq.g0, t_lq.Gx, t_lq.Gv, 1e-5), j_out, TOL9)

    from qm_door_tpu.ocp import constraints as j_cons
    from qm_door_tpu.ocp.gait import mode_to_flags

    modes = mode_to_flags(np.arange(16)).astype(float)
    mask = np.asarray(j_cons.velocity_row_mask(jnp.asarray(modes)))  # zero the inactive rows
    g0 = np.asarray(j_lq.g0[2])[None] * mask
    Gx = np.asarray(j_lq.Gx[2])[None] * mask[..., None]
    Gv = np.asarray(j_lq.Gv[2])[None] * mask[..., None]
    F = np.broadcast_to(P.Up[2, :12], (16, 12))
    j_out = jax.vmap(lambda f, F_, a, b, c: j_fn(f, F_, a, b, c, 1e-5))(modes, F, g0, Gx, Gv)
    _close(t_fn(*(P.t(a) for a in (modes, F, g0, Gx, Gv)), 1e-5), j_out, TOL9)


@pytest.mark.parametrize("method", ["chol", "qr"])
def test_project_ocp_matches_jax(P, lqs, method):
    j_lq, t_lq = lqs
    j_plq = jax.jit(lambda lq, U: j_tr.project_ocp(lq, P.jstage, U, shift=1e-5,
                                                   method=method))(j_lq, P.Up)
    t_plq = t_tr.project_ocp(t_lq, P.tstage, P.t(P.Up), shift=1e-5, method=method)
    assert t_plq.B.shape[-1] == (30 if method == "chol" else 26)
    for f in DENSE_FIELDS:
        _close(getattr(t_plq, f), getattr(j_plq, f), TOL9, f)
    with pytest.raises(ValueError, match="method"):
        t_tr.project_ocp(t_lq, P.tstage, P.t(P.Up), method="svd")


@pytest.mark.parametrize("method", ["chol", "qr"])
def test_riccati_per_scenario_matches_jax(P, lqs, method):
    """riccati_backward (K, kff, S0, s0), riccati_forward (dX, dU_red, dU)
    and lqr_solve on the projected data, each gain solve a K1 call."""
    j_lq, t_lq = lqs
    dx0 = P.xb[0] - P.Xp[0]
    j_plq = j_tr.project_ocp(j_lq, P.jstage, jnp.asarray(P.Up), shift=1e-5, method=method)
    t_plq = t_tr.project_ocp(t_lq, P.tstage, P.t(P.Up), shift=1e-5, method=method)
    j_bwd = jax.jit(j_ric.riccati_backward)(j_plq)
    t_bwd = t_ric.riccati_backward(t_plq)
    _close(t_bwd, j_bwd, TOL9, "backward")
    j_fwd = jax.jit(j_ric.riccati_forward)(j_plq, *j_bwd[:2], jnp.asarray(dx0))
    _close(t_ric.riccati_forward(t_plq, *t_bwd[:2], P.t(dx0)), j_fwd, TOL9, "forward")
    _close(t_ric.lqr_solve(t_plq, P.t(dx0)), (j_fwd[0], j_fwd[2]) + tuple(j_bwd[:2]), TOL9,
           "lqr_solve")


def test_project_ocp_force_tracking_matches_jax():
    """The per-scenario projection of the 36-input problem (the
    force-tracking Cholesky projector, both grasp states in the horizon)."""
    F = ProblemFT(B=1, seed=3)
    rng = np.random.default_rng(4)
    X = F.X[0] + rng.normal(size=F.X[0].shape) * 0.01
    U = F.U[0] + rng.normal(size=F.U[0].shape) * 1.0
    j_lq = jax.jit(lambda X_, U_: j_tr.linearize_ocp(
        F.jmodel, F.jocp, F.jstage, F.jcfg.sqp.dt, X_, U_, sensitivity="frozen",
        tangents="analytic"))(jnp.asarray(X), jnp.asarray(U))
    t_lq = convert.lq_from_numpy(as_numpy_fields(j_lq), device="cpu")
    j_plq = jax.jit(lambda lq, U_: j_tr.project_ocp(lq, F.jstage, U_, shift=1e-5))(j_lq, U)
    t_plq = t_tr.project_ocp(t_lq, F.tstage, F.t(U), shift=1e-5)
    assert t_plq.Pu.shape[-2:] == (36, 36)
    for f in DENSE_FIELDS:
        _close(getattr(t_plq, f), getattr(j_plq, f), TOL9, f)
    dx0 = F.xb[0] - X[0]
    _close(t_ric.lqr_solve(t_plq, F.t(dx0)), jax.jit(j_ric.lqr_solve)(j_plq, jnp.asarray(dx0)),
           TOL9, "lqr_solve")


@pytest.fixture(scope="module")
def solvers(P):
    js = JSqpSolver(P.jmodel, P.jocp, P.jcfg)
    ts = TSqpSolver(P.tmodel, P.tocp, P.tcfg)
    return js, ts


T1 = 1.4 * 0.015  # the warm solve's grid starts between the old grid's nodes


@pytest.fixture(scope="module")
def j_solves(tmp_path_factory, P, solvers):
    """JAX's jitted solves on P, once per test run (one compile of the
    solve): one iteration from the perturbed iterate, the cold solve, the
    warm start onto the grid from T1 and the warm solve from it."""
    js, _ = solvers

    def compute():
        from qm_door_tpu.ocp.gait import GAIT_LIBRARY, GaitSchedule
        from qm_door_tpu.ocp.problem import build_stage_data

        x = jnp.asarray(P.xb[0])
        iteration = js._solve(P.jstage, x, jnp.asarray(P.Xp), jnp.asarray(P.Up))
        cold = js.solve(P.jstage, x)
        sched = GaitSchedule()
        sched.insert_template(GAIT_LIBRARY["trot"], 0.0, 5.0)
        stage1 = build_stage_data(P.jmodel, P.jcfg, sched, P.jtargets, T1)
        warm = (cold.times, cold.X, cold.U)
        return dict(iteration=iteration, cold=cold, stage1=stage1,
                    warm_start=js.warm_start(*warm, stage1.times),
                    warm=js.solve(stage1, cold.X[1], warm=warm))

    return shared_reference(tmp_path_factory, "SqpSolver solves", compute, P.xb, P.Xp, P.Up)


def test_sqp_iteration_matches_jax(P, solvers, j_solves):
    """One per-scenario iteration from a perturbed iterate against JAX's
    jitted solve from the same iterate (sqp_iterations = 1: one
    sqp_iteration)."""
    js, ts = solvers
    assert js.settings.sqp_iterations == 1
    sol = j_solves["iteration"]
    Xt, Ut, st = t_sqp_iteration(P.tmodel, P.tocp, P.tstage, P.tcfg.sqp.dt, ts.settings,
                                 P.t(P.xb[0]), P.t(P.Xp), P.t(P.Up))
    _close(Xt, sol.X, ITER_TOL, "X")
    _close(Ut, sol.U, ITER_TOL, "U")
    _close(st, (sol.cost, sol.constraint_violation, sol.step_size), ITER_TOL, "stats")
    assert float(st[2]) > 0.0


def test_solve_cold_then_warm_matches_jax(P, solvers, j_solves):
    """SqpSolver.solve from the cold start, then warm-started on the grid
    from T1 (warm_start's interpolation and hold) against JAX."""
    _, ts = solvers
    j_sol = j_solves["cold"]
    t_sol = ts.solve(P.tstage, P.t(P.xb[0]))
    for f in ("times", "X", "U", "cost", "constraint_violation", "step_size"):
        _close(getattr(t_sol, f), getattr(j_sol, f), ITER_TOL, f)

    t_stage1 = convert.stage_data_from_numpy(as_numpy_fields(j_solves["stage1"]), device="cpu")
    X0j, U0j = j_solves["warm_start"]
    X0t, U0t = ts.warm_start(t_sol.times, t_sol.X, t_sol.U, t_stage1.times)
    _close(X0t, X0j, ITER_TOL, "warm X")
    _close(U0t, U0j, ITER_TOL, "warm U")
    # the warm start of a batch of scenarios is each scenario's
    Xb, Ub = ts.warm_start(t_sol.times, torch.stack([t_sol.X, 2 * t_sol.X]),
                           torch.stack([t_sol.U, 2 * t_sol.U]), t_stage1.times)
    _close(Xb, np.stack([X0j, 2 * X0j]), ITER_TOL, "batched warm X")
    _close(Ub, np.stack([U0j, 2 * U0j]), ITER_TOL, "batched warm U")
    j_sol1 = j_solves["warm"]
    t_sol1 = ts.solve(t_stage1, P.t(np.asarray(j_sol.X[1])),
                      warm=(t_sol.times, t_sol.X, t_sol.U))
    for f in ("X", "U", "cost", "constraint_violation", "step_size"):
        _close(getattr(t_sol1, f), getattr(j_sol1, f), ITER_TOL, f"warm solve {f}")
    assert float(t_sol1.constraint_violation) < float(t_sol.constraint_violation)


def test_sqp_iteration_leaves_its_inputs(P, solvers):
    _, ts = solvers
    X, U = P.t(P.Xp), P.t(P.Up)
    X0, U0 = X.clone(), U.clone()
    Xn, _, _ = t_sqp_iteration(P.tmodel, P.tocp, P.tstage, P.tcfg.sqp.dt, ts.settings,
                               P.t(P.xb[0]), X, U)
    assert torch.equal(X, X0) and torch.equal(U, U0)
    np.testing.assert_array_equal(to_np(Xn[0]), P.xb[0])


def test_riccati_parallel_is_refused(P, j_solves):
    """riccati="parallel" is no longer refused: the associative scan
    (solver/parallel_riccati.py) runs the iteration, and from the perturbed
    iterate it lands on JAX's jitted iteration (the sequential sweep, which
    JAX's own scan equals at 1e-8, tests/test_parallel_riccati.py) at the
    iteration's bars."""
    cfg = P.tcfg.__class__()
    cfg.sqp.riccati = "parallel"
    cfg.sqp.linesearch_steps = P.tcfg.sqp.linesearch_steps
    cfg.mpc.time_horizon = P.tcfg.mpc.time_horizon
    ts = TSqpSolver(P.tmodel, P.tocp, cfg)
    sol = j_solves["iteration"]
    Xt, Ut, st = t_sqp_iteration(P.tmodel, P.tocp, P.tstage, P.tcfg.sqp.dt, ts.settings,
                                 P.t(P.xb[0]), P.t(P.Xp), P.t(P.Up))
    _close(Xt, sol.X, ITER_TOL, "X")
    _close(Ut, sol.U, ITER_TOL, "U")
    _close(st, (sol.cost, sol.constraint_violation, sol.step_size), ITER_TOL, "stats")


@pytest.mark.parametrize("field,value", [("projection", "svd"), ("riccati", "assoc")])
def test_unknown_solver_settings_are_refused(P, field, value):
    cfg = P.tcfg.__class__()
    setattr(cfg.sqp, field, value)
    with pytest.raises(ValueError, match=field):
        t_settings(cfg.sqp)
