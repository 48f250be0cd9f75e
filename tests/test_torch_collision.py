"""The port's self-collision cost (qm_door_torch/ocp/collision.py) against
the JAX package, float64 on the CPU: the pair clearances, the cost and its
Gauss-Newton quadratization at 1e-10, in the barrier's log branch and its
quadratic branch; batched and under torch.func.vmap as the linearization
runs it; the OCP config carrying the option; one sqp_iteration with
self_collision.mu = 0.1 and riccati="parallel" (the associative scan)
against JAX's with both (N = 10) at rtol 1e-8 / atol 1e-9, which holds the
stage cost and its quadratization with the option on through the
iteration's cost and step: one JAX compile for the two options the port
added."""
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import vmap

from qm_door_torch import convert
from qm_door_torch.ocp import collision as t_col
from qm_door_torch.ocp import problem as t_prob
from qm_door_torch.solver.sqp import SqpSolver as TSqpSolver
from qm_door_torch.solver.sqp import sqp_iteration as t_sqp_iteration
from qm_door_tpu.ocp import collision as j_col
from qm_door_tpu.ocp import problem as j_prob
from qm_door_tpu.solver.sqp import SqpSolver as JSqpSolver
from torch_parity import Problem, as_numpy_fields, configs, shared_reference, to_np
from torch_parity import release_jax_executables  # noqa: F401 (autouse, module scope)

TOL = dict(rtol=1e-10, atol=1e-10)
ITER_TOL = dict(rtol=1e-8, atol=1e-9)
MU = 0.1
# z1_joint_2 (x[25]) from the folded default down to where the forearm
# reaches the front legs: the min clearance goes from ~0.3 m (log branch)
# to below delta (quadratic branch)
SHOULDER = (1.11, 0.0, -1.0)


def _close(t_out, j_out, tol=TOL, msg=""):
    if isinstance(j_out, (tuple, list)):
        for i, (a, b) in enumerate(zip(t_out, j_out)):
            _close(a, b, tol, f"{msg}[{i}]")
        return
    np.testing.assert_allclose(to_np(t_out), np.asarray(j_out), err_msg=msg, **tol)


def _with_the_option(P):
    for cfg in (P.jcfg, P.tcfg):
        cfg.self_collision.mu = MU
    P.jocp = j_prob.make_ocp_config(P.jmodel, P.jcfg)
    P.tocp = t_prob.make_ocp_config(P.tmodel, P.tcfg)
    return P


@pytest.fixture(scope="module")
def M():
    """Both models and OCP configs with the option on (no stage data)."""
    from qm_door_torch.models.model import aliengo_z1 as t_aliengo_z1
    from qm_door_tpu.models import aliengo_z1 as j_aliengo_z1

    jcfg, tcfg = configs()
    M = SimpleNamespace(jcfg=jcfg, tcfg=tcfg, jmodel=j_aliengo_z1(dtype=jnp.float64),
                        tmodel=t_aliengo_z1(dtype=torch.float64, device="cpu"),
                        x=tcfg.initial_state())
    return _with_the_option(M)


@pytest.fixture(scope="module")
def P():
    return _with_the_option(Problem(B=1, seed=11, x_scale=0.02))


def _states(M, seed=3):
    """One state at each SHOULDER angle, perturbed."""
    rng = np.random.default_rng(seed)
    xs = np.tile(M.x, (len(SHOULDER), 1)) + rng.normal(size=(len(SHOULDER), 30)) * 0.02
    xs[:, 25] = SHOULDER
    return xs


def test_ocp_config_carries_the_option(M):
    jd = as_numpy_fields(M.jocp)
    for name in ("self_collision_mu", "self_collision_delta", "self_collision_margin"):
        assert getattr(M.tocp, name) == jd[name]
    assert M.tocp.self_collision_mu == MU
    assert convert.ocp_config_from_numpy(jd, device="cpu").self_collision_margin == \
        jd["self_collision_margin"]


def test_clearances_and_cost_match_jax(M):
    xs = _states(M)
    h_min = []
    for x in xs:
        h = t_col.pair_clearances(M.tmodel, torch.as_tensor(x[6:30]), M.tocp.self_collision_margin)
        _close(h, j_col.pair_clearances(M.jmodel, jnp.asarray(x[6:30]),
                                        M.jocp.self_collision_margin))
        h_min.append(float(h.min()))
        _close(t_col.self_collision_cost(M.tmodel, M.tocp, torch.as_tensor(x)),
               j_col.self_collision_cost(M.jmodel, M.jocp, jnp.asarray(x)))
    assert h_min[0] > 0.2 and h_min[-1] < M.tocp.self_collision_delta  # both branches
    # batched over the leading dims = state by state
    batched = t_col.self_collision_cost(M.tmodel, M.tocp, torch.as_tensor(xs))
    assert batched.shape == (len(xs),)
    for i, x in enumerate(xs):
        _close(batched[i], t_col.self_collision_cost(M.tmodel, M.tocp, torch.as_tensor(x)))


def test_quadratization_matches_jax_and_vmaps(M):
    xs = _states(M, seed=4)
    j_q = jax.jit(jax.vmap(lambda x: j_col.quadratize_self_collision(M.jmodel, M.jocp, x)))(
        jnp.asarray(xs))
    t_q = vmap(lambda x: t_col.quadratize_self_collision(M.tmodel, M.tocp, x))(
        torch.as_tensor(xs))
    _close(t_q, j_q)
    for i, x in enumerate(xs):
        _close(t_col.quadratize_self_collision(M.tmodel, M.tocp, torch.as_tensor(x)),
               tuple(a[i] for a in j_q))
    assert float(np.abs(np.asarray(j_q[1][-1])).max()) > 1.0  # an active pair's gradient


def test_sqp_iteration_with_self_collision_and_the_scan_matches_jax(tmp_path_factory, P):
    """One per-scenario iteration with riccati="parallel", from an iterate
    whose arm reaches for the front legs (the quadratic branch active),
    against JAX's jitted solve (sqp_iterations = 1) from the same iterate."""
    rng = np.random.default_rng(6)
    X = P.X[0] + rng.normal(size=P.X[0].shape) * 0.01
    X[:, 25] = -1.0
    U = P.U[0] + rng.normal(size=P.U[0].shape) * 1.0
    for cfg in (P.jcfg, P.tcfg):
        cfg.sqp.riccati = "parallel"
    js = JSqpSolver(P.jmodel, P.jocp, P.jcfg)
    ts = TSqpSolver(P.tmodel, P.tocp, P.tcfg)
    assert js.settings.riccati == ts.settings.riccati == "parallel"
    x0 = P.xb[0].copy()
    x0[25] = -1.0
    sol = shared_reference(
        tmp_path_factory, "sqp_iteration self_collision mu 0.1 riccati parallel",
        lambda: js._solve(P.jstage, jnp.asarray(x0), jnp.asarray(X), jnp.asarray(U)), x0, X, U)
    Xt, Ut, st = t_sqp_iteration(P.tmodel, P.tocp, P.tstage, P.tcfg.sqp.dt, ts.settings,
                                 torch.as_tensor(x0), torch.as_tensor(X), torch.as_tensor(U))
    _close(Xt, sol.X, ITER_TOL, "X")
    _close(Ut, sol.U, ITER_TOL, "U")
    _close(st, (sol.cost, sol.constraint_violation, sol.step_size), ITER_TOL, "stats")
    # the option is on: the same iterate costs more than without it
    off = t_sqp_iteration(P.tmodel, t_prob.make_ocp_config(P.tmodel, P.tcfg.__class__()),
                          P.tstage, P.tcfg.sqp.dt, ts.settings, torch.as_tensor(x0),
                          torch.as_tensor(X), torch.as_tensor(U))[2][0]
    assert float(off) < float(st[0])
