"""The torch port's whole batched SQP iteration against the JAX package's
batch-major backends (bm_xla: XLA Cholesky; bm_pallas: the Pallas SPD
kernel, here in interpret mode), float64 on the CPU, at the JAX test's own
bar (tests/test_batched_sqp.py): rtol = 1e-8, atol = 1e-9."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qm_door_torch.parallel.batched import BatchedMpc
from qm_door_torch.solver import batched_sqp as t_bsqp
from qm_door_torch.solver.sqp import SqpSolver
from qm_door_torch.solver.sqp import _settings_static as t_settings
from qm_door_tpu.solver import batched_sqp as j_bsqp
from qm_door_tpu.solver.sqp import _settings_static as j_settings
from torch_parity import F64, Problem, to_np


@pytest.fixture(scope="module")
def P():
    return Problem(B=3, seed=3, x_scale=0.03)


def _t_step(P, X=None, U=None, dtype=F64):
    tm, to = P.tmodel, P.tocp
    stage = P.tstage
    if dtype != F64:
        from qm_door_torch.ocp.problem import make_ocp_config

        tm = tm.to(dtype=dtype)
        to = make_ocp_config(tm, P.tcfg)
        stage = type(stage)(**{k: v.to(dtype) for k, v in vars(stage).items()})
    cast = lambda a: torch.tensor(np.asarray(a), dtype=dtype)  # noqa: E731
    return t_bsqp.batched_sqp_iteration(
        tm, to, stage, P.tcfg.sqp.dt, t_settings(P.tcfg.sqp),
        cast(P.xb), cast(P.X if X is None else X), cast(P.U if U is None else U))


@pytest.mark.parametrize("backend", ["bm_xla", "bm_pallas"])
def test_iteration_matches_jax(P, backend):
    settings = j_settings(P.jcfg.sqp)
    j_fn = jax.jit(lambda x, X, U: j_bsqp.batched_sqp_iteration(
        P.jmodel, P.jocp, P.jstage, P.jcfg.sqp.dt, settings, x, X, U, backend=backend))
    Xj, Uj, sj = j_fn(jnp.asarray(P.xb), jnp.asarray(P.X), jnp.asarray(P.U))
    Xt, Ut, st = _t_step(P)
    tol = dict(rtol=1e-8, atol=1e-9)
    np.testing.assert_allclose(to_np(Xt), np.asarray(Xj), err_msg="X", **tol)
    np.testing.assert_allclose(to_np(Ut), np.asarray(Uj), err_msg="U", **tol)
    for name, a, b in zip(("cost", "violation", "step"), st, sj):
        np.testing.assert_allclose(to_np(a), np.asarray(b), err_msg=name, **tol)
    assert float(st[2].min()) > 0.0  # a real move


def test_accept_rule_matches_jax(P):
    rng = np.random.default_rng(0)
    n = 4000
    cost0 = rng.normal(size=n) * 10
    viol0 = 10.0 ** rng.uniform(-8, 0, size=n)
    costs = cost0 + rng.normal(size=n) * 1e-2
    viols = viol0 * rng.uniform(0.5, 3.0, size=n)
    costs[::97] = np.nan
    viols[::89] = np.inf
    s = t_settings(P.tcfg.sqp)
    out = t_bsqp._accept(*(torch.as_tensor(a) for a in (cost0, viol0, costs, viols)),
                         torch.tensor(0.5, dtype=F64), s)
    ref = j_bsqp._accept(*(jnp.asarray(a) for a in (cost0, viol0, costs, viols)),
                         jnp.asarray(0.5), j_settings(P.jcfg.sqp))
    np.testing.assert_array_equal(to_np(out), np.asarray(ref))
    assert 0 < int(out.sum()) < n


def test_batched_mpc_step_is_the_iteration_and_leaves_inputs(P):
    solver = SqpSolver(P.tmodel, P.tocp, P.tcfg)
    mpc = BatchedMpc(solver)
    X, U, x = P.t(P.X), P.t(P.U), P.t(P.xb)
    X0, U0 = X.clone(), U.clone()
    Xm, Um, sm = mpc.step(P.tstage, x, X, U)
    Xi, Ui, si = _t_step(P)
    assert torch.equal(Xm, Xi) and torch.equal(Um, Ui)
    assert all(torch.equal(a, b) for a, b in zip(sm, si))
    assert torch.equal(X, X0) and torch.equal(U, U0)
    assert torch.equal(Xm[:, 0], x)
    # a second iteration lowers the worst violation
    _, _, s2 = mpc.step(P.tstage, x, Xm, Um)
    assert float(s2[1].max()) < float(sm[1].max())


def test_rejected_step_keeps_the_iterate(P, monkeypatch):
    """Every candidate rejected (non-finite merit): alpha = 0, X and U kept
    (but X[:, 0] moves to x_init), cost and violation stay the baseline's;
    the early exit never evaluates more than the candidate count."""
    calls = []

    def nan_eval(model, ocp, stage, dt, X, U):
        calls.append(1)
        nan = torch.full(X.shape[:1], float("nan"), dtype=X.dtype)
        return nan, nan

    monkeypatch.setattr(t_bsqp, "evaluate_trajectory", nan_eval)
    Xn, Un, (cost, viol, alpha) = _t_step(P)
    assert len(calls) == P.tcfg.sqp.linesearch_steps
    assert bool((alpha == 0).all())
    np.testing.assert_array_equal(to_np(Un), P.U)
    np.testing.assert_array_equal(to_np(Xn[:, 1:]), P.X[:, 1:])
    np.testing.assert_array_equal(to_np(Xn[:, 0]), P.xb)
    assert bool(torch.isfinite(cost).all() and torch.isfinite(viol).all())


def test_float32_iteration_tracks_float64(P):
    """The f32 working dtype runs on the CPU and stays within f32 roundoff
    of the f64 iteration."""
    X32, U32, s32 = _t_step(P, dtype=torch.float32)
    X64, U64, _ = _t_step(P)
    assert X32.dtype == torch.float32 and bool(torch.isfinite(X32).all())
    assert float((X32.double() - X64).abs().max()) < 1e-4
    assert float((U32.double() - U64).abs().max()) < 5e-2
    assert float(s32[2].min()) > 0.0


def test_float32_bf16_sweeps_step(P):
    """analytic_bf16 in the f32 working dtype (the serving setting): the
    inexact-Newton step is accepted and lowers every scenario's violation."""
    P.tcfg.sqp.lin_tangents = "analytic_bf16"
    try:
        X1, U1, s1 = _t_step(P, dtype=torch.float32)
        _, _, s2 = _t_step(P, X=to_np(X1), U=to_np(U1), dtype=torch.float32)
    finally:
        P.tcfg.sqp.lin_tangents = "analytic"
    assert bool(torch.isfinite(X1).all() and torch.isfinite(U1).all())
    assert float(s1[2].min()) > 0.0
    assert bool((s2[1] < s1[1]).all())
