"""The torch port's AD branch of the linearization (lin_tangents "f32" and
"bf16") and the exact RK2 sensitivities (sensitivity "rk2"), float64 on the
CPU: each tangent x sensitivity pair against the JAX package at 1e-10 (the
bf16 sweeps: primals at 1e-10, A and B within 3e-2 of the port's own f64
result); and, at nu = 36, the port's analytic branch against its own f32 AD
branch at 1e-10, the guard of the EE-wrench term of the analytic q-Jacobian."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qm_door_torch.solver import transcription as t_tr
from qm_door_tpu.solver import transcription as j_tr
from torch_parity import Problem, ProblemFT, shared_reference, to_np
from torch_parity import release_jax_executables  # noqa: F401 (autouse, module scope)

LQ_FIELDS = ("A", "B", "d", "lx", "lu", "lxx", "luu", "lux", "cost", "g0", "Gx", "Gv",
             "lx_f", "lxx_f")
PRIMALS = ("d", "g0", "cost", "lu")  # lx carries the Gauss-Newton EE term, Je^T w e
TOL = dict(rtol=1e-10, atol=1e-10)


def _perturbed(P, seed=8):
    rng = np.random.default_rng(seed)
    return (P.X + rng.normal(size=P.X.shape) * 0.01,
            P.U + rng.normal(size=P.U.shape) * 1.0)


@pytest.fixture(scope="module")
def P():
    P = Problem(B=2, seed=5, x_scale=0.03)
    P.X, P.U = _perturbed(P)
    return P


def _t_lin(P, tangents, sensitivity):
    return t_tr.linearize_ocp(P.tmodel, P.tocp, P.tstage, P.tcfg.sqp.dt, P.t(P.X), P.t(P.U),
                              sensitivity=sensitivity, tangents=tangents)


def _j_lin(tmp_path_factory, P, tangents, sensitivity):
    """JAX's linearization of P's iterate, once per test run."""
    def compute():
        fn = jax.jit(jax.vmap(lambda X, U: j_tr.linearize_ocp(
            P.jmodel, P.jocp, P.jstage, P.jcfg.sqp.dt, X, U,
            sensitivity=sensitivity, tangents=tangents)))
        return fn(jnp.asarray(P.X), jnp.asarray(P.U))

    return shared_reference(tmp_path_factory, f"linearize_ocp {tangents} {sensitivity}",
                            compute, P.X, P.U)


@pytest.mark.parametrize("tangents,sensitivity", [
    ("f32", "frozen"), ("f32", "rk2"), ("analytic", "rk2")])
def test_linearize_matches_jax(tmp_path_factory, P, j_f32, tangents, sensitivity):
    t_lq = _t_lin(P, tangents, sensitivity)
    j_lq = j_f32 if (tangents, sensitivity) == ("f32", "frozen") else \
        _j_lin(tmp_path_factory, P, tangents, sensitivity)
    for f in LQ_FIELDS:
        np.testing.assert_allclose(to_np(getattr(t_lq, f)), np.asarray(getattr(j_lq, f)),
                                   err_msg=f, **TOL)


@pytest.fixture(scope="module")
def j_f32(tmp_path_factory, P):
    """JAX's f32 branch (frozen): its primals are those of either
    sensitivity and of the bf16 branch."""
    return _j_lin(tmp_path_factory, P, "f32", "frozen")


@pytest.mark.parametrize("tangents,sensitivity", [
    ("bf16", "frozen"), ("bf16", "rk2"), ("analytic_bf16", "rk2")])
def test_linearize_bf16_sweeps(P, j_f32, tangents, sensitivity):
    """The bf16 sweeps: primals exact (against the JAX f32 branch's, which
    the bf16 branch recomputes in the working dtype), A and B within bf16
    rounding of the port's own f64 result of the same branch family (bf16
    rounds at other places than in JAX, so they are not compared with
    JAX's elementwise)."""
    exact = "f32" if tangents == "bf16" else "analytic"
    lq = _t_lin(P, tangents, sensitivity)
    ref = _t_lin(P, exact, sensitivity)
    j_lq = j_f32 if tangents == "bf16" else None
    for f in PRIMALS:
        want = np.asarray(getattr(j_lq, f)) if j_lq is not None else to_np(getattr(ref, f))
        np.testing.assert_allclose(to_np(getattr(lq, f)), want, err_msg=f, **TOL)
    # the AD branch's rk2 B reads no stage-1 q-Jacobian: it stays exact
    traced = ("A",) if (tangents, sensitivity) == ("bf16", "rk2") else ("A", "B")
    for f in ("A", "B"):
        r = getattr(ref, f)
        scale = r.abs().amax(dim=(-2, -1), keepdim=True)
        err = (getattr(lq, f) - r).abs()
        assert bool((err <= 3e-2 * scale).all()), f
        if f in traced:
            assert float(err.max()) > 0.0, f"{f}: the bf16 sweep left no trace"
        else:
            np.testing.assert_allclose(to_np(getattr(lq, f)), to_np(r), err_msg=f, **TOL)


def test_ad_matches_the_jax_reference_node(P):
    """The f32 AD branch under rk2 against JAX's
    ``_node_linearization_reference`` (jacfwd of rk2_step, independent AD
    pipelines) at one node."""
    k, b = 3, 1
    x, u, xn = P.X[b, k], P.U[b, k], P.X[b, k + 1]
    ref = jax.jit(lambda x_, u_, xn_: j_tr._node_linearization_reference(
        P.jmodel, P.jocp, P.jstage, P.jcfg.sqp.dt, k, x_, u_, xn_))(
        jnp.asarray(x), jnp.asarray(u), jnp.asarray(xn))
    out = t_tr._node_linearization(P.tmodel, P.tocp, P.tcfg.sqp.dt, P.tstage.rows(k),
                                   P.t(x), P.t(u), P.t(xn), sensitivity="rk2", tangents="f32")
    for name, a, r in zip(("A", "B", "d", "l", "lx", "lu", "lxx", "luu", "lux", "g0", "Gx",
                           "Gv"), out, ref):
        np.testing.assert_allclose(to_np(a), np.asarray(r), err_msg=name, **TOL)


@pytest.fixture(scope="module")
def PF():
    return ProblemFT(B=2, seed=6, x_scale=0.03)


@pytest.mark.parametrize("sensitivity", ["frozen", "rk2"])
@pytest.mark.parametrize("wrench", ["off_grasp", "on_grasp"])
def test_analytic_matches_own_ad_at_nu36(PF, sensitivity, wrench):
    """At nu = 36 the analytic branch (with the EE-wrench term of the
    q-Jacobian) equals the AD branch, off the grasp (zero wrench) and on it
    (the wrench reference plus noise), under both sensitivities."""
    rng = np.random.default_rng(11)
    X = PF.X + rng.normal(size=PF.X.shape) * 0.01
    U = PF.U + rng.normal(size=PF.U.shape) * 1.0
    if wrench == "off_grasp":
        U[..., 30:36] = 0.0
    else:
        U[..., 30:36] = np.asarray(PF.wref[:PF.N]) + rng.normal(size=U.shape[:-1] + (6,))
    lin = {t: t_tr.linearize_ocp(PF.tmodel, PF.tocp, PF.tstage, PF.tcfg.sqp.dt, PF.t(X),
                                 PF.t(U), sensitivity=sensitivity, tangents=t)
           for t in ("analytic", "f32")}
    assert lin["f32"].B.shape[-1] == 36
    for f in LQ_FIELDS:
        np.testing.assert_allclose(to_np(getattr(lin["analytic"], f)),
                                   to_np(getattr(lin["f32"], f)), err_msg=f, **TOL)
    if wrench == "on_grasp":  # the wrench columns and term are really there
        assert float(lin["f32"].B[..., 30:36].abs().max()) > 0.0
        U0 = U.copy()
        U0[..., 30:36] = 0.0
        off = t_tr.linearize_ocp(PF.tmodel, PF.tocp, PF.tstage, PF.tcfg.sqp.dt, PF.t(X),
                                 PF.t(U0), sensitivity=sensitivity, tangents="analytic")
        assert float((off.A - lin["analytic"].A).abs().max()) > 1e-8
