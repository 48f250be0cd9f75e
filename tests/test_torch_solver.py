"""Torch port's solver stages against the JAX package, float64 on the CPU:
linearize (analytic, frozen) per node at 1e-9, analytic_bf16 against the
port's own analytic result, the batched projection against both JAX
backends, and the Riccati solve and the lq_fused LQ stage against JAX's
XLA projection + Riccati solve, at 1e-9 / 1e-8; plus settings validation.
The JAX linearization and LQ solve are computed once per test run
(torch_parity.shared_reference)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qm_door_torch import convert
from qm_door_torch.parallel.batched import BatchedMpc as TBatchedMpc
from qm_door_torch.solver import transcription as t_tr
from qm_door_torch.solver.riccati import lqr_solve_batched as t_lqr
from qm_door_torch.solver.sqp import SqpSolver as TSqpSolver
from qm_door_torch.solver.sqp import _settings_static as t_settings
from qm_door_tpu.parallel.batched import BatchedMpc as JBatchedMpc
from qm_door_tpu.solver import transcription as j_tr
from qm_door_tpu.solver.riccati import lqr_solve_batched as j_lqr
from qm_door_tpu.solver.sqp import SqpSolver as JSqpSolver
from torch_parity import Problem, as_numpy_fields, shared_reference, to_np
from torch_parity import release_jax_executables  # noqa: F401 (autouse, module scope)

LQ_FIELDS = ("A", "B", "d", "lx", "lu", "lxx", "luu", "lux", "cost", "g0", "Gx", "Gv",
             "lx_f", "lxx_f")
PLQ_FIELDS = ("A", "B", "d", "lx", "lu", "lxx", "luu", "lux", "lx_f", "lxx_f", "p", "P",
              "Px_v", "force_mask")
TOL = dict(rtol=1e-9, atol=1e-9)


@pytest.fixture(scope="module")
def P():
    P = Problem(B=2, seed=5, x_scale=0.03)
    rng = np.random.default_rng(8)
    P.X = P.X + rng.normal(size=P.X.shape) * 0.01   # nothing at a special point
    P.U = P.U + rng.normal(size=P.U.shape) * 1.0
    return P


@pytest.fixture(scope="module")
def j_lq(tmp_path_factory, P):
    """JAX's linearization of P's iterate, once per test run."""
    def compute():
        fn = jax.jit(jax.vmap(lambda X, U: j_tr.linearize_ocp(
            P.jmodel, P.jocp, P.jstage, P.jcfg.sqp.dt, X, U,
            sensitivity="frozen", tangents="analytic")))
        return fn(jnp.asarray(P.X), jnp.asarray(P.U))

    return shared_reference(tmp_path_factory, "linearize_ocp analytic frozen", compute,
                            P.X, P.U)


@pytest.fixture(scope="module")
def t_lq(P):
    return t_tr.linearize_ocp(P.tmodel, P.tocp, P.tstage, P.tcfg.sqp.dt,
                              P.t(P.X), P.t(P.U), sensitivity="frozen", tangents="analytic")


@pytest.mark.parametrize("field", LQ_FIELDS)
def test_linearize_analytic_matches_jax(j_lq, t_lq, field):
    np.testing.assert_allclose(to_np(getattr(t_lq, field)), np.asarray(getattr(j_lq, field)),
                               err_msg=field, **TOL)


def test_linearize_takes_batched_trajectories_only(P):
    with pytest.raises(ValueError, match="B, N"):
        t_tr.linearize_ocp(P.tmodel, P.tocp, P.tstage, P.tcfg.sqp.dt,
                           P.t(P.X[1]), P.t(P.U[1]))


def test_linearize_analytic_bf16(P, j_lq, t_lq):
    """bf16 sweeps: primals exact; Jacobians within bf16 rounding of the
    port's own f64 analytic result (bf16 rounds at other places than in
    JAX, so A and B are not compared elementwise with JAX's)."""
    lq = t_tr.linearize_ocp(P.tmodel, P.tocp, P.tstage, P.tcfg.sqp.dt,
                            P.t(P.X), P.t(P.U), tangents="analytic_bf16")
    for f in ("d", "g0", "cost"):
        np.testing.assert_allclose(to_np(getattr(lq, f)), np.asarray(getattr(j_lq, f)),
                                   rtol=1e-10, atol=1e-10, err_msg=f)
    for f in ("A", "B"):
        ref = getattr(t_lq, f)
        scale = ref.abs().amax(dim=(-2, -1), keepdim=True)
        err = (getattr(lq, f) - ref).abs()
        assert bool((err <= 3e-2 * scale).all()), f
        assert float(err.max()) > 0.0, f"{f}: the bf16 sweep left no trace"


@pytest.fixture(scope="module")
def t_lq_from_jax(j_lq):
    return convert.lq_from_numpy(as_numpy_fields(j_lq), device="cpu")


@pytest.fixture(scope="module")
def flags(P):
    return np.broadcast_to(np.asarray(P.jstage.contact_flags[:P.N]), (2, P.N, 4))


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_project_batched_matches_jax(P, j_lq, t_lq_from_jax, flags, backend):
    j_plq = jax.jit(lambda lq, f, U: j_tr.project_ocp_batched(
        lq, f, U, shift=1e-5, backend=backend))(j_lq, jnp.asarray(flags), jnp.asarray(P.U))
    t_plq = t_tr.project_ocp_batched(t_lq_from_jax, P.t(flags), P.t(P.U), shift=1e-5)
    for f in PLQ_FIELDS:
        np.testing.assert_allclose(to_np(getattr(t_plq, f)), np.asarray(getattr(j_plq, f)),
                                   err_msg=f, **TOL)


@pytest.fixture(scope="module")
def j_lqr_out(tmp_path_factory, P, j_lq, flags):
    """JAX's batch-major projection and Riccati solve (XLA) on P's
    linearization, once per test run: (dX, dU, K, kff)."""
    dx0 = P.xb - P.X[:, 0]

    def j_fn(lq, f, U, dx0):
        plq = j_tr.project_ocp_batched(lq, f, U, shift=1e-5, backend="xla")
        return j_lqr(plq, dx0, backend="xla")

    return shared_reference(
        tmp_path_factory, "project_ocp_batched + lqr_solve_batched xla",
        lambda: jax.jit(j_fn)(j_lq, jnp.asarray(flags), jnp.asarray(P.U), jnp.asarray(dx0)),
        P.X, P.U, dx0)


def test_project_and_riccati_match_jax(P, j_lqr_out, t_lq_from_jax, flags):
    dx0 = P.xb - P.X[:, 0]
    j_out = j_lqr_out
    t_plq = t_tr.project_ocp_batched(t_lq_from_jax, P.t(flags), P.t(P.U), shift=1e-5)
    t_out = t_lqr(t_plq, P.t(dx0))
    for name, a, b in zip(("dX", "dU", "K", "kff"), t_out, j_out):
        np.testing.assert_allclose(to_np(a), np.asarray(b), err_msg=name, **TOL)


def test_lq_fused_stage_matches_jax_pallas_lq(P, j_lqr_out, t_lq_from_jax, flags):
    """The ``lq_fused`` backend's LQ stage (ops/lq.py, K3a-d) on the
    JAX-linearized trot problem, with the masks and force reference
    ``batched_sqp_iteration`` hands it, against the LQ stage of JAX's
    batch-major XLA path (the shared projection + Riccati solve), which
    ``pallas_lq.solve_lq_batched`` (JAX's ``pallas`` backend) equals
    (tests/test_pallas_lq.py); its four kernels are held in interpret mode
    at a small shape by tests/test_torch_lq_kernels.py."""
    from qm_door_torch.ops.lq import solve_lq_batched as t_solve
    from qm_door_tpu.ocp import constraints as j_cons

    dx0 = P.xb - P.X[:, 0]
    act = np.asarray(j_cons.velocity_row_mask(jnp.asarray(flags)))
    fm = np.repeat(flags, 3, axis=-1)
    dXj, dUj = j_lqr_out[:2]
    dX, dU = t_solve(t_lq_from_jax, P.t(act), P.t(fm), P.t(P.U[:, :, :12]), P.t(dx0),
                     shift=1e-5)
    tol = dict(rtol=1e-8, atol=1e-9)
    np.testing.assert_allclose(to_np(dX), np.asarray(dXj), err_msg="dX", **tol)
    np.testing.assert_allclose(to_np(dU), np.asarray(dUj), err_msg="dU", **tol)


@pytest.mark.parametrize("tangents,sensitivity,error", [
    ("analytc", "frozen", ValueError),
    ("", "frozen", ValueError),
    ("analytic", "exact", ValueError),
])
def test_linearization_settings_are_validated(P, tangents, sensitivity, error):
    cfg = P.tcfg.__class__()
    cfg.sqp.lin_tangents, cfg.sqp.sensitivity = tangents, sensitivity
    with pytest.raises(error):
        t_settings(cfg.sqp)
    with pytest.raises(error):
        TSqpSolver(P.tmodel, P.tocp, cfg)
    with pytest.raises(error):
        t_tr.linearize_ocp(P.tmodel, P.tocp, P.tstage, 0.015, P.t(P.X), P.t(P.U),
                           sensitivity=sensitivity, tangents=tangents)


def test_settings_and_cold_start_match_jax(P):
    js = JSqpSolver(P.jmodel, P.jocp, P.jcfg)
    ts = TSqpSolver(P.tmodel, P.tocp, P.tcfg)
    assert ts.n_intervals == js.n_intervals == P.N
    for f in ts.settings._fields:
        assert getattr(ts.settings, f) == getattr(js.settings, f), f
    for a, b in zip(ts.cold_start(P.tstage, P.t(P.xb[0])),
                    js.cold_start(P.jstage, jnp.asarray(P.xb[0]))):
        np.testing.assert_array_equal(to_np(a), np.asarray(b))
    for a, b in zip(TBatchedMpc(ts).cold_start(P.tstage, P.t(P.xb)),
                    JBatchedMpc(js).cold_start(P.jstage, jnp.asarray(P.xb))):
        np.testing.assert_array_equal(to_np(a), np.asarray(b))
