"""The torch port's force-tracking problem (nu = 36, the EE wrench as an
input) against the JAX package, float64 on the CPU: the flow map, the
ocp/force.py functions and the converter at 1e-10; the 36-wide
quadratization, analytic linearization and both projections at 1e-9 /
1e-10; the Riccati solve with the grasp gate; and the whole batched
iteration on the port's ``bm_k1`` and ``bm_fused`` against JAX ``bm_xla`` at
the JAX test's own bar (tests/test_batched_sqp.py), rtol 1e-8 / atol 1e-9,
with the off-grasp wrench exactly 0; the per-scenario iteration against the
same JAX result. The JAX linearization and iteration are computed once per
test run (torch_parity.shared_reference); JAX's own tests hold its
``bm_fused`` iteration to ``bm_xla``, and tests/test_torch_riccati_fused.py
holds its K2 kernel in interpret mode at nu = 36."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qm_door_torch import convert
from qm_door_torch.models import centroidal as t_cen
from qm_door_torch.ocp import force as t_force
from qm_door_torch.ocp import problem as t_prob
from qm_door_torch.solver import batched_sqp as t_bsqp
from qm_door_torch.solver import projection as t_proj
from qm_door_torch.solver import transcription as t_tr
from qm_door_torch.solver.riccati import lqr_solve_batched as t_lqr
from qm_door_torch.solver.sqp import _settings_static as t_settings
from qm_door_torch.solver.sqp import sqp_iteration as t_sqp_iteration
from qm_door_tpu.models import centroidal as j_cen
from qm_door_tpu.ocp import force as j_force
from qm_door_tpu.ocp import problem as j_prob
from qm_door_tpu.solver import batched_sqp as j_bsqp
from qm_door_tpu.solver import projection as j_proj
from qm_door_tpu.solver import transcription as j_tr
from qm_door_tpu.solver.riccati import lqr_solve_batched as j_lqr
from qm_door_tpu.solver.sqp import _settings_static as j_settings
from torch_parity import F64, ProblemFT, as_numpy_fields, shared_reference, to_np
from torch_parity import release_jax_executables  # noqa: F401 (autouse, module scope)

LQ_FIELDS = ("A", "B", "d", "lx", "lu", "lxx", "luu", "lux", "cost", "g0", "Gx", "Gv",
             "lx_f", "lxx_f")
PLQ_FIELDS = ("A", "B", "d", "lx", "lu", "lxx", "luu", "lux", "lx_f", "lxx_f", "p", "P",
              "Px_v", "force_mask", "grasp_gate")
TOL = dict(rtol=1e-10, atol=1e-10)
TOL9 = dict(rtol=1e-9, atol=1e-9)
ITER_TOL = dict(rtol=1e-8, atol=1e-9)


def _close(t_out, j_out, tol=TOL, msg=""):
    if isinstance(j_out, (tuple, list)):
        for i, (a, b) in enumerate(zip(t_out, j_out)):
            _close(a, b, tol, f"{msg}[{i}]")
        return
    np.testing.assert_allclose(to_np(t_out), np.asarray(j_out), err_msg=msg, **tol)


@pytest.fixture(scope="module")
def P():
    return ProblemFT(B=2, seed=5, x_scale=0.03)


@pytest.fixture(scope="module")
def XU(P):
    """A perturbed iterate, the wrench set to its reference plus noise."""
    rng = np.random.default_rng(8)
    X = P.X + rng.normal(size=P.X.shape) * 0.01
    U = P.U + rng.normal(size=P.U.shape) * 1.0
    U[..., 30:36] = P.wref[:P.N] + rng.normal(size=U.shape[:-1] + (6,))
    return X, U


def test_flow_map_ft_matches_jax(P):
    rng = np.random.default_rng(2)
    x = np.asarray(P.jcfg.initial_state())[None] + rng.normal(size=(5, 30)) * 0.1
    u = rng.normal(size=(5, 36)) * 5.0
    _close(t_cen.flow_map_ft(P.tmodel, P.t(x), P.t(u)),
           jax.jit(jax.vmap(lambda a, b: j_cen.flow_map_ft(P.jmodel, a, b)))(x, u))
    _close(t_cen.flow_map_any(P.tmodel, P.t(x), P.t(u)),
           jax.vmap(lambda a, b: j_cen.flow_map_any(P.jmodel, a, b))(x, u))
    np.testing.assert_array_equal(to_np(t_cen.ee_wrench(P.t(u))), u[:, 30:36])
    # the 30-input flow map where the wrench is zero
    u0 = u.copy()
    u0[:, 30:36] = 0.0
    _close(t_cen.flow_map_any(P.tmodel, P.t(x), P.t(u0)),
           to_np(t_cen.flow_map(P.tmodel, P.t(x), P.t(u0[:, :30]))))


def test_force_config_and_stage_match_jax(P):
    _close(P.tocp.R, P.jocp.R)
    assert P.tocp.R.shape == (36, 36)
    for name in ("times", "contact_flags", "x_nom", "u_nom", "grasp_flags"):
        _close(getattr(P.tstage, name), getattr(P.jstage, name), msg=name)
    flags = np.asarray(P.jstage.contact_flags)
    _close(t_force.weight_compensating_input_ft(P.tmodel, P.t(flags)),
           jax.vmap(lambda f: j_force.weight_compensating_input_ft(P.jmodel, f))(flags))


def test_build_stage_data_ft_matches_jax(P):
    from qm_door_torch.ocp.gait import GAIT_LIBRARY as T_GAITS
    from qm_door_torch.ocp.gait import GaitSchedule as TGaitSchedule
    from qm_door_tpu.ocp.gait import GAIT_LIBRARY as J_GAITS
    from qm_door_tpu.ocp.gait import GaitSchedule as JGaitSchedule

    grasp_fn = lambda t: (np.asarray(t) >= 0.4).astype(float)  # noqa: E731
    wrench_fn = lambda t: np.outer(np.cos(np.asarray(t)), [1.0, -2.0, 3.0, 0.1, 0.2, 0.3])  # noqa
    out = []
    for lib, Sched, force, model, cfg, targets in (
            (J_GAITS, JGaitSchedule, j_force, P.jmodel, P.jcfg, P.jtargets),
            (T_GAITS, TGaitSchedule, t_force, P.tmodel, P.tcfg, P.ttargets)):
        s = Sched()
        s.insert_template(lib["trot"], 0.0, 5.0)
        out.append(force.build_stage_data_ft(model, cfg, s, targets, 0.3, grasp_fn, wrench_fn))
    js, ts = out
    assert 0.0 < float(ts.grasp_flags.mean()) < 1.0
    for name in ("times", "contact_flags", "u_nom", "grasp_flags", "ee_pos_ref"):
        _close(getattr(ts, name), getattr(js, name), msg=name)


def test_convert_carries_force_tracking(P):
    ocp = convert.ocp_config_from_numpy(as_numpy_fields(P.jocp), device="cpu")
    stage = convert.stage_data_from_numpy(as_numpy_fields(P.jstage), device="cpu")
    np.testing.assert_array_equal(to_np(ocp.R), np.asarray(P.jocp.R))
    np.testing.assert_array_equal(to_np(stage.grasp_flags), np.asarray(P.jstage.grasp_flags))
    assert stage.u_nom.shape[-1] == 36 and ocp.wrench_lower is None


WRENCH_BOX = (np.array([-80.0, -80.0, -80.0, -15.0, -15.0, -15.0]),
              np.array([80.0, 80.0, 80.0, 15.0, 15.0, 15.0]))


@pytest.mark.parametrize("box", ["none", "wrench_box"])
def test_stage_cost_and_quadratization_36_match_jax(P, XU, box):
    """The 36-wide stage cost and quadratization at three nodes (one off the
    grasp), without and with the EE-wrench soft box, the box near its bound."""
    jocp, tocp = P.jocp, P.tocp
    X, U = XU[0][0], XU[1][0].copy()
    if box == "wrench_box":
        lo, hi = WRENCH_BOX
        jocp = jocp.replace(wrench_lower=jnp.asarray(lo), wrench_upper=jnp.asarray(hi))
        tocp = dataclasses.replace(tocp, wrench_lower=P.t(lo), wrench_upper=P.t(hi))
        U[:, 33] = 14.9995  # inside the barrier's quadratic extension
    for k in (0, 5, P.N - 1):
        row = P.tstage.rows(k)
        x, u = P.t(X[k]), P.t(U[k])
        _close(t_prob.stage_cost(P.tmodel, tocp, row, x, u),
               j_prob.stage_cost(P.jmodel, jocp, P.jstage, k, jnp.asarray(X[k]),
                                 jnp.asarray(U[k])))
        j_q = jax.jit(lambda a, b: j_prob.quadratize_stage(P.jmodel, jocp, P.jstage, k, a, b))
        _close(t_prob.quadratize_stage(P.tmodel, tocp, row, x, u),
               j_q(jnp.asarray(X[k]), jnp.asarray(U[k])))


@pytest.fixture(scope="module")
def j_lq(tmp_path_factory, P, XU):
    def compute():
        fn = jax.jit(jax.vmap(lambda X, U: j_tr.linearize_ocp(
            P.jmodel, P.jocp, P.jstage, P.jcfg.sqp.dt, X, U,
            sensitivity="frozen", tangents="analytic")))
        return fn(jnp.asarray(XU[0]), jnp.asarray(XU[1]))

    return shared_reference(tmp_path_factory, "linearize_ocp ft analytic frozen", compute,
                            *XU, P.grasp)


def test_linearize_analytic_36_matches_jax(P, XU, j_lq):
    t_lq = t_tr.linearize_ocp(P.tmodel, P.tocp, P.tstage, P.tcfg.sqp.dt, P.t(XU[0]),
                              P.t(XU[1]), sensitivity="frozen", tangents="analytic")
    assert t_lq.B.shape[-1] == 36
    for f in LQ_FIELDS:
        _close(getattr(t_lq, f), getattr(j_lq, f), TOL9, f)


@pytest.fixture(scope="module")
def t_lq(j_lq):
    return convert.lq_from_numpy(as_numpy_fields(j_lq), device="cpu")


def test_project_node_chol_ft_matches_jax(P, XU, j_lq, t_lq):
    b = 1
    N = P.N
    args = (np.asarray(P.jstage.contact_flags[:N]), P.grasp[:N], XU[1][b, :, 0:12],
            XU[1][b, :, 30:36])
    j_out = jax.vmap(lambda f, g, F, W, g0, Gx, Gv: j_proj.project_node_chol_ft(
        f, g, F, W, g0, Gx, Gv, 1e-5))(*args, j_lq.g0[b], j_lq.Gx[b], j_lq.Gv[b])
    t_out = t_proj.project_node_chol_ft(*(P.t(a) for a in args), t_lq.g0[b], t_lq.Gx[b],
                                        t_lq.Gv[b], 1e-5)
    _close(t_out, j_out)


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_project_batched_36_matches_jax(P, XU, j_lq, t_lq, backend):
    flags = np.broadcast_to(np.asarray(P.jstage.contact_flags[:P.N]), (2, P.N, 4))
    grasp = np.broadcast_to(P.grasp[:P.N], (2, P.N))
    j_plq = jax.jit(lambda lq, f, U, g: j_tr.project_ocp_batched(
        lq, f, U, shift=1e-5, grasp=g, backend=backend))(j_lq, flags, XU[1], grasp)
    t_plq = t_tr.project_ocp_batched(t_lq, P.t(flags), P.t(XU[1]), shift=1e-5,
                                     grasp=P.t(grasp))
    for f in PLQ_FIELDS:
        _close(getattr(t_plq, f), getattr(j_plq, f), TOL9, f)
    with pytest.raises(ValueError, match="grasp"):
        t_tr.project_ocp_batched(t_lq, P.t(flags), P.t(XU[1]), shift=1e-5)


@pytest.mark.parametrize("backend", ["k1", "fused"])
def test_riccati_recovers_the_wrench_through_the_gate(tmp_path_factory, P, XU, j_lq, t_lq,
                                                     backend):
    """Backward sweep (K1 scan or K2 plain) and forward rollout with the
    grasp gate against JAX (one XLA solve a run, both backends held to it);
    the off-grasp wrench delta is exactly -W."""
    flags = np.broadcast_to(np.asarray(P.jstage.contact_flags[:P.N]), (2, P.N, 4))
    grasp = np.broadcast_to(P.grasp[:P.N], (2, P.N))
    dx0 = P.xb - XU[0][:, 0]
    j_out = shared_reference(
        tmp_path_factory, "project_ocp_batched + lqr_solve_batched ft xla",
        lambda: jax.jit(lambda lq, f, U, g, dx: j_lqr(j_tr.project_ocp_batched(
            lq, f, U, shift=1e-5, grasp=g, backend="xla"), dx, backend="xla"))(
            j_lq, flags, XU[1], grasp, dx0), *XU, grasp, dx0)
    t_plq = t_tr.project_ocp_batched(t_lq, P.t(flags), P.t(XU[1]), shift=1e-5,
                                     grasp=P.t(grasp))
    t_out = t_lqr(t_plq, P.t(dx0), backend=backend)
    _close(t_out, j_out, TOL9)
    off = P.grasp[:P.N] < 0.5
    np.testing.assert_array_equal(to_np(t_out[1])[:, off, 30:36], -XU[1][:, off, 30:36])


def _t_iterate(P, backend, X, U, x=None):
    return t_bsqp.batched_sqp_iteration(
        P.tmodel, P.tocp, P.tstage, P.tcfg.sqp.dt, t_settings(P.tcfg.sqp),
        P.t(P.xb if x is None else x), P.t(X), P.t(U), backend=backend)


@pytest.fixture(scope="module")
def j_iter(tmp_path_factory, P):
    """JAX bm_xla from the cold (zero-wrench) iterate, at B = 2."""
    def compute():
        settings = j_settings(P.jcfg.sqp)
        fn = jax.jit(lambda x, X, U: j_bsqp.batched_sqp_iteration(
            P.jmodel, P.jocp, P.jstage, P.jcfg.sqp.dt, settings, x, X, U, backend="bm_xla"))
        return fn(jnp.asarray(P.xb), jnp.asarray(P.X), jnp.asarray(P.U))

    return shared_reference(tmp_path_factory, "batched_sqp_iteration ft bm_xla", compute,
                            P.xb, P.X, P.U, P.grasp)


def _check_iterate(P, out, ref):
    Xt, Ut, st = out
    Xj, Uj, sj = ref
    _close(Xt, Xj, ITER_TOL, "X")
    _close(Ut, Uj, ITER_TOL, "U")
    _close(st, sj, ITER_TOL, "stats")
    assert float(st[2].min()) > 0.0  # a real move
    off = P.grasp[:P.N] < 0.5
    assert off.any() and (~off).any()
    np.testing.assert_array_equal(to_np(Ut)[:, off, 30:36], 0.0)  # exactly
    assert float(Ut[:, ~off, 30:36].abs().max()) > 0.1


def test_iteration_36_bm_k1_matches_jax(P, j_iter):
    _check_iterate(P, _t_iterate(P, "bm_k1", P.X, P.U), j_iter)


def test_iteration_36_bm_fused_matches_jax_bm_fused(P, j_iter):
    _check_iterate(P, _t_iterate(P, "bm_fused", P.X, P.U), j_iter)


def test_per_scenario_iteration_36_matches_jax(P, j_iter):
    """The per-scenario sqp_iteration (dense projection, full linesearch
    sweep) of each scenario = the batched JAX iteration's row."""
    s = t_settings(P.tcfg.sqp)
    outs = [t_sqp_iteration(P.tmodel, P.tocp, P.tstage, P.tcfg.sqp.dt, s, P.t(P.xb[b]),
                            P.t(P.X[b]), P.t(P.U[b])) for b in range(2)]
    out = (torch.stack([o[0] for o in outs]), torch.stack([o[1] for o in outs]),
           tuple(torch.stack([o[2][i] for o in outs]) for i in range(3)))
    _check_iterate(P, out, j_iter)


def test_second_iteration_36_lowers_the_violation(P):
    X1, U1, s1 = _t_iterate(P, "bm_k1", P.X, P.U)
    _, U2, s2 = _t_iterate(P, "bm_k1", to_np(X1), to_np(U1))
    assert bool((s2[1] < s1[1]).all())
    off = P.grasp[:P.N] < 0.5
    np.testing.assert_array_equal(to_np(U2)[:, off, 30:36], 0.0)


def test_float32_iteration_36_tracks_float64(P):
    """The f32 working dtype at nu = 36 (K2's smem variant's width) stays
    within f32 roundoff of f64 on the CPU."""
    from qm_door_torch.ocp.force import make_ocp_config_ft

    tm = P.tmodel.to(dtype=torch.float32)
    stage = dataclasses.replace(
        P.tstage, **{k: v.to(torch.float32) for k, v in vars(P.tstage).items()})
    c = lambda a: torch.tensor(np.asarray(a), dtype=torch.float32)  # noqa: E731
    X32, U32, s32 = t_bsqp.batched_sqp_iteration(
        tm, make_ocp_config_ft(tm, P.tcfg), stage, P.tcfg.sqp.dt, t_settings(P.tcfg.sqp),
        c(P.xb), c(P.X), c(P.U), backend="bm_fused")
    X64, U64, _ = _t_iterate(P, "bm_fused", P.X, P.U)
    assert X32.dtype == torch.float32 and bool(torch.isfinite(X32).all())
    assert float((X32.double() - X64).abs().max()) < 1e-4
    assert float((U32.double() - U64).abs().max()) < 5e-2
    assert float(s32[2].min()) > 0.0
