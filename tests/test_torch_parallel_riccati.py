"""The port's associative-scan Riccati (qm_door_torch/solver/
parallel_riccati.py) against the JAX package's, float64 on the CPU. Its
suffix scan runs in another order than ``jax.lax.associative_scan`` (one
batched combine a level), so the two agree to rounding: the gains are held
to JAX's scan at 1e-10 on random LQ data and at 1e-9 on the projected trot
problem (N = 10, nx = nu = 30); to the port's own sequential sweep at 1e-8,
and at 1e-6 over a 96-node horizon, the bars of JAX's own
tests/test_parallel_riccati.py. Also: the scans against a sequential fold,
the forward rollout, the two K1 calls a backward pass makes (their shapes),
and sqp_iteration / SqpSolver.solve with riccati="parallel" against the
sequential sweep's."""
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qm_door_torch import convert
from qm_door_torch.solver import parallel_riccati as t_par
from qm_door_torch.solver import riccati as t_ric
from qm_door_torch.solver import transcription as t_tr
from qm_door_torch.solver.sqp import SqpSolver as TSqpSolver
from qm_door_torch.solver.sqp import sqp_iteration as t_sqp_iteration
from qm_door_tpu.solver import parallel_riccati as j_par
from qm_door_tpu.solver.transcription import ProjectedLq as JProjectedLq
from torch_parity import HORIZON, configs, to_np
from torch_parity import release_jax_executables  # noqa: F401 (autouse, module scope)

def _random_lq(rng, N, nx, nu):
    """tests/test_solver.py's random LQ recipe, as numpy fields."""
    def psd(n):
        A = rng.normal(size=(n, n))
        return A @ A.T + n * np.eye(n)

    return dict(A=rng.normal(size=(N, nx, nx)) * 0.3 + np.eye(nx),
                B=rng.normal(size=(N, nx, nu)), d=rng.normal(size=(N, nx)) * 0.1,
                lx=rng.normal(size=(N, nx)), lu=rng.normal(size=(N, nu)),
                lxx=np.stack([psd(nx) for _ in range(N)]),
                luu=np.stack([psd(nu) for _ in range(N)]),
                lux=rng.normal(size=(N, nu, nx)) * 0.1, lx_f=rng.normal(size=nx),
                lxx_f=psd(nx), p=np.zeros((N, nu)),
                Pu=np.broadcast_to(np.eye(nu), (N, nu, nu)).copy(), Px=np.zeros((N, nu, nx)))


def _both(d):
    """The same LQ data in both packages."""
    j_lq = JProjectedLq(**{k: jnp.asarray(v) for k, v in d.items()})
    return j_lq, convert.projected_lq_from_numpy(d, device="cpu")


@pytest.mark.parametrize("N,nx,nu", [(12, 5, 3), (67, 6, 4)])
def test_gains_match_jax(N, nx, nu):
    j_lq, t_lq = _both(_random_lq(np.random.default_rng(N), N, nx, nu))
    K, kff = jax.jit(j_par.parallel_riccati_backward)(j_lq)
    Kt, kt = t_par.parallel_riccati_backward(t_lq)
    np.testing.assert_allclose(to_np(Kt), np.asarray(K), rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(to_np(kt), np.asarray(kff), rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("N,nx,nu,tol", [(12, 5, 3, 1e-8), (96, 6, 4, 1e-6)])
def test_gains_match_the_sequential_sweep(N, nx, nu, tol):
    _, t_lq = _both(_random_lq(np.random.default_rng(N + 1), N, nx, nu))
    Kt, kt = t_par.parallel_riccati_backward(t_lq)
    Ks, ks, _, _ = t_ric.riccati_backward(t_lq)
    np.testing.assert_allclose(to_np(Kt), to_np(Ks), atol=tol)
    np.testing.assert_allclose(to_np(kt), to_np(ks), atol=tol)
    dx0 = torch.as_tensor(np.random.default_rng(0).normal(size=nx))
    np.testing.assert_allclose(to_np(t_ric.riccati_forward(t_lq, Kt, kt, dx0)[0]),
                               to_np(t_ric.riccati_forward(t_lq, Ks, ks, dx0)[0]), atol=tol)


@pytest.mark.parametrize("n", [1, 2, 5, 8, 9, 68])
def test_scans_match_a_sequential_fold(n):
    """Both scans with a non-commuting combine (affine maps) against a fold
    element by element."""
    rng = np.random.default_rng(n)
    A, b = torch.as_tensor(rng.normal(size=(n, 3, 3))), torch.as_tensor(rng.normal(size=(n, 3)))

    def comb(e1, e2):  # e1 first, then e2
        return e2[0] @ e1[0], (e2[0] @ e1[1][..., None])[..., 0] + e2[1]

    pre_A, pre_b = t_par.forward_scan(comb, (A, b))
    suf_A, suf_b = t_par.reverse_scan(comb, (A, b))
    for k in range(n):
        acc = (A[0], b[0])
        for j in range(1, k + 1):
            acc = comb(acc, (A[j], b[j]))
        np.testing.assert_allclose(to_np(pre_A[k]), to_np(acc[0]), rtol=1e-12, atol=1e-12)
        np.testing.assert_allclose(to_np(pre_b[k]), to_np(acc[1]), rtol=1e-12, atol=1e-12)
        acc = (A[k], b[k])
        for j in range(k + 1, n):
            acc = comb(acc, (A[j], b[j]))
        np.testing.assert_allclose(to_np(suf_A[k]), to_np(acc[0]), rtol=1e-12, atol=1e-12)
        np.testing.assert_allclose(to_np(suf_b[k]), to_np(acc[1]), rtol=1e-12, atol=1e-12)


def test_forward_rollout_matches_jax():
    rng = np.random.default_rng(17)
    A, b, x0 = rng.normal(size=(17, 4, 4)) * 0.4, rng.normal(size=(17, 4)), rng.normal(size=4)
    X = t_par.parallel_forward_rollout(*(torch.as_tensor(a) for a in (A, b, x0)))
    np.testing.assert_allclose(
        to_np(X), np.asarray(jax.jit(j_par.parallel_forward_rollout)(A, b, x0)), atol=1e-12)


@pytest.mark.parametrize("nu", [30, 36])
def test_two_k1_calls_a_backward_pass(monkeypatch, nu):
    """Completing the square at every stage is one K1 call of N x nu x
    (2 nx + 1); the gains one of N x nu x (nx + 1)."""
    calls = []
    solve = t_par.spd_solve

    def recording(A, Y, shift=0.0):
        calls.append(tuple(Y.shape))
        assert A.is_contiguous() and Y.is_contiguous()
        return solve(A, Y, shift)

    monkeypatch.setattr(t_par, "spd_solve", recording)
    _, t_lq = _both(_random_lq(np.random.default_rng(nu), 7, 30, nu))
    t_par.parallel_riccati_backward(t_lq)
    assert calls == [(7, nu, 61), (7, nu, 31)]


@pytest.fixture(scope="module")
def P():
    """The port's trot problem (N = 10, torch_parity's settings) at a
    perturbed iterate."""
    from qm_door_torch.models import kinematics, spatial
    from qm_door_torch.models.model import aliengo_z1
    from qm_door_torch.ocp.gait import GAIT_LIBRARY, GaitSchedule
    from qm_door_torch.ocp.problem import build_stage_data, make_ocp_config
    from qm_door_torch.ocp.reference import TargetTrajectories

    cfg = configs()[1]
    model = aliengo_z1(dtype=torch.float64, device="cpu")
    x0 = torch.as_tensor(cfg.initial_state())
    R_ee, p_ee = kinematics.ee_pose(model, x0[6:30])
    state = torch.cat([x0, p_ee, spatial.rot_to_quat(R_ee)])
    targets = TargetTrajectories.create(torch.tensor([0.0, 1e5], dtype=torch.float64),
                                        torch.stack([state, state]),
                                        torch.zeros(2, 30, dtype=torch.float64))
    sched = GaitSchedule()
    sched.insert_template(GAIT_LIBRARY["trot"], 0.0, 5.0)
    stage = build_stage_data(model, cfg, sched, targets, 0.0)
    N = int(round(HORIZON / cfg.sqp.dt))
    rng = np.random.default_rng(12)
    x = x0.numpy() + rng.normal(size=30) * 0.03
    Xp = np.tile(x, (N + 1, 1)) + rng.normal(size=(N + 1, 30)) * 0.01
    Up = to_np(stage.u_nom[:N]) + rng.normal(size=(N, 30))
    return SimpleNamespace(tcfg=cfg, tmodel=model, tocp=make_ocp_config(model, cfg), N=N,
                           tstage=stage, x=torch.as_tensor(x), Xp=torch.as_tensor(Xp),
                           Up=torch.as_tensor(Up))


def test_gains_on_the_projected_trot_problem_match_jax(P):
    """The port's linearized and projected problem at P's iterate (30 x 30
    at every node), its gains from the port's scan against JAX's scan on
    the same data and against the port's sequential sweep."""
    lq = t_tr.linearize_ocp(P.tmodel, P.tocp, P.tstage, P.tcfg.sqp.dt, P.Xp[None],
                            P.Up[None])
    lq = t_tr.LqProblem(**{k: v[0] for k, v in vars(lq).items()})
    t_plq = t_tr.project_ocp(lq, P.tstage, P.Up, shift=1e-5)
    j_plq = JProjectedLq(**{k: jnp.asarray(to_np(v)) for k, v in vars(t_plq).items()
                            if v is not None})
    K, kff = jax.jit(j_par.parallel_riccati_backward)(j_plq)
    Kt, kt = t_par.parallel_riccati_backward(t_plq)
    assert Kt.shape == (P.N, 30, 30)
    np.testing.assert_allclose(to_np(Kt), np.asarray(K), rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(to_np(kt), np.asarray(kff), rtol=1e-9, atol=1e-9)
    Ks, ks, _, _ = t_ric.riccati_backward(t_plq)
    np.testing.assert_allclose(to_np(Kt), to_np(Ks), rtol=1e-8, atol=1e-8)
    np.testing.assert_allclose(to_np(kt), to_np(ks), rtol=1e-8, atol=1e-8)


def test_sqp_iteration_and_solve_with_the_scan(P):
    """riccati="parallel" through sqp_iteration and SqpSolver.solve: the
    same steps as the sequential sweep's to 1e-9."""
    scan = TSqpSolver(P.tmodel, P.tocp, P.tcfg)
    cfg = P.tcfg.__class__()
    cfg.mpc.time_horizon, cfg.sqp.linesearch_steps = P.tcfg.mpc.time_horizon, 2
    cfg.sqp.riccati = "parallel"
    par = TSqpSolver(P.tmodel, P.tocp, cfg)
    args = (P.tmodel, P.tocp, P.tstage, P.tcfg.sqp.dt)
    x0, X, U = P.x, P.Xp, P.Up
    for a, b in zip(t_sqp_iteration(*args, par.settings, x0, X, U)[:2],
                    t_sqp_iteration(*args, scan.settings, x0, X, U)[:2]):
        np.testing.assert_allclose(to_np(a), to_np(b), rtol=1e-9, atol=1e-9)
    s_par, s_scan = par.solve(P.tstage, x0), scan.solve(P.tstage, x0)
    for f in ("X", "U", "cost", "constraint_violation"):
        np.testing.assert_allclose(to_np(getattr(s_par, f)), to_np(getattr(s_scan, f)),
                                   rtol=1e-9, atol=1e-9, err_msg=f)
