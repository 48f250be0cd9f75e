"""The whole-body cascade's solvers, torch port against the JAX package in
float64 on the CPU: the slack-condensed level QP (wbc/qp.py:
solve_qp_slack_batched, its f32 active-set polish too), the null projector
and the batch-major hierarchy (wbc/hoqp.py). On the CPU every SPD solve
takes K1's plain version (ops/spd_solve.py:spd_solve_plain); the JAX side
runs backend "xla", as tests/test_wbc_batched.py runs it.

Tolerances: 1e-8 relative to the largest entry against the JAX function
of the same name (the target; the reference's own bars are 1e-6 and
5e-6), and the reference's 5e-6 against the stacked [z; v] solve
(JAX's solve_qp_batched) that the slack elimination replaces."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qm_door_torch.wbc import hoqp as t_hoqp
from qm_door_torch.wbc import qp as t_qp
from qm_door_tpu.wbc import hoqp as j_hoqp
from qm_door_tpu.wbc import qp as j_qp
from torch_parity import F64, to_np
from torch_parity import release_jax_executables  # noqa: F401 (autouse, module scope)

REL = 1e-8      # relative to max|ref|, against the JAX function
STACKED = 5e-6  # the reference's bar against the stacked oracle


def _rel(out, ref):
    out, ref = to_np(out), np.asarray(ref)
    return np.abs(out - ref).max() / max(np.abs(ref).max(), 1e-300)


def _t(a, dtype=F64):
    return torch.tensor(np.asarray(a), dtype=dtype)


def _slack_problem(seed, B, n, nv, mp):
    """The JAX tests' recipe (tests/test_wbc_batched.py:133-204)."""
    rng = np.random.default_rng(seed)
    Az = rng.normal(size=(B, n + 2, n))
    Hz = Az.swapaxes(-1, -2) @ Az + 1e-6 * np.eye(n)
    cz = rng.normal(size=(B, n))
    G1 = rng.normal(size=(B, nv, n))
    h1 = rng.normal(size=(B, nv)) + 0.5
    Gp = rng.normal(size=(B, mp, n))
    hp = rng.normal(size=(B, mp)) + 0.5
    return Hz, cz, G1, h1, Gp, hp


def _stacked(Hz, cz, G1, h1, Gp, hp):
    """The same level QP in the stacked [z; v] form of solve_qp_batched."""
    B, n = cz.shape
    nv, mp = G1.shape[1], Gp.shape[1]
    H = np.zeros((B, n + nv, n + nv))
    H[:, :n, :n] = Hz
    H[:, n:, n:] = np.eye(nv)
    c = np.concatenate([cz, np.zeros((B, nv))], axis=-1)
    eye = np.tile(np.eye(nv), (B, 1, 1))
    G = np.concatenate([np.concatenate([G1, -eye], axis=-1),
                        np.concatenate([np.zeros((B, nv, n)), -eye], axis=-1),
                        np.concatenate([Gp, np.zeros((B, mp, nv))], axis=-1)], axis=1)
    h = np.concatenate([h1, np.zeros((B, nv)), hp], axis=-1)
    return H, c, G, h


# (seed, B, n, nv, mp): the JAX tests' two shapes, then each empty group
SLACK_CASES = {
    "random": (7, 4, 9, 5, 3),
    "nv0": (8, 3, 6, 0, 4),
    "mp0": (9, 3, 6, 4, 0),
    "unconstrained": (10, 3, 6, 0, 0),
}


@pytest.mark.parametrize("case", sorted(SLACK_CASES))
def test_slack_qp_matches_jax(case):
    """The port's slack QP against JAX's (1e-8 relative) and against the
    stacked oracle (5e-6), with 40 iterations as the JAX tests run it."""
    prob = _slack_problem(*SLACK_CASES[case])
    z_j, v_j = j_qp.solve_qp_slack_batched(*(jnp.asarray(a) for a in prob), iters=40)
    z_t, v_t = t_qp.solve_qp_slack_batched(*(_t(a) for a in prob), iters=40)
    assert z_t.shape == z_j.shape and v_t.shape == v_j.shape
    assert _rel(z_t, z_j) <= REL
    if v_j.shape[-1]:
        assert _rel(v_t, v_j) <= REL
    if case != "unconstrained":
        sol = j_qp.solve_qp_batched(*(jnp.asarray(a) for a in _stacked(*prob)), iters=40)[0]
        n = prob[1].shape[-1]
        np.testing.assert_allclose(to_np(z_t), np.asarray(sol[:, :n]), atol=STACKED)
        np.testing.assert_allclose(to_np(v_t), np.asarray(sol[:, n:]), atol=STACKED)
    else:
        ref = np.linalg.solve(prob[0], -prob[1][..., None])[..., 0]
        np.testing.assert_allclose(to_np(z_t), ref, rtol=1e-6, atol=1e-8)


def test_slack_qp_f32_inactive_set_matches_jax():
    """float32 with no constraint active at the solution: the loop freezes
    at mu_tol and the polish (empty active set) is the unconstrained
    solve: the port's f32 result is within 1e-5 of JAX's and 1e-4 of the
    f64 solution (the loop's mu_tol bias), relative to max|z|."""
    Hz, cz, G1, h1, Gp, hp = _slack_problem(11, 4, 9, 5, 3)
    prob = (Hz, cz, G1, h1 + 1e3, Gp, hp + 1e3)
    z64 = j_qp.solve_qp_slack_batched(*(jnp.asarray(a) for a in prob))[0]
    z_j = j_qp.solve_qp_slack_batched(*(jnp.asarray(a, dtype=jnp.float32) for a in prob))[0]
    z_t = t_qp.solve_qp_slack_batched(*(_t(a, torch.float32) for a in prob))[0]
    assert z_t.dtype == torch.float32
    assert _rel(z_t, z_j) <= 1e-5
    assert _rel(z_t, z64) <= 1e-4


def test_slack_qp_f32_polish_is_feasible(monkeypatch):
    """float32 on the random recipe, where constraints are active: the
    polish is one more SPD solve after the loop's (iters + 1 in f32, iters
    in f64), and what it returns is finite and feasible to its gate's 1e-4
    in the original units. (Between two f32 implementations the polished
    point is not comparable elementwise: the penalty system's 1e6 weights
    leave it a few percent from the f64 solution in the JAX package too.)"""
    prob = _slack_problem(7, 4, 9, 5, 3)
    calls = []
    solve = t_qp.spd_solve
    monkeypatch.setattr(t_qp, "spd_solve", lambda *a: calls.append(a[0].dtype) or solve(*a))
    Hz, cz, G1, h1, Gp, hp = (_t(a, torch.float32) for a in prob)
    z, v = t_qp.solve_qp_slack_batched(Hz, cz, G1, h1, Gp, hp, iters=30)
    assert calls == [torch.float32] * 31
    calls.clear()
    t_qp.solve_qp_slack_batched(*(_t(a) for a in prob), iters=30)
    assert calls == [F64] * 30
    assert bool(torch.isfinite(z).all() and torch.isfinite(v).all())
    mv = lambda M, x: (M @ x[..., None])[..., 0]  # noqa: E731
    assert float((mv(G1, z) - v - h1).max()) < 1e-4
    assert float((-v).max()) < 1e-4
    assert float((mv(Gp, z) - hp).max()) < 1e-4


def test_null_projector_matches_jax():
    """The JAX tests' recipe (a masked row in every element) plus a tiny
    row (below row_tol of the largest: zeroed) and a duplicated row (rank
    deficiency the ridge absorbs), at 1e-8 relative; P projects A to ~0."""
    rng = np.random.default_rng(0)
    A = rng.normal(size=(4, 6, 12))
    A[:, 2] = 0.0
    A[1, 3] = 1e-14 * A[1, 4]
    A[2, 5] = A[2, 0]
    P_j = j_hoqp.null_projector_batched(jnp.asarray(A))
    P_t = t_hoqp.null_projector_batched(_t(A))
    assert _rel(P_t, P_j) <= REL
    assert np.abs(np.einsum("bij,bjk->bik", A, to_np(P_t))).max() < 1e-8


def test_null_projector_f32_takes_the_safe_ridge_where_the_thin_one_fails(monkeypatch):
    """Per element, a non-finite projector from the thin ridge is replaced
    by the safe ridge's; the others keep the thin one."""
    A = _t(np.random.default_rng(1).normal(size=(3, 4, 10)), torch.float32)
    thin = t_hoqp.null_projector_batched(A)
    calls = []
    solve = t_hoqp._spd_solve_b

    def poisoned(M, Y, shift):
        calls.append(M)
        X = solve(M, Y, shift)
        if len(calls) <= 2:   # the thin ridge's two solves: element 1 fails
            X = X.clone()
            X[1] = float("nan")
        return X

    monkeypatch.setattr(t_hoqp, "_spd_solve_b", poisoned)
    P = t_hoqp.null_projector_batched(A)
    assert len(calls) == 4 and bool(torch.isfinite(P).all())
    assert torch.equal(P[0], thin[0]) and torch.equal(P[2], thin[2])
    monkeypatch.setattr(t_hoqp, "_spd_solve_b", solve)
    safe = t_hoqp.null_projector_batched(A, ridge=1e-5)
    assert torch.equal(P[1], safe[1])


def test_solve_hierarchy_matches_jax():
    """The JAX tests' recipe (three levels, inequalities at level 0 only),
    and a second level with its own inequalities, at 1e-8 relative."""
    rng = np.random.default_rng(0)
    B, n = 5, 10
    for levels in ([(4, 6), (3, 0), (2, 0)], [(4, 6), (3, 2), (2, 0)]):
        tasks = []
        for r, q in levels:
            tasks.append((rng.normal(size=(B, r, n)), rng.normal(size=(B, r)),
                          rng.normal(size=(B, q, n)), rng.uniform(0.5, 2.0, size=(B, q))))
        x_j = j_hoqp.solve_hierarchy_batched(
            [j_hoqp.Task(*(jnp.asarray(a) for a in t)) for t in tasks])
        x_t = t_hoqp.solve_hierarchy_batched([t_hoqp.Task(*(_t(a) for a in t)) for t in tasks])
        assert _rel(x_t, x_j) <= REL, levels
