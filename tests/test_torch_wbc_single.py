"""The single-problem whole-body QP cascade, torch port against the JAX
package on the CPU: wbc/qp.py's stacked solve_qp and solve_qp_batched (on
tests/test_wbc.py's and tests/test_wbc_batched.py's cases, float64 and
float32 with the polish), wbc/hoqp.py's null_space_masked, null_projector
and solve_hierarchy (projector and SVD null spaces, against JAX and each
other), and the single-robot ticks: hierarchical_wbc (use_arm_init on and
off, arm_locked), hierarchical_mpc_wbc and hierarchical_wbc_ft (wrench
priority 0 and 2), each against JAX and equal to the batched tick's row on
the same inputs.

The ticks' JAX references are the controller ticks' (torch_parity.
jax_tick_references: the WBC output of JAX's jitted QmController tick on
the policy point it evaluated), so no tick is compiled twice in a run.

Tolerances, float64: 1e-9 relative to the largest entry for the QPs and the
projector. The cascade's solution is not unique where its stack leaves
directions free (tests/test_wbc.py:251-252), and with the projector JAX's
own single and batched cascades differ by up to 4.4e-7 of max|x| on these
stacks (the reference holds them at 2e-6, tests/test_wbc_batched.py:67):
so the cascade is held on what each level minimizes, its residual
(||A_l x - b_l||^2 + ||max(D_l x - f_l, 0)||^2)^(1/2), within 1e-9 of
max(1, ||b_l||) with the projector and 1e-6 with the SVD (whose rank cut
at rel_tol may fall differently in two LAPACK builds: 1.5e-7 measured on
the trot stack), and with the projector also x within 1e-5 of max|x|
(4.1e-6 measured). The ticks at torch_parity.TICK_BAR (1e-8 of max|cmd|;
TICK_BAR_ARM_INIT on the arm-init stack), against JAX and against the
batched tick's row. Float32 QPs (the polish included) land 1-4% of max|z|
from the float64 solution in the JAX package too: the port's float32
solve is held to the float64 one within twice JAX's float32 deviation,
finite and feasible to the polish gate's 1e-4."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qm_door_torch import config as t_config
from qm_door_torch.models import centroidal as t_cen
from qm_door_torch.models.model import aliengo_z1 as t_aliengo_z1
from qm_door_torch.runtime.controller import QmController
from qm_door_torch.wbc import force as t_force
from qm_door_torch.wbc import hoqp as t_hoqp
from qm_door_torch.wbc import qp as t_qp
from qm_door_torch.wbc import tasks as t_tasks
from qm_door_torch.wbc import wbc as t_wbc
from qm_door_tpu.config import default_config
from qm_door_tpu.wbc import hoqp as j_hoqp
from qm_door_tpu.wbc import qp as j_qp
from torch_parity import (F64, TICK_BAR, TICK_BAR_ARM_INIT, TICK_GATES, TICK_GRASP, TICK_PERIOD,
                          TICK_TIMES, TICK_VARIANTS, jax_tick_references, shared_reference,
                          tick_config, tick_inputs, to_np)
from torch_parity import release_jax_executables  # noqa: F401 (autouse, module scope)

REL = 1e-9
CASCADE_X = 1e-5
RES_BAR = {"projector": 1e-9, "svd": 1e-6}


def _t(a, dtype=F64):
    return torch.tensor(np.asarray(a), dtype=dtype)


def _rel(out, ref):
    out, ref = to_np(out), np.asarray(ref, dtype=np.float64)
    return np.abs(out - ref).max() / max(np.abs(ref).max(), 1e-300)


def _random_qp(rng, n, m):
    """tests/test_wbc.py:_random_qp."""
    A = rng.normal(size=(n, n))
    return (A @ A.T + n * np.eye(n), rng.normal(size=n), rng.normal(size=(m, n)),
            rng.normal(size=m) + 2.0)


def _stacked_qp(rng, n=9, nv=5, mp=3):
    """tests/test_wbc_batched.py::test_slack_qp_matches_stacked's level QP,
    one element, as the condensed form's inputs and the stacked [z; v]
    form."""
    Az = rng.normal(size=(n + 2, n))
    Hz = Az.T @ Az + 1e-6 * np.eye(n)
    cz, G1, h1 = rng.normal(size=n), rng.normal(size=(nv, n)), rng.normal(size=nv) + 0.5
    Gp, hp = rng.normal(size=(mp, n)), rng.normal(size=mp) + 0.5
    H = np.zeros((n + nv, n + nv))
    H[:n, :n], H[n:, n:] = Hz, np.eye(nv)
    G = np.block([[G1, -np.eye(nv)], [np.zeros((nv, n)), -np.eye(nv)],
                  [Gp, np.zeros((mp, nv))]])
    stacked = (H, np.concatenate([cz, np.zeros(nv)]), G, np.concatenate([h1, np.zeros(nv), hp]))
    return (Hz, cz, G1, h1, Gp, hp), stacked


QP_CASES = {  # name -> (H, c, G, h)
    "random_8x12": lambda rng: _random_qp(rng, 8, 12),
    "kkt_20x30": lambda rng: _random_qp(rng, 20, 30),
    "stacked_14x13": lambda rng: _stacked_qp(rng)[1],
}


def _check_f32(out, H, c, G, h, ref64, ref32, what):
    """A float32 solve (z, lam, s) against the float64 reference: z within
    twice JAX's float32 deviation from it, finite, feasible to 1e-4."""
    z = to_np(out[0]).astype(np.float64)
    assert out[0].dtype == torch.float32 and np.isfinite(z).all(), what
    bar = 2 * _rel(ref32, ref64)
    assert _rel(z, ref64) <= bar, (what, _rel(z, ref64), bar)
    assert (np.einsum("...ij,...j->...i", G, z) - h).max() < 1e-4, what


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("case", list(QP_CASES))
def test_solve_qp_matches_jax(case, dtype):
    """solve_qp (iters 40, as tests/test_wbc.py) against JAX's: z, lam and s
    at 1e-9 in float64; in float32 (the polish) within twice JAX's own
    float32 deviation from its float64 solve."""
    H, c, G, h = QP_CASES[case](np.random.default_rng(0))
    ref = j_qp.solve_qp(*(jnp.asarray(a) for a in (H, c, G, h)), iters=40)
    if dtype == "float64":
        out = t_qp.solve_qp(*(_t(a) for a in (H, c, G, h)), iters=40)
        for name, o, r in zip(("z", "lam", "s"), out, ref):
            assert o.dtype == F64 and tuple(o.shape) == tuple(r.shape)
            assert _rel(o, r) <= REL, (case, name, _rel(o, r))
        return
    ref32 = j_qp.solve_qp(*(jnp.asarray(a, dtype=jnp.float32) for a in (H, c, G, h)), iters=40)
    out = t_qp.solve_qp(*(_t(a, torch.float32) for a in (H, c, G, h)), iters=40)
    _check_f32(out, H, c, G, h, ref[0], ref32[0], case)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_solve_qp_batched_matches_jax(dtype):
    """solve_qp_batched on tests/test_wbc_batched.py's B = 6, n = 10, m = 14
    case against JAX's batched solve (float64 1e-9; float32 as
    test_solve_qp_matches_jax), and each element equal to solve_qp on it
    alone (1e-9 in float64)."""
    rng = np.random.default_rng(1)
    B, n, m = 6, 10, 14
    L = rng.normal(size=(B, n, n))
    H = L @ np.swapaxes(L, -1, -2) + n * np.eye(n)
    c, G = rng.normal(size=(B, n)), rng.normal(size=(B, m, n))
    h = rng.uniform(0.5, 2.0, size=(B, m))
    ref = j_qp.solve_qp_batched(*(jnp.asarray(a) for a in (H, c, G, h)))
    if dtype == "float64":
        out = t_qp.solve_qp_batched(*(_t(a) for a in (H, c, G, h)))
        for name, o, r in zip(("z", "lam", "s"), out, ref):
            assert _rel(o, r) <= REL, (name, _rel(o, r))
        one = t_qp.solve_qp(*(_t(a[2]) for a in (H, c, G, h)))
        assert _rel(out[0][2], one[0]) <= REL
        return
    ref32 = j_qp.solve_qp_batched(*(jnp.asarray(a, dtype=jnp.float32) for a in (H, c, G, h)))
    out = t_qp.solve_qp_batched(*(_t(a, torch.float32) for a in (H, c, G, h)))
    _check_f32(out, H, c, G, h, ref[0], ref32[0], "batched")


def test_slack_qp_matches_the_stacked_form():
    """The condensed level QP (solve_qp_slack_batched, the cascade's) and the
    stacked [z; v] form through solve_qp_batched land on the same
    minimizer (tests/test_wbc_batched.py's equivalence, 5e-6)."""
    rng = np.random.default_rng(7)
    parts = [_stacked_qp(rng) for _ in range(4)]
    cond = [np.stack([p[0][i] for p in parts]) for i in range(6)]
    stacked = [np.stack([p[1][i] for p in parts]) for i in range(4)]
    z_s, v_s = t_qp.solve_qp_slack_batched(*(_t(a) for a in cond), iters=40)
    sol, _, _ = t_qp.solve_qp_batched(*(_t(a) for a in stacked), iters=40)
    n = z_s.shape[-1]
    np.testing.assert_allclose(to_np(z_s), to_np(sol[:, :n]), atol=5e-6)
    np.testing.assert_allclose(to_np(v_s), to_np(sol[:, n:]), atol=5e-6)


def test_null_space_masked_matches_jax():
    """null_space_masked on tests/test_wbc.py's (3, 8) matrix with a masked
    row, and on a batch of (5, 12) ones: the projector Z Z^T and the live
    column count against JAX's (an SVD basis is not unique), and M Z = 0."""
    rng = np.random.default_rng(2)
    M = rng.normal(size=(3, 8))
    M[1] = 0.0
    Mb = rng.normal(size=(4, 5, 12))
    Mb[:, 2] = 0.0
    Mb[1, 3] = 1e-12 * Mb[1, 3]
    for m in (M, *Mb):
        ref = np.asarray(j_hoqp.null_space_masked(jnp.asarray(m)))
        out = to_np(t_hoqp.null_space_masked(_t(m)))
        np.testing.assert_allclose(out @ out.T, ref @ ref.T, rtol=0, atol=1e-10)
        live = lambda Z: int((np.linalg.norm(Z, axis=0) > 1e-9).sum())  # noqa: E731
        assert live(out) == live(ref) == m.shape[1] - np.linalg.matrix_rank(m, tol=1e-9)
        np.testing.assert_allclose(m @ out, 0.0, atol=1e-10)
    batched = to_np(t_hoqp.null_space_masked(_t(Mb)))
    for i, m in enumerate(Mb):
        one = to_np(t_hoqp.null_space_masked(_t(m)))
        np.testing.assert_allclose(batched[i] @ batched[i].T, one @ one.T, atol=1e-12)


def test_null_projector_matches_jax():
    """null_projector on a (5, 12) matrix with a masked row and on a (30,
    36) WBC-like stack with dead rows, against JAX's (1e-9), and equal to
    null_projector_batched's element."""
    rng = np.random.default_rng(3)
    A1 = rng.normal(size=(5, 12))
    A1[2] = 0.0
    A2 = rng.normal(size=(30, 36)) * np.logspace(-1, 1, 30)[:, None]
    A2[20:] = 0.0
    for A in (A1, A2):
        ref = j_hoqp.null_projector(jnp.asarray(A))
        out = t_hoqp.null_projector(_t(A))
        assert _rel(out, ref) <= REL
        np.testing.assert_allclose(to_np(out), to_np(t_hoqp.null_projector_batched(_t(A)[None])[0]),
                                   rtol=0, atol=1e-14)


def _random_levels(rng, n, levels):
    return [tuple(a for a in (rng.normal(size=(r, n)), rng.normal(size=r),
                              rng.normal(size=(q, n)), rng.normal(size=q) + 3.0))
            for r, q in levels]


def _wbc_levels(flags):
    """tests/test_wbc.py::test_nullspace_backends_equivalent's stack at the
    nominal pose (float64 numpy), built with the port's task functions
    (tests/test_torch_wbc.py holds each against JAX's at 1e-10): both
    packages' cascades then solve the same matrices."""
    tm = t_aliengo_z1(dtype=F64, device="cpu")
    x0 = _t(default_config().initial_state())
    q0 = x0[6:30]
    rbd = t_cen.rbd_from_generalized(tm, q0, torch.zeros(24, dtype=F64))
    flags = _t(flags)
    u_des = t_cen.weight_compensating_input(tm, flags)
    Tm = t_tasks
    data = Tm.build_wbc_data(tm, x0, u_des, rbd, flags, torch.zeros(30, dtype=F64), 0.002)
    t0 = Tm.concat_tasks(Tm.floating_base_eom_task(data), Tm.torque_limits_task(data),
                         Tm.no_contact_motion_task(data), Tm.friction_cone_task(data, 0.3))
    t1 = Tm.concat_tasks(Tm.base_height_motion_task(data, 400.0, 140.0),
                         Tm.base_angular_motion_task(data, 400.0, 140.0),
                         Tm.scale_task(Tm.swing_leg_task(data, 350.0, 37.0), 100.0))
    return [tuple(to_np(a) for a in t) for t in (t0, t1, Tm.contact_force_task(data))]


HIERARCHIES = {
    "priorities_n6": lambda: _random_levels(np.random.default_rng(4), 6, [(2, 4), (3, 0)]),
    "three_levels_n10": lambda: _random_levels(np.random.default_rng(5), 10,
                                               [(4, 6), (3, 0), (2, 0)]),
    "wbc_stance": lambda: _wbc_levels([1.0, 1.0, 1.0, 1.0]),
    "wbc_trot": lambda: _wbc_levels([1.0, 0.0, 0.0, 1.0]),
}


def _level_residuals(levels, x):
    return np.array([np.sqrt(np.sum((A @ x - b) ** 2) + np.sum(np.maximum(D @ x - f, 0) ** 2))
                     for A, b, D, f in levels])


@pytest.mark.parametrize("case", list(HIERARCHIES))
def test_solve_hierarchy_matches_jax_with_either_null_space(case):
    """solve_hierarchy with nullspace "projector" and "svd" (qp_iters 40)
    against JAX's with the same null space: each level's residual within
    RES_BAR[nullspace] of max(1, ||b_l||), with the projector x within 1e-5
    of max|x|; and the two against each other as tests/test_wbc.py:248-258
    holds them: each level's equality residual within 1e-3, level 0's
    inequalities within 1e-6, on the WBC stacks the contact forces within
    1e-2."""
    levels = HIERARCHIES[case]()
    j_tasks_, t_tasks_ = ([cls(*(wrap(a) for a in lvl)) for lvl in levels]
                          for cls, wrap in ((j_hoqp.Task, jnp.asarray), (t_hoqp.Task, _t)))
    b_norm = np.array([max(1.0, np.linalg.norm(lvl[1])) for lvl in levels])
    xs = {}
    for ns in ("projector", "svd"):
        ref = np.asarray(j_hoqp.solve_hierarchy(j_tasks_, qp_iters=40, nullspace=ns))
        xs[ns] = to_np(t_hoqp.solve_hierarchy(t_tasks_, qp_iters=40, nullspace=ns))
        dres = np.abs(_level_residuals(levels, xs[ns]) - _level_residuals(levels, ref)) / b_norm
        assert dres.max() <= RES_BAR[ns], (case, ns, dres)
        if ns == "projector":
            assert _rel(xs[ns], ref) <= CASCADE_X, (case, _rel(xs[ns], ref))
    x_p, x_s = xs["projector"], xs["svd"]
    for A, b, _, _ in levels:
        assert abs(np.linalg.norm(A @ x_p - b) - np.linalg.norm(A @ x_s - b)) < 1e-3
    D0, f0 = levels[0][2], levels[0][3]
    assert (D0 @ x_p - f0).max() < 1e-6 and (D0 @ x_s - f0).max() < 1e-6
    if case.startswith("wbc"):
        np.testing.assert_allclose(x_p[24:], x_s[24:], atol=1e-2)


@pytest.mark.parametrize("variant", list(TICK_VARIANTS))
def test_single_ticks_match_jax_and_the_batched_row(tmp_path_factory, variant):
    """hierarchical_wbc (use_arm_init = t < arm_init_time; arm_locked),
    hierarchical_mpc_wbc or hierarchical_wbc_ft (wrench priority 0 / 2,
    grasp on and off) on the policy points JAX's controller ticks evaluated
    at TICK_TIMES: against JAX's WBC output of those ticks (TICK_BAR of
    max|cmd|, TICK_BAR_ARM_INIT on the arm-init stack), and each equal to
    its row of the batched tick over all three (the same bars)."""
    refs = shared_reference(tmp_path_factory, f"jax_ticks_{variant}",
                            lambda: jax_tick_references(variant))
    spec = TICK_VARIANTS[variant]
    tm = t_aliengo_z1(dtype=F64, device="cpu")
    cfg = tick_config(t_config, variant)
    gains = QmController(tm, cfg).gains
    a = tick_inputs(variant)
    rbd, flags, last = _t(a["rbd"]), _t(a["flags"]), _t(a["input_last"])
    state = t_wbc.WbcState(input_last=last)
    xs = _t(np.stack([refs[f"t{k}"]["x_opt"] for k in range(len(TICK_TIMES))]))
    us = _t(np.stack([refs[f"t{k}"]["u_opt"] for k in range(len(TICK_TIMES))]))
    arm_init = torch.tensor([t < TICK_GATES["arm_init_time"] for t in TICK_TIMES])
    B = len(TICK_TIMES)
    batch = (rbd.expand(B, -1), flags.expand(B, -1), t_wbc.WbcState(input_last=last.expand(B, -1)),
             TICK_PERIOD)
    if spec["force_tracking"]:
        wp = spec["wrench_priority"]
        singles = [t_force.hierarchical_wbc_ft(tm, gains, xs[k], us[k], rbd, flags,
                                               TICK_GRASP[k], state, TICK_PERIOD,
                                               wrench_priority=wp)[0] for k in range(B)]
        rows = t_force.hierarchical_wbc_ft_batched(
            tm, gains, xs, us, batch[0], batch[1], _t(TICK_GRASP), *batch[2:],
            wrench_priority=wp)[0]
    elif spec["separated"]:
        singles = [t_wbc.hierarchical_mpc_wbc(tm, gains, xs[k], us[k], rbd, flags, state,
                                              TICK_PERIOD)[0] for k in range(B)]
        rows = t_wbc.hierarchical_mpc_wbc_batched(tm, gains, xs, us, *batch)[0]
    else:
        lock = spec["arm_locked"]
        singles = [t_wbc.hierarchical_wbc(tm, gains, xs[k], us[k], rbd, flags, state,
                                          TICK_PERIOD, use_arm_init=arm_init[k],
                                          arm_locked=lock)[0] for k in range(B)]
        rows = t_wbc.hierarchical_wbc_batched(tm, gains, xs, us, *batch, use_arm_init=arm_init,
                                              arm_locked=lock)[0]
    for k in range(B):
        ref = refs[f"t{k}"]["wbc_cmd"]
        arm_stack = not spec["separated"] and not spec["force_tracking"] and bool(arm_init[k])
        bar = TICK_BAR_ARM_INIT if arm_stack else TICK_BAR
        assert _rel(singles[k], ref) <= bar, (variant, k, _rel(singles[k], ref))
        assert _rel(singles[k], rows[k]) <= bar, (variant, k, _rel(singles[k], rows[k]))


def test_wrench_priority_is_checked():
    """hierarchical_wbc_ft refuses a wrench priority other than 0 and 2, as
    JAX's does."""
    tm = t_aliengo_z1(dtype=F64, device="cpu")
    a = tick_inputs("ft_priority0")
    with pytest.raises(ValueError):
        t_force.hierarchical_wbc_ft(tm, default_config().wbc, _t(a["X"][0]), _t(a["U"][0]),
                                    _t(a["rbd"]), _t(a["flags"]), 1.0,
                                    t_wbc.WbcState(input_last=_t(a["input_last"])),
                                    TICK_PERIOD, wrench_priority=1)
    assert t_tasks.N_DEC == 36
