"""The whole-body controller's tick, torch port against the JAX package on
the CPU: WbcData and every task (wbc/tasks.py, wbc/force.py), the nominal
36-variable tick (wbc/wbc.py:hierarchical_wbc_batched: as the bench runs
it, with use_arm_init and arm_locked) and the 42-variable force-tracking
tick (wbc/force.py:hierarchical_wbc_ft_batched: grasp on and off,
wrench_priority 0 and 2), and the convert.py carriers. The JAX side runs
backend "xla" in float64, as tests/test_wbc_batched.py runs it; each JAX
whole-tick reference is computed once per test function (the first call
compiles for ~50 s).

Tolerances: 1e-10 (rtol = atol) for WbcData and each task's A, b, D, f;
1e-8 relative to max|cmd| for the float64 ticks (the reference's own bar
is 1e-6). The float32 ticks are held to the reference's physical bars
(tests/test_wbc_batched.py:104-130): the level-0 EoM residual < 1e-2, and
with it the swing feet's forces < 1e-2 N, the level-0 inequalities within
1e-2 and the joint torques within effort_limit (1e-3 relative slack); and
levels 1 and 2 to the float64 tick: each level's residual within 0.02 and
0.2 of ||b_l|| of the float64 tick's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from qm_door_torch import config as t_config
from qm_door_torch import convert
from qm_door_torch.models import centroidal as t_cen
from qm_door_torch.models.model import aliengo_z1 as t_aliengo_z1
from qm_door_torch.wbc import force as t_force
from qm_door_torch.wbc import hoqp as t_hoqp
from qm_door_torch.wbc import qp as t_qp
from qm_door_torch.wbc import tasks as t_tasks
from qm_door_torch.wbc import wbc as t_wbc
from qm_door_tpu.config import default_config
from qm_door_tpu.models import aliengo_z1 as j_aliengo_z1
from qm_door_tpu.wbc import force as j_force
from qm_door_tpu.wbc import tasks as j_tasks
from qm_door_tpu.wbc import wbc as j_wbc
from torch_parity import F64, as_numpy_fields, to_np
from torch_parity import release_jax_executables  # noqa: F401 (autouse, module scope)

TOL = dict(rtol=1e-10, atol=1e-10)
TICK = 1e-8       # float64 ticks, relative to max|cmd|
EOM_BAR = 1e-2    # the reference's level-0 EoM residual bar (float32)
TAU_SLACK = 1e-3  # joint torques within effort_limit, relative (float32)
# levels 1, 2 in float32: |r_l(f32 tick) - r_l(f64 tick)| <= bar * ||b_l||, with
# r_l = hoqp.level_residuals on the float64 task data. Twice, rounded up,
# the JAX package's own float32 tick's largest deviation from its float64
# tick (backend "xla", B = 4 at the bench's inputs): 0.0084 and 0.094
LEVEL_BARS = (0.02, 0.2)
PERIOD = 0.002
B = 3
FLAGS = ((1.0, 0.0, 0.0, 1.0), (0.0, 1.0, 1.0, 0.0), (1.0, 1.0, 1.0, 1.0))
GRASP = (1.0, 0.0, 1.0)
WRENCH = (5.0, 0.0, 0.0, 0.0, 0.0, 0.5)


def _inputs(nu, seed=0):
    """B robots near the nominal pose, one contact pattern each: desired
    state and input (weight compensating, small joint velocities, the
    wrench at nu = 36), the measured rbd state (perturbed pose, random
    velocities), the last input; numpy float64."""
    rng = np.random.default_rng(seed)
    cfg = default_config()
    tm = t_aliengo_z1(dtype=F64, device="cpu")
    xs = cfg.initial_state()[None] + rng.normal(size=(B, 30)) * 0.01
    flags = np.asarray(FLAGS)
    us = to_np(t_cen.weight_compensating_input(tm, torch.as_tensor(flags)))
    us[:, 12:30] += rng.normal(size=(B, 18)) * 0.05
    if nu == 36:
        us = np.concatenate([us, np.tile(WRENCH, (B, 1))], axis=-1)
    q = xs[:, 6:30] + rng.normal(size=(B, 24)) * 0.01
    v = rng.normal(size=(B, 24)) * 0.1
    rbds = to_np(t_cen.rbd_from_generalized(tm, torch.as_tensor(q), torch.as_tensor(v)))
    last = us + rng.normal(size=us.shape) * 1e-3
    return xs, us, rbds, flags, last


def _j(arrays, dtype=jnp.float64):
    return [jnp.asarray(a, dtype=dtype) for a in arrays]


def _t(arrays, dtype=F64):
    return [torch.tensor(np.asarray(a), dtype=dtype) for a in arrays]


def _rel(out, ref):
    out, ref = to_np(out), np.asarray(ref)
    return np.abs(out - ref).max() / np.abs(ref).max()


def _close(out, ref, what):
    np.testing.assert_allclose(to_np(out), np.asarray(ref), err_msg=what, **TOL)


def _close_task(t_task, j_task, what):
    for name, a, b in zip("AbDf", t_task, j_task):
        assert tuple(a.shape) == tuple(b.shape), (what, name)
        _close(a, b, f"{what}.{name}")


def test_wbc_data_and_tasks_match_jax():
    """build_wbc_data (nu = 36: every field, the wrench too) against JAX's,
    vmapped; then every task function fed with JAX's WbcData through
    convert.wbc_data_from_numpy, against the same JAX task: 1e-10."""
    jm = j_aliengo_z1(dtype=jnp.float64)
    tm = t_aliengo_z1(dtype=F64, device="cpu")
    ws = default_config().wbc
    xs, us, rbds, flags, last = _inputs(36)
    # jitted: eager JAX takes twice the compile's time here
    jd = jax.jit(jax.vmap(lambda x, u, r, f, il: j_tasks.build_wbc_data(
        jm, x, u, r, f, il, PERIOD)))(*_j((xs, us, rbds, flags, last)))
    td = t_tasks.build_wbc_data(tm, *_t((xs, us, rbds, flags, last)), PERIOD)
    jfields = as_numpy_fields(jd)
    for name, ref in jfields.items():
        _close(getattr(td, name), ref, f"WbcData.{name}")

    d = convert.wbc_data_from_numpy(jfields, device="cpu")
    g = convert.wbc_gains_from_numpy(as_numpy_fields(ws), device="cpu")
    mu = ws.friction_coefficient
    kp, kd = ws.swing_kp, ws.swing_kd
    arm, ee_l, ee_a = ((np.asarray(a), np.asarray(b)) for a, b in (
        (ws.arm_joint_kp, ws.arm_joint_kd), (ws.ee_linear_kp, ws.ee_linear_kd),
        (ws.ee_angular_kp, ws.ee_angular_kd)))
    T, J = t_tasks, j_tasks
    cases = {  # name -> (torch task, JAX per-robot task)
        "floating_base_eom": (T.floating_base_eom_task(d), J.floating_base_eom_task),
        "torque_limits": (T.torque_limits_task(d), J.torque_limits_task),
        "no_contact_motion": (T.no_contact_motion_task(d), J.no_contact_motion_task),
        "friction_cone": (T.friction_cone_task(d, g.friction_coefficient),
                          lambda x: J.friction_cone_task(x, mu)),
        "base_linear_motion": (T.base_linear_motion_task(d, g.base_linear_kp, g.base_linear_kd),
                               lambda x: J.base_linear_motion_task(
                                   x, ws.base_linear_kp, ws.base_linear_kd)),
        "base_xy_linear_accel": (T.base_xy_linear_accel_task(d), J.base_xy_linear_accel_task),
        "base_height_motion": (T.base_height_motion_task(d, g.base_height_kp, g.base_height_kd),
                               lambda x: J.base_height_motion_task(
                                   x, ws.base_height_kp, ws.base_height_kd)),
        "base_angular_motion": (T.base_angular_motion_task(d, g.base_angular_kp,
                                                           g.base_angular_kd),
                                lambda x: J.base_angular_motion_task(
                                    x, ws.base_angular_kp, ws.base_angular_kd)),
        "swing_leg": (T.swing_leg_task(d, g.swing_kp, g.swing_kd),
                      lambda x: J.swing_leg_task(x, kp, kd)),
        "arm_joint_tracking": (T.arm_joint_tracking_task(d, g.arm_joint_kp, g.arm_joint_kd),
                               lambda x: J.arm_joint_tracking_task(x, *arm)),
        "ee_linear_tracking": (T.ee_linear_tracking_task(d, g.ee_linear_kp, g.ee_linear_kd),
                               lambda x: J.ee_linear_tracking_task(x, *ee_l)),
        "ee_angular_tracking": (T.ee_angular_tracking_task(d, g.ee_angular_kp, g.ee_angular_kd),
                                lambda x: J.ee_angular_tracking_task(x, *ee_a)),
        "contact_force": (T.contact_force_task(d), J.contact_force_task),
        "scaled_swing_leg": (T.scale_task(T.swing_leg_task(d, g.swing_kp, g.swing_kd),
                                          g.swing_task_weight),
                             lambda x: J.scale_task(J.swing_leg_task(x, kp, kd),
                                                    ws.swing_task_weight)),
        "concat": (T.concat_tasks(T.floating_base_eom_task(d), T.torque_limits_task(d),
                                  T.contact_force_task(d)),
                   lambda x: J.concat_tasks(J.floating_base_eom_task(x),
                                            J.torque_limits_task(x),
                                            J.contact_force_task(x))),
        "floating_base_eom_ft": (t_force.floating_base_eom_task_ft(d),
                                 j_force.floating_base_eom_task_ft),
        "torque_limits_ft": (t_force.torque_limits_task_ft(d), j_force.torque_limits_task_ft),
        "pad_cols_friction_cone": (t_force.pad_cols(T.friction_cone_task(d, mu)),
                                   lambda x: j_force.pad_cols(J.friction_cone_task(x, mu))),
    }
    assert len([k for k in cases if k not in ("scaled_swing_leg", "concat") and
                not k.endswith("_ft") and not k.startswith("pad")]) == 13
    for name, (t_task, j_fn) in cases.items():
        _close_task(t_task, jax.vmap(j_fn)(jd), name)
    grasp = np.asarray(GRASP)
    _close_task(t_force.wrench_tracking_task(d, torch.as_tensor(grasp)),
                jax.vmap(j_force.wrench_tracking_task)(jd, jnp.asarray(grasp)), "wrench_tracking")
    x = np.random.default_rng(1).normal(size=(B, 42))
    _close(T.compute_torque(d, torch.as_tensor(x[:, :36])),
           jax.vmap(J.compute_torque)(jd, jnp.asarray(x[:, :36])), "compute_torque")
    _close(t_force.compute_torque_ft(d, torch.as_tensor(x)),
           jax.vmap(j_force.compute_torque_ft)(jd, jnp.asarray(x)), "compute_torque_ft")


def test_nominal_ticks_match_jax():
    """hierarchical_wbc_batched in float64: as the bench runs it, with
    use_arm_init on, and arm_locked; the gains once as JAX's WbcGains and
    the state as JAX's WbcState, carried across by convert.py."""
    jm = j_aliengo_z1(dtype=jnp.float64)
    tm = t_aliengo_z1(dtype=F64, device="cpu")
    jcfg, tcfg = default_config().wbc, t_config.default_config().wbc
    xs, us, rbds, flags, last = _inputs(30)
    jin, tin = _j((xs, us, rbds, flags)), _t((xs, us, rbds, flags))
    j_state = j_wbc.WbcState(input_last=jnp.asarray(last))
    t_state = convert.wbc_state_from_numpy(as_numpy_fields(j_state), device="cpu")
    j_gains = j_wbc.WbcGains.from_settings(jcfg, dtype=jnp.float64)
    t_gains = convert.wbc_gains_from_numpy(as_numpy_fields(j_gains), device="cpu")
    assert t_gains.qp_iterations == jcfg.qp_iterations
    for kw, gains in ((dict(), "settings"), (dict(use_arm_init=True), "gains"),
                      (dict(arm_locked=True), "settings")):
        jc, tc = (j_gains, t_gains) if gains == "gains" else (jcfg, tcfg)
        ref, _ = j_wbc.hierarchical_wbc_batched(jm, jc, *jin, j_state, PERIOD, backend="xla",
                                                **kw)
        out, new = t_wbc.hierarchical_wbc_batched(tm, tc, *tin, t_state, PERIOD, **kw)
        assert out.shape == (B, 54) and bool(torch.isfinite(out).all())
        assert _rel(out, ref) <= TICK, kw
        assert new.input_last is tin[1]


def test_ft_ticks_match_jax():
    """hierarchical_wbc_ft_batched in float64 with grasp on and off in the
    batch, the wrench pinned at level 0 and in the legacy level-2 slot."""
    jm = j_aliengo_z1(dtype=jnp.float64)
    tm = t_aliengo_z1(dtype=F64, device="cpu")
    jcfg, tcfg = default_config().wbc, t_config.default_config().wbc
    xs, us, rbds, flags, last = _inputs(36)
    grasp = np.asarray(GRASP)
    jin, tin = _j((xs, us, rbds, flags, grasp)), _t((xs, us, rbds, flags, grasp))
    for priority in (0, 2):
        ref, _ = j_force.hierarchical_wbc_ft_batched(
            jm, jcfg, *jin, j_wbc.WbcState(input_last=jnp.asarray(last)), PERIOD,
            wrench_priority=priority, backend="xla")
        out, _ = t_force.hierarchical_wbc_ft_batched(
            tm, tcfg, *tin, t_wbc.WbcState(input_last=torch.as_tensor(last)), PERIOD,
            wrench_priority=priority)
        assert out.shape == (B, 60) and bool(torch.isfinite(out).all())
        assert _rel(out, ref) <= TICK, priority
        # the wrench: W = grasp * W_mpc where pinned at level 0
        if priority == 0:
            np.testing.assert_allclose(to_np(out[:, 36:42]), grasp[:, None] * np.asarray(WRENCH),
                                       atol=1e-6)


# K1's calls in one float32 tick, by shape (n, m) of Y: 93 Newton solves
# (3 levels x (30 iterations + the polish)) and 8 Gram solves (2 projectors
# x 2 ridges x 2 solves)
K1_SHAPES = {
    "nominal": {(36, 1): 93, (30, 36): 4, (52, 36): 4},
    "ft": {(42, 1): 93, (36, 42): 4, (58, 42): 4},
}


def test_f32_ticks_hold_the_physical_bars(monkeypatch):
    """Both ticks in float32 on the CPU (K1's plain version, the polish on):
    finite, the level-0 EoM residual < 1e-2, the swing feet's forces
    < 1e-2 N, the level-0 inequalities (torque limits, friction cone)
    within 1e-2, the joint torques within effort_limit (1e-3 relative),
    each lower level's residual within LEVEL_BARS of the float64 tick's,
    and the SPD solves of a tick by shape (K1's launches on the card).

    No elementwise bar against JAX's float32 tick: the f32 active-set
    polish solves a penalty system with 1e6 weights, and two float32
    cascades on the same tasks land far apart elementwise (the same JAX
    level QP jitted and not jitted lands one foot's normal force 26 N
    apart; JAX's Pallas and XLA cascades differ by up to 1.6 on
    cmd / max(|cmd|, 1)). What each level achieves, its residual, stays
    near the float64 tick's; LEVEL_BARS holds it."""
    tm = t_aliengo_z1(dtype=torch.float32, device="cpu")
    tm64 = t_aliengo_z1(dtype=F64, device="cpu")
    tcfg = t_config.default_config().wbc
    calls = []
    for mod in (t_qp, t_hoqp):
        solve = mod.spd_solve
        monkeypatch.setattr(mod, "spd_solve", lambda A, Y, s=0.0, _f=solve: (
            calls.append(tuple(Y.shape[1:])) or _f(A, Y, s)))
    effort = to_np(tm.effort_limit)
    for stack, nu in (("nominal", 30), ("ft", 36)):
        arrays = _inputs(nu)
        outs, levels = {}, {}
        for dtype, model in ((F64, tm64), (torch.float32, tm)):
            args = _t(arrays, dtype)
            state = t_wbc.WbcState(input_last=args[-1])
            calls.clear()
            if stack == "nominal":
                outs[dtype], _ = t_wbc.hierarchical_wbc_batched(model, tcfg, *args[:4], state,
                                                                PERIOD)
                data, levels[dtype] = t_wbc.combined_tasks(model, tcfg, *args[:4], state, PERIOD)
                eom = t_tasks.floating_base_eom_task(data)
            else:
                grasp = torch.tensor(GRASP, dtype=dtype)
                outs[dtype], _ = t_force.hierarchical_wbc_ft_batched(model, tcfg, *args[:4], grasp,
                                                                     state, PERIOD)
                data, levels[dtype] = t_force.ft_tasks(model, tcfg, *args[:4], grasp, state,
                                                       PERIOD)
                eom = t_force.floating_base_eom_task_ft(data)
        out, tasks = outs[torch.float32], levels[torch.float32]
        shapes = {}
        for s in calls:
            shapes[s] = shapes.get(s, 0) + 1
        assert shapes == K1_SHAPES[stack]
        assert out.dtype == torch.float32 and bool(torch.isfinite(out).all())
        n = eom.A.shape[-1]
        x, tau = out[:, :n, None], to_np(out[:, n:])
        assert float(((eom.A @ x)[..., 0] - eom.b).abs().max()) < EOM_BAR, stack
        F = to_np(out[:, 24:36]).reshape(B, 4, 3)
        assert np.abs(F[np.asarray(FLAGS) == 0.0]).max() < EOM_BAR, stack
        assert float(((tasks[0].D @ x)[..., 0] - tasks[0].f).max()) < EOM_BAR, stack
        assert (np.abs(tau) <= effort * (1.0 + TAU_SLACK)).all(), stack
        tasks64 = levels[F64]
        r32 = t_hoqp.level_residuals(tasks64, out.double())
        r64 = t_hoqp.level_residuals(tasks64, outs[F64])
        for level, bar in enumerate(LEVEL_BARS, start=1):
            b_norm = torch.linalg.norm(tasks64[level].b, dim=-1)
            dev = (r32[:, level] - r64[:, level]).abs() / b_norm
            assert float(dev.max()) <= bar, (stack, level, dev)
