"""The controller runtime, torch port (qm_door_torch/runtime/controller.py)
against the JAX package on the CPU in float64: observe across the +-pi yaw
wrap; controller_tick of every variant (combined, arm_locked, separated,
force-tracking with the wrench at level 0 and 2) at t before both gates
(leg_pd_start_time, arm_init_time), between them and after them; and
QmController.tick carrying yaw_last from tick to tick with the gains
swapped between ticks.

The JAX references come from one QmController a variant, jitted once a test
run (tests/torch_parity.py:jax_tick_references, shared with
tests/test_torch_wbc_single.py). Tolerances: 1e-10 for the observation and
the policy point, 1e-8 relative to max|wbc_cmd| for the WBC output and the
torques fed forward (1e-7 on the combined stack's arm-init ticks, where the
swing legs are pinned by the regularization alone: torch_parity.TICK_BAR's
note)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qm_door_torch import config as t_config
from qm_door_torch.models.model import aliengo_z1 as t_aliengo_z1
from qm_door_torch.runtime import controller as t_ctl
from qm_door_torch.runtime.mrt import PolicyStore
from qm_door_torch.wbc.wbc import WbcGains, WbcState
from qm_door_tpu.models import aliengo_z1 as j_aliengo_z1
from qm_door_tpu.runtime import controller as j_ctl
from torch_parity import (F64, TICK_BAR, TICK_BAR_ARM_INIT, TICK_GATES, TICK_GRASP, TICK_PERIOD,
                          TICK_SEQ_TIMES, TICK_SWAP, TICK_TIMES, TICK_VARIANTS,
                          jax_tick_references, shared_reference, tick_config, tick_inputs, to_np)
from torch_parity import release_jax_executables  # noqa: F401 (autouse, module scope)

TOL = dict(rtol=1e-10, atol=1e-10)
EXACT = ("pos_des", "vel_des", "kp", "kd", "x_obs", "x_opt", "u_opt", "input_last")


def _t(a):
    return torch.tensor(np.asarray(a), dtype=F64)


@pytest.fixture(scope="module")
def tmodel():
    return t_aliengo_z1(dtype=F64, device="cpu")


def tick_bar(variant, t):
    """The bar of a tick's WBC output, relative to max|wbc_cmd|."""
    spec = TICK_VARIANTS[variant]
    arm_init = (not spec["separated"] and not spec["force_tracking"]
                and t < TICK_GATES["arm_init_time"])
    return TICK_BAR_ARM_INIT if arm_init else TICK_BAR


def check_tick(out, ref, what, bar):
    """A port TickResult's fields (a dict) against a JAX reference dict: the
    observation, the policy point and the commands' positions, velocities
    and gains at 1e-10, the WBC output and the fed-forward torques at `bar`
    of max|wbc_cmd|, the safety flag equal."""
    scale = np.abs(ref["wbc_cmd"]).max()
    for key in EXACT:
        np.testing.assert_allclose(to_np(out[key]), ref[key], err_msg=f"{what}: {key}", **TOL)
    for key in ("wbc_cmd", "tau_ff"):
        err = np.abs(to_np(out[key]) - ref[key]).max() / scale
        assert err <= bar, (what, key, err)
    assert bool(out["safe"]) == bool(ref["safe"]), what


def fields(res):
    c = res.command
    return dict(pos_des=c.pos_des, vel_des=c.vel_des, kp=c.kp, kd=c.kd, tau_ff=c.tau_ff,
                x_obs=res.x_obs, x_opt=res.x_opt, u_opt=res.u_opt, wbc_cmd=res.wbc_cmd,
                safe=res.safe, input_last=res.wbc_state.input_last)


def test_observe_unwraps_yaw_across_pi(tmodel):
    """observe against JAX's at yaws either side of +-pi and yaw_last on the
    other side (and one turn on): the unwrapped yaw stays within pi of
    yaw_last, everything else is centroidal_state_from_rbd's."""
    jm = j_aliengo_z1(dtype=jnp.float64)
    rbd = tick_inputs("combined")["rbd"]
    for yaw, yaw_last in ((np.pi - 0.01, -np.pi + 0.01), (-np.pi + 0.02, np.pi - 0.03),
                          (0.3, 0.2 + 2 * np.pi), (0.1, 0.0)):
        r = rbd.copy()
        r[0] = yaw
        ref = np.asarray(j_ctl.observe(jm, jnp.asarray(r), jnp.asarray(yaw_last)))
        for yl in (yaw_last, _t(yaw_last)):
            out = t_ctl.observe(tmodel, _t(r), yl)
            np.testing.assert_allclose(to_np(out), ref, err_msg=str((yaw, yaw_last)), **TOL)
        assert abs(ref[9] - yaw_last) < np.pi


@pytest.mark.parametrize("k", range(len(TICK_TIMES)))
@pytest.mark.parametrize("variant", list(TICK_VARIANTS))
def test_controller_tick_matches_jax(tmp_path_factory, tmodel, variant, k):
    """controller_tick of `variant` at TICK_TIMES[k] against JAX's jitted
    tick on the same inputs (torch_parity.tick_inputs), with the port's
    QmController's gains (cfg.wbc rounded to float32, as JAX's)."""
    ref = shared_reference(tmp_path_factory, f"jax_ticks_{variant}",
                           lambda: jax_tick_references(variant))[f"t{k}"]
    spec = TICK_VARIANTS[variant]
    cfg = tick_config(t_config, variant)
    ctl = t_ctl.QmController(tmodel, cfg, separated=spec["separated"],
                             force_tracking=spec["force_tracking"])
    a = {key: _t(v) for key, v in tick_inputs(variant).items()}
    res = t_ctl.controller_tick(
        tmodel, ctl.gains, ctl.ctrl, PolicyStore(times=a["times"], X=a["X"], U=a["U"]),
        a["flags"], a["rbd"], WbcState(input_last=a["input_last"]), TICK_TIMES[k],
        TICK_PERIOD, a["yaw_last"], separated=spec["separated"],
        force_tracking=spec["force_tracking"], grasp=TICK_GRASP[k],
        arm_locked=spec.get("arm_locked", False),
        wrench_priority=spec.get("wrench_priority", 0))
    check_tick(fields(res), ref, f"{variant} at t = {TICK_TIMES[k]}",
               tick_bar(variant, TICK_TIMES[k]))
    leg_on = TICK_TIMES[k] > cfg.controller.leg_pd_start_time
    assert (to_np(res.command.kd[:12]) == (cfg.controller.leg_kd if leg_on else 0.0)).all()
    nu = 36 if spec["force_tracking"] else 30
    assert res.wbc_cmd.shape == (nu + 24,) and res.u_opt.shape == (nu,)


def test_qm_controller_carries_yaw_and_takes_new_gains(tmp_path_factory, tmodel):
    """QmController.tick five times (TICK_SEQ_TIMES), each tick's WBC state
    fed to the next and yaw_last carried, the gains swapped (TICK_SWAP)
    before the fourth: every tick against JAX's QmController, and the
    swapped gains change the command."""
    refs = shared_reference(tmp_path_factory, "jax_ticks_combined",
                            lambda: jax_tick_references("combined"))
    ctl = t_ctl.QmController(tmodel, tick_config(t_config, "combined"))
    a = {key: _t(v) for key, v in tick_inputs("combined").items()}
    policy = PolicyStore(times=a["times"], X=a["X"], U=a["U"])
    state = WbcState(input_last=a["input_last"])
    ctl.yaw_last = float(a["yaw_last"])
    before = ctl.gains
    for k, t in enumerate(TICK_SEQ_TIMES):
        if k == 3:
            ctl.gains = WbcGains(**{**before.__dict__, **{
                name: torch.tensor(np.float32(v), dtype=F64) for name, v in TICK_SWAP.items()}})
            unswapped = t_ctl.controller_tick(tmodel, before, ctl.ctrl, policy, a["flags"],
                                              a["rbd"], state, t, TICK_PERIOD, ctl.yaw_last)
        res = ctl.tick(policy, a["flags"], a["rbd"], state, t, TICK_PERIOD)
        state = res.wbc_state
        ref = refs[f"seq{k}"]
        check_tick(fields(res), ref, f"QmController.tick {k}", tick_bar("combined", t))
        assert isinstance(ctl.yaw_last, torch.Tensor)
        np.testing.assert_allclose(float(ctl.yaw_last), float(ref["yaw_last"]), **TOL)
        if k == 3:
            assert np.abs(to_np(unswapped.wbc_cmd) - to_np(res.wbc_cmd)).max() > 1e-3


def test_hybrid_command_torque_and_stack(tmodel):
    """HybridCommand.torque is kp (q_d - q) + kd (v_d - v) + ff, as JAX's;
    stack() is the (5, 18) rows sim_step takes."""
    rng = np.random.default_rng(2)
    parts = [rng.normal(size=18) for _ in range(7)]
    c = t_ctl.HybridCommand(*(_t(p) for p in parts[:5]))
    ref = j_ctl.HybridCommand(*(jnp.asarray(p) for p in parts[:5])).torque(
        jnp.asarray(parts[5]), jnp.asarray(parts[6]))
    np.testing.assert_allclose(to_np(c.torque(_t(parts[5]), _t(parts[6]))), np.asarray(ref),
                               **TOL)
    np.testing.assert_array_equal(to_np(c.stack()), np.stack(parts[:5]))
