"""The door (sim/door.py, sim/door_loop.py), torch port against the JAX
package in float64 on the CPU.

- door.py at 1e-12, relative to the reference's largest entry of each
  compared quantity (``close``): handle_position / handle_velocity,
  grasp_wrench, panel_contact_forces (engaged from either side of the
  slab, out of its span, friction clamped and not, the panel far away
  with exact zeros; the port sums the eight spheres at once where JAX
  sums them one by one, so the two agree to rounding), door_step (latched
  or not, the lever's and the panel's limits, tau_hinge_extra) and
  coupled_step chained over 20 steps (grasp on or off, body contact on or
  off), each on a batch (the port) against JAX one state at a time;
  coupled_step keeps float32; the assertions of tests/test_aux.py's door
  tests and tests/test_door_contact.py run on the port.
- The phase machine (_phase, _grasp, _wrench_world, _targets) at 1e-12 with
  no solve, on set door states through reach, press, push, coast, done and
  hold, for the push and the pull door and the walk / walk_in_at variants.
- The loop at N = 10 (torch_parity.configs), 0.03 s a run, every DoorLog
  field at 1e-8 (rtol = atol), four runs each asserting the phases it
  reaches (RUNS). The JAX side is one reference a test run
  (torch_parity.shared_reference), its four runners sharing one SqpSolver
  and one QmController.
- At full width, the port's f64 run of chip_smoke.py (k)'s set-up for its
  first 6 ticks against docs/artifacts/door_press_trace.jsonl (JAX's f64
  run; a file, no JAX compile).
"""
import json
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qm_door_torch.models import kinematics as t_kin
from qm_door_torch.models.model import aliengo_z1 as t_aliengo_z1
from qm_door_torch.sim import door as t_door
from qm_door_torch.sim import door_loop as t_loop
from qm_door_torch.sim import sim as t_sim
from torch_parity import F64, configs, shared_reference, to_np
from torch_parity import release_jax_executables  # noqa: F401 (autouse, module scope)

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402

TOL = 1e-12
LOOP_TOL = dict(rtol=1e-8, atol=1e-8)
LOOP_SECONDS = 0.03
LOG_FIELDS = ("t", "panel", "lever", "base_pose", "feet_z", "ee_pos", "ee_err", "wrench_plan",
              "mpc_viol", "mpc_t")


def close(a, b, tol=TOL, err_msg=""):
    """a (port) within tol of b (JAX), relative to max(1, max|b|)."""
    b = np.asarray(b, dtype=np.float64)
    np.testing.assert_allclose(to_np(a), b, rtol=tol,
                               atol=tol * max(1.0, float(np.abs(b).max(initial=0.0))),
                               err_msg=err_msg)


@pytest.fixture(scope="module")
def models():
    from qm_door_tpu.models import aliengo_z1

    return aliengo_z1(dtype=jnp.float64), t_aliengo_z1(dtype=F64, device="cpu")


def standing_q():
    """The spawn pose with the feet on the ground (numpy float64)."""
    from qm_door_torch.config import default_config

    q0 = torch.tensor(default_config().initial_state()[6:30], dtype=F64)
    q0[2] -= t_kin.contact_positions(t_aliengo_z1(dtype=F64, device="cpu"), q0)[:, 2].mean()
    return q0.numpy()


def j_state(a, r, lv, lr):
    from qm_door_tpu.sim.door import DoorState

    return DoorState(*(jnp.asarray(x, dtype=jnp.float64) for x in (a, r, lv, lr)))


def t_state(a, r, lv, lr):
    return t_door.DoorState(*(torch.as_tensor(np.asarray(x, dtype=np.float64))
                              for x in (a, r, lv, lr)))


PUSH_CFG = t_door.DoorConfig(hinge_pos=(0.3, -0.7), hinge_yaw=np.pi / 2,
                             handle_offset=(0.8, -0.05, 0.9), panel_inertia=2.4)
PULL_CFG = PUSH_CFG._replace(hinge_pos=(0.3, 0.7), hinge_yaw=-np.pi / 2)


@pytest.mark.parametrize("cfg", [PUSH_CFG, PULL_CFG], ids=["push", "pull"])
def test_handle_position_and_velocity_match_jax(cfg):
    from qm_door_tpu.sim import door as j_door

    rng = np.random.default_rng(1)
    a, r = rng.uniform(-2.0, 0.0, 6), rng.normal(size=6)
    lv, lr = rng.uniform(-0.5, 0.0, 6), rng.normal(size=6)
    st = t_state(a, r, lv, lr)
    p, v = t_door.handle_position(cfg, st), t_door.handle_velocity(cfg, st)
    assert p.shape == v.shape == (6, 3)
    for i in range(6):
        js = j_state(a[i], r[i], lv[i], lr[i])
        close(p[i], j_door.handle_position(cfg, js))
        close(v[i], j_door.handle_velocity(cfg, js))


def test_grasp_wrench_matches_jax(models):
    from qm_door_tpu.sim import door as j_door

    jm, tm = models
    rng = np.random.default_rng(2)
    q = standing_q()[None] + rng.normal(size=(3, 24)) * 0.05
    v = rng.normal(size=(3, 24)) * 0.5
    a, r = rng.uniform(-0.5, 0.0, 3), rng.normal(size=3)
    F, p_ee, J_ee = t_door.grasp_wrench(tm, PUSH_CFG, t_state(a, r, 0 * a, 0 * a),
                                        torch.tensor(q), torch.tensor(v))
    assert F.shape == (3, 3) and J_ee.shape == (3, 6, 24)
    for i in range(3):
        jF, jp, jJ = j_door.grasp_wrench(jm, PUSH_CFG, j_state(a[i], r[i], 0.0, 0.0),
                                         jnp.asarray(q[i]), jnp.asarray(v[i]))
        close(F[i], jF)
        close(p_ee[i], jp)
        close(J_ee[i], jJ)


# panel_contact_forces' cases: the door config, the velocity scale (large:
# the Coulomb clamp binds on the engaged spheres; small: it does not) and
# whether any sphere is engaged
PANEL_CASES = {
    # the slab 3 cm into the front trunk spheres, approached from behind it
    "front": (t_door.DoorConfig(hinge_pos=(0.42, -0.8), hinge_yaw=np.pi / 2), 0.01, True),
    # the slab into the rear trunk spheres: the robot on the slab's other side
    "behind": (t_door.DoorConfig(hinge_pos=(-0.42, -0.8), hinge_yaw=np.pi / 2), 0.01, True),
    "clamped": (t_door.DoorConfig(hinge_pos=(0.42, -0.8), hinge_yaw=np.pi / 2), 2.0, True),
    # the plane through the trunk, the slab's span beside the robot
    "out_of_span": (t_door.DoorConfig(hinge_pos=(0.42, 0.5), hinge_yaw=np.pi / 2), 0.5, False),
    "far": (t_door.DoorConfig(hinge_pos=(5.0, -0.8), hinge_yaw=np.pi / 2), 0.5, False),
}


@pytest.mark.parametrize("case", list(PANEL_CASES))
def test_panel_contact_forces_match_jax(models, case):
    """The port's batch of 3 (poses, velocities, panel angles and rates)
    against JAX one at a time; the engaged cases exert a force, the others
    exactly none."""
    from qm_door_tpu.sim import door as j_door

    jm, tm = models
    cfg, v_scale, engaged = PANEL_CASES[case]
    rng = np.random.default_rng(3)
    q = standing_q()[None] + rng.normal(size=(3, 24)) * 0.005
    v = rng.normal(size=(3, 24)) * v_scale
    a, r = rng.uniform(-0.02, 0.0, 3), rng.normal(size=3) * 0.3
    tau, tau_h = t_door.panel_contact_forces(tm, cfg, t_state(a, r, 0 * a, 0 * a),
                                             torch.tensor(q), torch.tensor(v))
    assert tau.shape == (3, 24) and tau_h.shape == (3,)
    for i in range(3):
        jt, jh = j_door.panel_contact_forces(jm, cfg, j_state(a[i], r[i], 0.0, 0.0),
                                             jnp.asarray(q[i]), jnp.asarray(v[i]))
        close(tau[i], jt, err_msg=case)
        close(tau_h[i], jh, err_msg=case)
    if engaged:
        assert float(tau[:, 0].abs().min()) > 1.0
    else:
        assert float(tau.abs().max()) == 0.0 and float(tau_h.abs().max()) == 0.0


def test_door_step_matches_jax():
    """A batch of 8 doors (latched or not, at and past the lever's and the
    panel's limits, with and without a hinge torque) chained over 30 steps
    under random forces, against JAX one door at a time; `latched` as a bool
    and as a tensor."""
    from qm_door_tpu.sim import door as j_door

    rng = np.random.default_rng(4)
    cfg = PUSH_CFG
    a = np.array([0.0, -0.0005, -0.002, -1.999, -0.3, 0.0, -1.0, -2.0])
    r = np.array([0.0, 0.1, -0.5, -3.0, 0.2, 1.0, 0.0, -1.0])
    lv = np.array([0.0, -0.45, 0.0, -0.5236, -0.1, 0.0, -0.52, -0.3])
    lr = np.array([0.0, -1.0, 0.0, -2.0, 0.5, 3.0, -5.0, 0.0])
    latched = np.array([True, True, True, False, True, False, True, True])
    extra = rng.normal(size=8) * 20.0
    dt = 0.001
    for as_tensor in (False, True):
        ts = t_state(a, r, lv, lr)
        js = [j_state(a[i], r[i], lv[i], lr[i]) for i in range(8)]
        for _ in range(30):
            F = rng.normal(size=(8, 3)) * [20.0, 20.0, 60.0]
            p = rng.normal(size=(8, 3))
            if as_tensor:
                ts = t_door.door_step(cfg, ts, torch.tensor(F), torch.tensor(p), dt,
                                      latched=torch.tensor(latched),
                                      tau_hinge_extra=torch.tensor(extra))
                js = [j_door.door_step(cfg, js[i], jnp.asarray(F[i]), jnp.asarray(p[i]), dt,
                                       latched=bool(latched[i]),
                                       tau_hinge_extra=jnp.asarray(extra[i]))
                      for i in range(8)]
            else:
                ts = t_door.door_step(cfg, ts, torch.tensor(F), torch.tensor(p), dt)
                js = [j_door.door_step(cfg, js[i], jnp.asarray(F[i]), jnp.asarray(p[i]), dt)
                      for i in range(8)]
            for name in ("angle", "rate", "lever", "lever_rate"):
                close(getattr(ts, name), [getattr(j, name) for j in js], err_msg=name)
        assert float(ts.lever.min()) >= cfg.lever_lower and float(ts.angle.min()) >= cfg.panel_lower
    assert (to_np(ts.angle) != a).any()


def _coupled_start(scale=1.0):
    """A start state of the coupled step (numpy): a standing pose nudged
    toward a closed panel 2 cm into its trunk spheres, the handle 3 cm from
    the EE, a velocity, a PD command holding the pose."""
    rng = np.random.default_rng(5)
    q = standing_q() + rng.normal(size=24) * 0.002
    v = rng.normal(size=24) * 0.2 * scale
    cmd = np.stack([q[6:24], np.zeros(18), np.full(18, 150.0), np.full(18, 4.0), np.zeros(18)])
    return q, v, cmd


def _coupled_cfg(model_ee):
    """The door of the coupled-step tests: the panel plane 2 cm into the
    front trunk spheres, the handle 3 cm off the EE."""
    return t_door.DoorConfig(hinge_pos=(0.43, float(model_ee[1]) - 0.75),
                             hinge_yaw=np.pi / 2,
                             handle_offset=(0.8 - 0.03, -0.05, float(model_ee[2])),
                             panel_inertia=2.4)


@pytest.mark.parametrize("grasp,body", [(1.0, True), (0.0, True), (1.0, False), (0.0, False)])
def test_coupled_step_chain_matches_jax(models, grasp, body):
    """20 coupled steps (SimConfig(), the latch on) of the port's batch of
    one against JAX's: q, v, the anchors and the door at 1e-12."""
    from qm_door_tpu.sim import door as j_door
    from qm_door_tpu.sim import sim as j_sim

    jm, tm = models
    q, v, cmd = _coupled_start()
    _, p_ee = t_kin.ee_pose(tm, torch.tensor(q))
    cfg = _coupled_cfg(to_np(p_ee))
    js = j_sim.sim_init(jm, jnp.asarray(q), jnp.asarray(v), cfg=j_sim.SimConfig())
    jd = j_door.DoorState.init(dtype=jnp.float64)
    ts = t_sim.sim_init(tm, torch.tensor(q)[None], torch.tensor(v)[None])
    td = t_door.DoorState.init(dtype=F64, batch=(1,), device="cpu")
    for _ in range(20):
        js, jd = j_door.coupled_step(jm, j_sim.SimConfig(), cfg, js, jd, jnp.asarray(cmd),
                                     grasp_on=grasp, body_contact=body)
        ts, td = t_door.coupled_step(tm, t_sim.SimConfig(), cfg, ts, td,
                                     torch.tensor(cmd)[None], grasp_on=grasp,
                                     body_contact=body)
    for name in ("q", "v", "anchor"):
        close(getattr(ts, name)[0], getattr(js, name), err_msg=name)
    for name in ("angle", "rate", "lever", "lever_rate"):
        close(getattr(td, name)[0], getattr(jd, name), err_msg=name)
    if grasp:  # the grasp drove the lever and the hinge (the latch holds the panel)
        assert float(td.lever_rate.abs()) > 0


def test_coupled_step_keeps_float32():
    """A float32 model, simulation and door stay float32 through a coupled
    step, with a tensor grasp gate and the body contact on."""
    tm = t_aliengo_z1(dtype=torch.float32, device="cpu")
    q, v, cmd = _coupled_start()
    _, p_ee = t_kin.ee_pose(tm, torch.tensor(q, dtype=torch.float32))
    cfg = _coupled_cfg(to_np(p_ee))
    f32 = lambda a: torch.tensor(a, dtype=torch.float32)[None]  # noqa: E731
    sim = t_sim.sim_init(tm, f32(q), f32(v))
    door = t_door.DoorState.init(dtype=torch.float32, batch=(1,), device="cpu")
    for _ in range(2):
        sim, door = t_door.coupled_step(tm, t_sim.SimConfig(), cfg, sim, door, f32(cmd),
                                        grasp_on=torch.ones(1))
    for name in ("q", "v", "t", "cmd_buffer", "anchor"):
        assert getattr(sim, name).dtype == torch.float32, name
    for name in ("angle", "rate", "lever", "lever_rate"):
        assert getattr(door, name).dtype == torch.float32 and getattr(door, name).shape == (1,)


def test_door_state_init_needs_cuda_unless_asked():
    """DoorState.init defaults to CUDA and raises without it."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_door.DoorState.init()
    assert t_door.DoorState.init(device="cpu").angle.device.type == "cpu"


# tests/test_door_contact.py and tests/test_aux.py:183-252, on the port

def test_panel_contact_force_pushes_back_on_the_port(models):
    """tests/test_door_contact.py::test_panel_contact_force_pushes_back."""
    _, tm = models
    q0 = torch.tensor(standing_q())
    cfg = t_door.DoorConfig(hinge_pos=(0.42, -0.8), hinge_yaw=np.pi / 2)
    door = t_door.DoorState.init(dtype=F64, device="cpu")
    tau, tau_hinge = t_door.panel_contact_forces(tm, cfg, door, q0, torch.zeros(24, dtype=F64))
    assert float(tau[0]) < -50.0, tau[0]
    assert bool(torch.isfinite(tau).all())
    assert float(tau_hinge.abs()) > 1.0
    far = t_door.DoorConfig(hinge_pos=(5.0, -0.8), hinge_yaw=np.pi / 2)
    tau0, th0 = t_door.panel_contact_forces(tm, far, door, q0, torch.zeros(24, dtype=F64))
    assert float(tau0.abs().max()) == 0.0
    assert float(th0) == 0.0


def test_latched_panel_ignores_contact_torque_on_the_port():
    """tests/test_door_contact.py::test_latched_panel_ignores_contact_torque."""
    cfg = t_door.DoorConfig()
    st = t_door.DoorState.init(dtype=F64, device="cpu")
    z = torch.zeros(3, dtype=F64)
    st2 = t_door.door_step(cfg, st, z, z, 0.002, latched=True,
                           tau_hinge_extra=torch.tensor(-50.0, dtype=F64))
    assert float(st2.angle) == 0.0
    st3 = st
    for _ in range(50):
        st3 = t_door.door_step(cfg, st3, z, z, 0.002, latched=False,
                               tau_hinge_extra=torch.tensor(-50.0, dtype=F64))
    assert float(st3.angle) < -1e-4


SHOVE_STEPS = 200


def test_closed_panel_stops_shoved_robot_on_the_port(models):
    """tests/test_door_contact.py::test_closed_panel_stops_shoved_robot (a
    slow test there): a 1.2 m/s forward start into a closed, latched panel,
    with and without the body contact (the port's batch of one each), its
    assertions after SHOVE_STEPS coupled steps, not 400: the contact has
    stopped the robot by then (0.092 m against 0.094 at 100 steps), and the
    robot without it is 0.070 m further on (the bar is 0.05)."""
    _, tm = models
    q0 = torch.tensor(standing_q())
    cmd = torch.stack([q0[6:24], torch.zeros(18, dtype=F64), torch.full((18,), 300.0, dtype=F64),
                       torch.full((18,), 8.0, dtype=F64), torch.zeros(18, dtype=F64)])[None]
    door_cfg = t_door.DoorConfig(hinge_pos=(0.55, -0.8), hinge_yaw=np.pi / 2)
    finals = {}
    for contact in (True, False):
        v0 = torch.zeros(1, 24, dtype=F64)
        v0[0, 0] = 1.2
        sim = t_sim.sim_init(tm, q0[None], v0)
        door = t_door.DoorState.init(dtype=F64, batch=(1,), device="cpu")
        for _ in range(SHOVE_STEPS):
            sim, door = t_door.coupled_step(tm, t_sim.SimConfig(), door_cfg, sim, door, cmd,
                                            latched=True, grasp_on=0.0, body_contact=contact)
        assert bool(torch.isfinite(sim.q).all())
        finals[contact] = float(sim.q[0, 0])
        if contact:
            assert abs(float(door.angle[0])) < 0.05, door.angle
    assert finals[True] < 0.12, finals
    assert finals[True] < finals[False] - 0.05, finals


def test_door_model_on_the_port():
    """tests/test_aux.py::test_door_model: the latch blocks the panel until
    the lever is pulled; an opening push then swings the panel into [-2, 0]
    with hinge damping; the limits clamp."""
    cfg = t_door.DoorConfig()
    st = t_door.DoorState.init(dtype=F64, device="cpu")
    dt = 0.001
    p_h = t_door.handle_position(cfg, st)
    F_push = torch.tensor([0.0, -30.0, 0.0], dtype=F64)
    st1 = st
    for _ in range(200):
        st1 = t_door.door_step(cfg, st1, F_push, p_h, dt, latched=True)
    assert float(st1.angle) == 0.0
    F = torch.tensor([0.0, -30.0, -40.0], dtype=F64)
    st2 = st
    for _ in range(1500):
        st2 = t_door.door_step(cfg, st2, F, t_door.handle_position(cfg, st2), dt, latched=True)
    assert float(st2.lever) < cfg.latch_release
    assert float(st2.angle) < -0.05, float(st2.angle)
    assert float(st2.angle) >= cfg.panel_lower
    assert not np.allclose(to_np(t_door.handle_position(cfg, st2)), to_np(p_h))
    st3 = t_state(-1.9, -3.0, 0.0, 0.0)
    for _ in range(3000):
        st3 = t_door.door_step(cfg, st3, torch.zeros(3, dtype=F64), p_h, dt, latched=False)
    assert float(st3.angle) >= cfg.panel_lower - 1e-9
    assert abs(float(st3.rate)) < 3.0


def test_door_grasp_coupled_step_on_the_port(models):
    """tests/test_aux.py::test_door_grasp_coupled_step: 100 coupled steps
    with the handle at the EE stay finite."""
    _, tm = models
    from qm_door_torch.config import default_config

    x0 = torch.tensor(default_config().initial_state(), dtype=F64)
    q0 = x0[6:30]
    _, p_ee = t_kin.ee_pose(tm, q0)
    dcfg = t_door.DoorConfig(hinge_pos=(float(p_ee[0]) - 0.8, float(p_ee[1]) + 0.05),
                             handle_offset=(0.8, -0.05, float(p_ee[2])))
    sim = t_sim.sim_init(tm, q0[None])
    door = t_door.DoorState.init(dtype=F64, batch=(1,), device="cpu")
    cmd = torch.stack([q0[6:24], torch.zeros(18, dtype=F64), torch.full((18,), 150.0, dtype=F64),
                       torch.full((18,), 4.0, dtype=F64), torch.zeros(18, dtype=F64)])[None]
    for _ in range(100):
        sim, door = t_door.coupled_step(tm, t_sim.SimConfig(), dcfg, sim, door, cmd)
    assert bool(torch.isfinite(sim.q).all())
    assert bool(torch.isfinite(door.angle).all())


# --- the phase machine --------------------------------------------------------

def runner_config(package_config):
    cfg = package_config
    cfg.controller.leg_pd_start_time = -1.0
    cfg.wbc.arm_init_time = -1.0
    return cfg


def phase_runners(models, scenario_kw, pull=False, door_kw=None):
    """Both packages' DoorOpeningRunner (N = 10) on the push or the pull
    preset with `scenario_kw`, their door configs equal, and the same host
    state a run sets (spawn state, home EE, the closed door's handle)."""
    from qm_door_tpu.sim import door as j_door
    from qm_door_tpu.sim import door_loop as j_loop

    jm, tm = models
    jcfg, tcfg = (runner_config(c) for c in configs())
    jr = j_loop.DoorOpeningRunner(jm, jcfg, scenario=(
        j_loop.PULL_SCENARIO if pull else j_loop.DoorScenario())._replace(**scenario_kw))
    tr = t_loop.DoorOpeningRunner(tm, tcfg, scenario=(
        t_loop.PULL_SCENARIO if pull else t_loop.DoorScenario())._replace(**scenario_kw))
    for name in ("hinge_pos", "handle_offset", "hinge_yaw", "panel_inertia"):
        close(getattr(tr.door_cfg, name), getattr(jr.door_cfg, name), err_msg=name)
    if door_kw:
        jr.door_cfg, tr.door_cfg = (r.door_cfg._replace(**door_kw) for r in (jr, tr))
    handle0 = np.asarray(j_door.handle_position(jr.door_cfg, j_door.DoorState.init(
        dtype=jnp.float64), jnp.float64))
    close(tr._handle(0.0), handle0)
    x_nom = runner_config(configs()[1]).initial_state()
    x_nom[8] = 0.41
    _, p_ee = t_kin.ee_pose(tm, torch.tensor(x_nom[6:30]))
    for r in (jr, tr):
        r._x_nom, r._ee_home, r._handle0, r._w_ref = (x_nom.copy(), to_np(p_ee).copy(),
                                                       handle0.copy(), np.zeros(3))
    return jr, tr


def ee_quat_hold(models):
    from qm_door_torch.models import spatial as t_spatial

    R, _ = t_kin.ee_pose(models[1], torch.tensor(configs()[1].initial_state()[6:30]))
    return to_np(t_spatial.rot_to_quat(R))


# (t, panel angle, rate, lever) fed to _phase in order, and the phases JAX
# gives: reach, press, the lever past the latch (press until t_reach +
# t_unlatch_min), push, coast at the open target, done at the release angle
# once un-leaned, done sticky
SEQ_PUSH = ((0.0, 0.0, 0.0, 0.0), (0.012, 0.0, 0.0, -0.1), (0.02, 0.0, 0.0, -0.45),
            (0.03, 0.0, 0.0, -0.2), (0.1, -0.2, -0.3, -0.1), (0.2, -0.36, -0.3, 0.0),
            (0.3, -0.43, -0.2, 0.0), (0.55, -0.43, -0.1, 0.0), (0.6, -0.5, 0.0, 0.0))
# ... done at t_coast + t_coast_max short of the release angle
SEQ_COAST_MAX = SEQ_PUSH[:6] + ((0.5, -0.38, -0.1, 0.0), (0.66, -0.39, 0.0, 0.0),
                                (0.7, -0.2, 0.0, 0.0))
# ... unlatched by the panel angle alone, the lever untouched
SEQ_ANGLE = ((0.0, 0.0, 0.0, 0.0), (0.02, -0.002, -0.1, 0.0), (0.025, -0.0005, 0.0, 0.0),
             (0.031, -0.0005, 0.0, 0.0))
PHASE_CASES = {  # name -> (scenario fields, pull, sequence, the phases it must show)
    "push": (dict(t_reach=0.01, t_unlatch_min=0.02), False, SEQ_PUSH,
             ("reach", "press", "push", "coast", "done")),
    "pull": (dict(t_reach=0.01, t_unlatch_min=0.02), True, SEQ_PUSH,
             ("reach", "press", "push", "coast", "done")),
    "release_ramp": (dict(t_reach=0.01, t_unlatch_min=0.02, t_release_ramp=0.2,
                          coast_grip=0.3), False, SEQ_PUSH, ("coast", "done")),
    "coast_max": (dict(t_reach=0.01, t_unlatch_min=0.02), False, SEQ_COAST_MAX,
                  ("coast", "done")),
    "hold": (dict(t_reach=0.01, t_unlatch_min=0.02, hold_open=True), False, SEQ_COAST_MAX,
             ("push", "hold")),
    "angle_unlatch": (dict(t_reach=0.01, t_unlatch_min=0.02), False, SEQ_ANGLE,
                      ("reach", "press", "push")),
}
# the phase machine's state, and what the JAX package's runner reads where
# it has not set it yet (getattr defaults; _t_done and _a_release are read
# only once set)
PHASE_STATE = {"_unlatched": False, "_done": False, "_holding": False, "_t_coast": None,
               "_t_done": None, "_a_release": None, "_g_release": None}


@pytest.mark.parametrize("case", list(PHASE_CASES))
def test_phase_and_grasp_match_jax(models, case):
    """_phase over a sequence of door states and times, then _grasp of the
    phase: the same phases, gates and sticky state as JAX's at 1e-12."""
    kw, pull, seq, want = PHASE_CASES[case]
    jr, tr = phase_runners(models, kw, pull)
    phases = []
    for t, a, r, lv in seq:
        jp, tp = jr._phase(t, j_state(a, r, lv, 0.0)), tr._phase(t, t_state(a, r, lv, 0.0))
        assert tp == jp, (case, t, tp, jp)
        close(tr._grasp(tp, t), jr._grasp(jp, t), err_msg=f"{case} grasp at {t}")
        for name, default in PHASE_STATE.items():
            jv, tv = getattr(jr, name, default), getattr(tr, name)
            if name == "_g_release" and jv is None:  # read as coast_grip until set
                jv = jr.scenario.coast_grip
            if jv is None and name in ("_t_done", "_a_release"):
                continue
            if jv is None or isinstance(jv, bool):
                assert tv == jv, (case, t, name)
            else:
                close(tv, jv, err_msg=f"{case} {name} at {t}")
        phases.append(tp)
    assert set(want) <= set(phases), (case, phases)


def _set(runners, **attrs):
    for r in runners:
        for k, v in attrs.items():
            setattr(r, k, np.array(v, dtype=np.float64) if isinstance(v, np.ndarray) else v)


X_STATE = np.random.default_rng(6).normal(size=30) * 0.05
# name -> (scenario fields, pull, phase, (angle, rate, lever), t, host state)
TARGET_CASES = {
    "reach": (dict(), False, "reach", (0.0, 0.0, 0.0), 0.0, {}),
    "press": (dict(), True, "press", (0.0, 0.0, -0.2), 0.6, {}),
    "push": (dict(), False, "push", (-0.1, -0.2, -0.45), 0.9, {}),
    "push_saturated": (dict(), True, "push", (-0.29, -0.6, -0.45), 1.5, {}),
    "push_walk": (dict(walk=True), False, "push", (-0.1, -0.2, -0.45), 0.9, {}),
    "push_walk_in": (dict(walk_in_at=-0.2), False, "push", (-0.25, -0.3, -0.45), 1.2,
                     {"_a_walk_in": -0.21}),
    "hold_walk_in": (dict(hold_open=True, walk_in_at=-0.2), True, "hold", (-0.36, 0.0, -0.45),
                     1.6, {"_a_walk_in": -0.22}),
    "coast": (dict(), False, "coast", (-0.37, -0.4, 0.0), 1.3, {"_t_coast": 1.2}),
    "coast_late": (dict(), True, "coast", (-0.34, -0.1, 0.0), 1.8, {"_t_coast": 1.2}),
    "done_settle": (dict(), False, "done", (-0.6, -0.5, 0.0), 2.1, {"_t_done": 2.0}),
    "done_retract": (dict(), True, "done", (-0.9, -0.5, 0.0), 2.9, {"_t_done": 2.0}),
    "done_no_retract": (dict(t_retract=0.0), False, "done", (-0.9, -0.5, 0.0), 2.9,
                        {"_t_done": 2.0}),
}


@pytest.mark.parametrize("case", list(TARGET_CASES))
def test_targets_match_jax(models, case):
    """_targets' TargetTrajectories (times, states, inputs) against JAX's at
    1e-12, on a set door state and host state (the coast and release
    anchors near the spawn state)."""
    kw, pull, phase, (a, r, lv), t, attrs = TARGET_CASES[case]
    jr, tr = phase_runners(models, kw, pull)
    x_nom = tr._x_nom
    _set((jr, tr), _x_coast=x_nom + X_STATE, _x_done=x_nom - X_STATE,
         _p_ee_done=tr._ee_home + X_STATE[:3], _a_release=a, **attrs)
    quat = ee_quat_hold(models)
    jt = jr._targets(phase, j_state(a, r, lv, 0.0), jnp.asarray(quat), t)
    tt = tr._targets(phase, t_state(a, r, lv, 0.0), quat, t)
    for name in ("times", "states", "inputs"):
        close(getattr(tt, name), getattr(jt, name), err_msg=f"{case}: {name}")


def test_wrench_world_matches_jax(models):
    """_wrench_world's smoothed reference over a sequence of phases and
    measured grasp forces (reset in reach) against JAX's at 1e-12."""
    jr, tr = phase_runners(models, {})
    rng = np.random.default_rng(7)
    for phase in ("reach", "press", "press", "push", "coast", "reach", "done", "hold", "push"):
        F = rng.normal(size=3) * 20.0
        close(tr._wrench_world(phase, F), jr._wrench_world(phase, F), err_msg=phase)
        close(tr._w_ref, jr._w_ref, err_msg=phase)


# --- the loop ---------------------------------------------------------------

# name -> (DoorScenario fields, pull, the door's latch_release (None: the
# default), the phases of the solves after t = 0)
RUNS = {
    "press": (dict(t_reach=0.01, handle_ahead=0.0), False, None, ["press", "press"]),
    "pull_press": (dict(t_reach=0.01, handle_ahead=0.0), True, None, ["press", "press"]),
    # the latch released from the start: the push from t_reach on
    "push": (dict(t_reach=0.01, handle_ahead=0.0, t_unlatch_min=0.0), False, 0.01,
             ["push", "push"]),
    # push from t = 0 with the handle 2 cm behind the EE (the spring opens
    # the panel at once), coast at -1e-4 rad (~4 ms), done 4 ms later, the
    # trot inserted at the coast, the follow gain at the 10 and 20 ms
    # solves, the retract and the stand-down by 12 ms. (open_target = 0 would
    # coast at t = 0, and the JAX package's first targets then read the
    # coast anchor before its run sets it: a TypeError there.)
    "coast_done": (dict(t_reach=0.0, handle_ahead=-0.02, t_unlatch_min=0.0, open_target=-1e-4,
                        t_coast_max=0.004, t_settle=0.0, t_retract=0.004, t_stand_down=0.0,
                        stand_down_speed=10.0), False, 0.01, ["done", "done"]),
}
RUN_STATE_TIMES = (0.002, 0.006, 0.02)  # the gait schedule's contact flags read here


def _run_out(runner, log):
    out = {name: np.asarray(getattr(log, name), dtype=np.float64) for name in LOG_FIELDS}
    out.update(safe=np.asarray(log.safe), phases=np.asarray(log.mpc_phase),
               walking=np.asarray(runner._walking),
               t_coast=np.asarray(np.nan if runner._t_coast is None else runner._t_coast),
               t_done=np.asarray(runner._t_done),
               flags=np.stack([runner.schedule.contact_flags_at(t) for t in RUN_STATE_TIMES]))
    return out


def jax_door_runs():
    """The JAX package's four runs (RUNS) of LOOP_SECONDS at N = 10: the
    logs and the runners' end state, by run. The runners share the first
    one's SqpSolver and QmController (its yaw reset before each run), so
    JAX compiles each once."""
    from qm_door_tpu.models import aliengo_z1
    from qm_door_tpu.sim import door_loop as j_loop

    cfg = runner_config(configs()[0])
    model = aliengo_z1(dtype=jnp.float64)
    out, first = {}, None
    for name, (kw, pull, latch, _) in RUNS.items():
        base = j_loop.PULL_SCENARIO if pull else j_loop.DoorScenario()
        runner = j_loop.DoorOpeningRunner(model, cfg, scenario=base._replace(**kw))
        first = first or runner
        runner.solver, runner.controller = first.solver, first.controller
        runner.controller.yaw_last = 0.0
        if latch is not None:
            runner.door_cfg = runner.door_cfg._replace(latch_release=latch)
        out[name] = _run_out(runner, runner.run(duration=LOOP_SECONDS))
    return out


@pytest.mark.parametrize("run", list(RUNS))
def test_loop_matches_jax(tmp_path_factory, models, run):
    """The port's DoorOpeningRunner of `run` against JAX's: every DoorLog
    field at 1e-8, the solves' phases (those RUNS names), the end state
    (the coast's and the release's times, whether it still trots) and the
    gait schedule it left."""
    ref = shared_reference(tmp_path_factory, "jax_door_runs", jax_door_runs)[run]
    kw, pull, latch, phases = RUNS[run]
    base = t_loop.PULL_SCENARIO if pull else t_loop.DoorScenario()
    runner = t_loop.DoorOpeningRunner(models[1], runner_config(configs()[1]),
                                      scenario=base._replace(**kw))
    assert runner.cfg.sqp.sqp_iterations == 2
    if latch is not None:
        runner.door_cfg = runner.door_cfg._replace(latch_release=latch)
    out = _run_out(runner, runner.run(duration=LOOP_SECONDS))
    assert bool(out["safe"]) and bool(ref["safe"])
    assert len(out["t"]) == len(ref["t"]) == 15
    assert out["phases"].tolist() == ref["phases"].tolist() == phases
    for name in LOG_FIELDS:
        assert out[name].shape == ref[name].shape, name
        np.testing.assert_allclose(out[name], ref[name], err_msg=f"{run}: {name}", **LOOP_TOL)
    for name in ("walking", "t_coast", "t_done", "flags"):
        np.testing.assert_array_equal(out[name], ref[name], err_msg=f"{run}: {name}")
    wrench, t = out["wrench_plan"], out["t"]
    if run == "coast_done":
        # coast at 4 ms, done at 8, stood down after the trot; the grasp off
        # from the first solve in done on, so the wrench is exactly 0
        assert out["t_coast"] == 0.004 and out["t_done"] == 0.008 and not out["walking"]
        assert out["flags"][1].sum() == 2 and out["flags"][2].sum() == 4
        assert not wrench[t >= 0.01 - 1e-9].any()
    else:
        # the wrench exactly 0 on the reach ticks, not after the first solve
        # that grasps (t_reach)
        assert not wrench[t < kw["t_reach"] - 1e-9].any()
        assert np.abs(wrench[t >= kw["t_reach"] - 1e-9]).max(axis=1).min() > 0


def test_door_at_full_width_follows_the_trace(models):
    """chip_smoke.py (k)'s set-up on the port in float64 (door_runner:
    default_config(), N = 67, DoorScenario(**DOOR_SCENARIO)): 12 physics
    steps, 6 ticks and the cold, warm and 10 ms solves, every field of the
    trace's first 6 tick rows and its first solve row at 1e-8."""
    trace = [json.loads(line) for line in open(chip_smoke.DOOR_TRACE)]
    runner = chip_smoke.door_runner(torch.device("cpu"), F64)
    assert runner.solver.n_intervals == 67 and runner.cfg.sqp.sqp_iterations == 2
    rows = chip_smoke.door_rows(runner.run(duration=0.012))
    ticks = [r for r in rows if r["kind"] == "tick"]
    solves = [r for r in rows if r["kind"] == "solve"]
    ref_ticks = [r for r in trace if r["kind"] == "tick"][:6]
    ref_solves = [r for r in trace if r["kind"] == "solve"][:1]
    assert rows[-1]["safe"] and len(ticks) == 6 and len(solves) == 1
    for name in chip_smoke.DOOR_TICK_FIELDS:
        np.testing.assert_allclose(np.asarray([r[name] for r in ticks]),
                                   np.asarray([r[name] for r in ref_ticks]), err_msg=name,
                                   **LOOP_TOL)
    assert solves[0]["phase"] == ref_solves[0]["phase"] == "press"
    np.testing.assert_allclose([solves[0]["t"], solves[0]["viol"]],
                               [ref_solves[0]["t"], ref_solves[0]["viol"]], **LOOP_TOL)
