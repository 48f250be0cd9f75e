"""The scenario registry (scenarios.py) and the host-side runtime helpers it
reaches (runtime/gait_command.py, runtime/planner.py), torch port against
the JAX package in float64 on the CPU: the registry's presets, make_scenario
for every name (the door names give a DoorOpeningRunner with the pull door's
hinge mirrored), walk_targets at 1e-12, and GaitCommander, JoyTeleop and
CirclePlanner over a few updates. No JAX compile: nothing here solves."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qm_door_torch import scenarios as t_sc
from qm_door_torch.models.model import aliengo_z1 as t_aliengo_z1
from qm_door_torch.ocp.gait import GaitSchedule as TGaitSchedule
from qm_door_torch.runtime import gait_command as t_gc
from qm_door_torch.runtime import planner as t_planner
from qm_door_torch.sim.closed_loop import ClosedLoopRunner as TClosedLoopRunner
from qm_door_torch.sim.door_loop import PULL_SCENARIO, DoorOpeningRunner, DoorScenario
from torch_parity import F64, to_np
from torch_parity import release_jax_executables  # noqa: F401 (autouse, module scope)

TOL = dict(rtol=1e-12, atol=1e-12)
ALL_NAMES = sorted(t_sc.SCENARIOS) + list(t_sc.DOOR_SCENARIOS)


@pytest.fixture(scope="module")
def models():
    from qm_door_tpu.models import aliengo_z1

    return aliengo_z1(dtype=jnp.float64), t_aliengo_z1(dtype=F64, device="cpu")


def test_registry_matches_jax():
    """Every preset's name, sim config, gait, targets, walk speed and notes,
    and the door names, as the JAX package's."""
    from qm_door_tpu import scenarios as j_sc

    assert sorted(t_sc.SCENARIOS) == sorted(j_sc.SCENARIOS)
    assert t_sc.DOOR_SCENARIOS == j_sc.DOOR_SCENARIOS
    for name, spec in t_sc.SCENARIOS.items():
        ref = j_sc.SCENARIOS[name]
        assert tuple(spec.sim_cfg) == tuple(ref.sim_cfg), name
        assert spec[1:] == ref[1:], name


def _flags(schedule, times):
    return np.stack([schedule.contact_flags_at(t) for t in times])


@pytest.mark.parametrize("name", ALL_NAMES)
def test_make_scenario_matches_jax(models, name):
    """make_scenario's runner and targets against JAX's: the runner's kind,
    sim config, gates, controller variant and gait schedule; the targets at
    1e-12 (None for the doors); for the doors the door config (the pull
    door's hinge mirrored: yaw -pi/2, to the robot's left) and the preset."""
    from qm_door_tpu import scenarios as j_sc

    jm, tm = models
    jr, jt = j_sc.make_scenario(name, model=jm)
    tr, tt = t_sc.make_scenario(name, model=tm)
    assert tr.cfg.controller.leg_pd_start_time == tr.cfg.wbc.arm_init_time == -1.0
    if name in t_sc.DOOR_SCENARIOS:
        assert isinstance(tr, DoorOpeningRunner) and tt is None and jt is None
        assert tr.scenario == (PULL_SCENARIO if name == "pull_door" else DoorScenario())
        assert tuple(tr.scenario) == tuple(jr.scenario)
        for field, value in tr.door_cfg._asdict().items():
            np.testing.assert_allclose(value, getattr(jr.door_cfg, field), err_msg=field, **TOL)
        assert tr.door_cfg.hinge_yaw == (-np.pi / 2 if name == "pull_door" else np.pi / 2)
        side = tr.door_cfg.hinge_pos[1] - tr._handle(0.0)[1]
        assert (side > 0) == (name == "pull_door")  # the hinge left of the handle
        assert tr.controller.force_tracking and tr.cfg.sqp.sqp_iterations == 2
        return
    assert isinstance(tr, TClosedLoopRunner)
    assert tr.sim_cfg == t_sc.SCENARIOS[name].sim_cfg
    assert tuple(tr.sim_cfg) == tuple(jr.sim_cfg)
    times = np.linspace(0.0, 4.0, 41)
    np.testing.assert_array_equal(_flags(tr.schedule, times), _flags(jr.schedule, times))
    for field in ("times", "states", "inputs"):
        np.testing.assert_allclose(to_np(getattr(tt, field)), np.asarray(getattr(jt, field)),
                                   err_msg=f"{name}: {field}", **TOL)


def test_make_scenario_separated(models):
    """separated=True gives the separated-system controller, as JAX's."""
    from qm_door_tpu import scenarios as j_sc

    jr, _ = j_sc.make_scenario("maze", model=models[0], separated=True)
    tr, _ = t_sc.make_scenario("maze", model=models[1], separated=True)
    assert tr.controller.separated and jr.controller.separated


def test_make_scenario_needs_cuda_unless_given_a_cpu_model():
    """Without a model, make_scenario builds one on CUDA, and raises where
    there is none."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_sc.make_scenario("push_door")


@pytest.mark.parametrize("terrain,params,v", [
    ("stairs", (0.4, 0.3, 0.06, 4.0), 0.3), ("wave", (0.04, 1.2, 1.0), 0.25),
    ("step", (0.5, 0.1), 0.25), ("flat", (0.0,), 0.2)])
def test_walk_targets_match_jax(models, terrain, params, v):
    """walk_targets on each height field against JAX's at 1e-12, and
    tests/test_scenarios.py's terrain-following checks on the stairs."""
    from qm_door_tpu import scenarios as j_sc
    from qm_door_tpu.config import default_config
    from qm_door_tpu.sim.sim import SimConfig

    from qm_door_torch.config import default_config as t_default_config
    from qm_door_torch.sim.sim import SimConfig as TSimConfig

    jt = j_sc.walk_targets(models[0], default_config(), v, 3.0,
                           SimConfig(terrain=terrain, terrain_params=params))
    tt = t_sc.walk_targets(models[1], t_default_config(), v, 3.0,
                           TSimConfig(terrain=terrain, terrain_params=params))
    for field in ("times", "states", "inputs"):
        np.testing.assert_allclose(to_np(getattr(tt, field)), np.asarray(getattr(jt, field)),
                                   err_msg=field, **TOL)
    states = to_np(tt.states)
    assert states[-1, 6] > states[0, 6]
    np.testing.assert_allclose(states[:, 0], v, atol=1e-9)
    if terrain == "stairs":
        assert states[-1, 8] > states[0, 8] + 0.05


def test_gait_commander_matches_jax():
    """GaitCommander's named gaits, templates and joystick buttons on both
    packages' schedules: the same commands applied (the joystick only on a
    change) and the same contact flags after each."""
    from qm_door_tpu.ocp.gait import GAIT_LIBRARY, GaitSchedule
    from qm_door_tpu.runtime.gait_command import GaitCommander

    from qm_door_torch.ocp.gait import GAIT_LIBRARY as T_GAITS

    js, ts = GaitSchedule(), TGaitSchedule()
    jc, tc = GaitCommander(js, 0.8), t_gc.GaitCommander(ts, 0.8)
    times = np.linspace(0.0, 8.0, 161)
    steps = [("command", "trot", 0.1), ("command_template", "pace", 1.3),
             ("joy", [1, 0, 0, 0, 1], 2.0), ("joy", [1, 0, 0, 0, 1], 2.2),
             ("joy", [1, 1, 0, 0, 1], 2.9), ("joy", [0, 1], 3.1), ("command", "amble", 4.0)]
    for kind, arg, t in steps:
        if kind == "command":
            jc.command(arg, t)
            tc.command(arg, t)
        elif kind == "command_template":
            jc.command_template(GAIT_LIBRARY[arg], t)
            tc.command_template(T_GAITS[arg], t)
        else:
            assert tc.joy_buttons(arg, t) == jc.joy_buttons(arg, t), (arg, t)
        np.testing.assert_array_equal(_flags(ts, times), _flags(js, times), err_msg=f"{kind} {t}")
    with pytest.raises(KeyError):
        tc.command("gallop", 5.0)


def test_joy_teleop_matches_jax():
    """JoyTeleop's base and EE twists for deadman buttons held or not."""
    from qm_door_tpu.runtime.gait_command import JoyTeleop

    rng = np.random.default_rng(0)
    for buttons in ([0, 0, 0, 0, 1, 0], [0, 0, 0, 0, 0, 1], [0, 0, 0, 0, 1, 1], [1], []):
        for _ in range(3):
            axes = list(rng.uniform(-1.0, 1.0, size=rng.integers(2, 6)))
            assert t_gc.JoyTeleop().cmd_vel(axes, buttons) == JoyTeleop().cmd_vel(axes, buttons)
            assert (t_gc.JoyTeleop().ee_cmd_vel(axes, buttons)
                    == JoyTeleop().ee_cmd_vel(axes, buttons))


def test_circle_planner_matches_jax():
    """CirclePlanner over updates that reach the first waypoint (the trot
    commanded), wait out the gait transition and advance around the circle
    past a full turn: the same target poses, state and commanded gaits."""
    from qm_door_tpu.ocp.gait import GaitSchedule
    from qm_door_tpu.runtime.gait_command import GaitCommander
    from qm_door_tpu.runtime.planner import CirclePlanner

    js, ts = GaitSchedule(), TGaitSchedule()
    jp = CirclePlanner(gait=GaitCommander(js), angle_increment=1.0, trot_delay=0.5)
    tp = t_planner.CirclePlanner(gait=t_gc.GaitCommander(ts), angle_increment=1.0,
                                 trot_delay=0.5)
    rng = np.random.default_rng(1)
    ee, t = np.array([0.0, 0.0, 0.5]), 0.0
    for k in range(14):
        ee = (jp._target + rng.normal(size=3) * 0.01) if k % 4 else ee
        np.testing.assert_allclose(tp.update(ee, t), jp.update(ee, t), **TOL)
        assert (tp.angle, tp.initial_reached, tp._trot_at) == (jp.angle, jp.initial_reached,
                                                               jp._trot_at)
        t += 0.1 + 0.2 * (k == 2)
    assert tp.initial_reached and tp.angle > 0.0
    times = np.linspace(0.0, 4.0, 81)
    np.testing.assert_array_equal(_flags(ts, times), _flags(js, times))
