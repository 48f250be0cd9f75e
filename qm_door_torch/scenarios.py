"""Scenario registry: the launch-file surface of the reference stack (port of
qm_door_tpu/scenarios.py).

The reference exposes its demo matrix as Gazebo launch files
(qm_gazebo/launch/{cs,ss}/*.launch: empty, stairs, sar, pallets, tunnel,
vchimney, maze, mobile, push_door, pull_door, each in combined-system (cs)
and separated-system (ss) controller variants). Here each world is a typed
preset that assembles the equivalent runner: sim config (terrain
height-field and/or lateral-collision world mesh), gait schedule, target
trajectory, and controller variant.

    from qm_door_torch.scenarios import make_scenario, SCENARIOS
    runner, targets = make_scenario("stairs")
    log = runner.run(targets, duration=3.0)

The door scenarios return a DoorOpeningRunner (run with
``runner.run(duration)``; it generates its own targets from the measured
door state). Without a ``model`` the runner is built on AlienGo+Z1 in f32
on CUDA; pass a model built with ``device="cpu"`` to run on the CPU.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

from .config import default_config
from .models import kinematics, spatial
from .models.model import RobotModel, aliengo_z1
from .ocp.gait import GAIT_LIBRARY, GaitSchedule
from .ocp.reference import TargetTrajectories
from .sim.sim import SimConfig


class ScenarioSpec(NamedTuple):
    """One launch-world preset."""
    sim_cfg: SimConfig
    gait: str                      # GAIT_LIBRARY key ("stance" = no template)
    targets: str                   # "hold" | "walk" | "circle" | "door"
    walk_speed: float = 0.0
    notes: str = ""


SCENARIOS: Dict[str, ScenarioSpec] = {
    # qm_gazebo/launch/{cs/empty_world.launch, ss/empty_world_mpc.launch}
    "empty": ScenarioSpec(SimConfig(), "trot", "hold",
                          notes="flat-ground trot in place"),
    # ss/mobile_world_mpc.launch + qm_planner TestCircle
    "mobile": ScenarioSpec(SimConfig(), "trot", "circle",
                           notes="EE circle-waypoint tracking (qm_planner)"),
    # cs/stairs_world.launch (qm_description stairs URDFs)
    "stairs": ScenarioSpec(
        SimConfig(terrain="stairs", terrain_params=(0.4, 0.3, 0.06, 4.0)),
        "trot", "walk", walk_speed=0.3,
        notes="staircase ascent with terrain-aware swing references"),
    # cs/sar_world.launch (search-and-rescue rubble) -> wave height-field
    "sar": ScenarioSpec(
        SimConfig(terrain="wave", terrain_params=(0.04, 1.2, 1.0)),
        "trot", "walk", walk_speed=0.25,
        notes="rubble-field walk (wave height-field stand-in)"),
    # cs/pallets_world.launch -> raised platform (step height-field)
    "pallets": ScenarioSpec(
        SimConfig(terrain="step", terrain_params=(0.5, 0.1)),
        "trot", "walk", walk_speed=0.25,
        notes="step up onto a 10 cm pallet"),
    # cs/tunnel_world.launch (qm_description/urdf/tunnel)
    "tunnel": ScenarioSpec(
        SimConfig(world="tunnel60", world_offset=(0.0, -0.33, 0.0)),
        "trot", "hold",
        notes="trot inside the tunnel60 wall alcove (lateral collision)"),
    # ss/vchimney_world_mpc.launch (qm_description/urdf/vchimney)
    "vchimney": ScenarioSpec(
        SimConfig(world="vchimney", world_offset=(0.0, 0.45, 0.0)),
        "stance", "hold",
        notes="stand at the v-chimney mouth (inclined-wall collision)"),
    # ss/maze_world_mpc.launch (default maze4): offset puts the spawn in
    # the open west corridor (maze frame (-1.2, 0.3)), walking +x between
    # the outer wall (world y +0.45) and the inner wall (world y -0.55)
    "maze": ScenarioSpec(
        SimConfig(world="maze4", world_offset=(1.2, -0.3, 0.0)),
        "trot", "walk", walk_speed=0.2,
        notes="walk a maze corridor between collision walls"),
}

# door worlds are separate runners (force-tracking stack).
# cs/push_door_world.launch and cs/pull_door_world.launch: the reference's
# two door worlds differ by the door frame's mirrored mount (door_pull.urdf
# fixed-joint rpy +1.5708 vs -1.5708) and the robot spawn pose; here the
# mirror is DoorScenario.pull and the pull preset re-tunes the sequencing
# constants for the toward-the-robot swing (sim/door_loop.py PULL_SCENARIO).
DOOR_SCENARIOS = ("push_door", "pull_door")


def _spawn_ee(model: RobotModel, cfg):
    """The spawn state (30,) on the model's device and dtype, and its EE
    position and orientation (xyzw)."""
    x0 = torch.as_tensor(cfg.initial_state(), dtype=model.dtype, device=model.device)
    R_ee, p_ee = kinematics.ee_pose(model, x0[6:30])
    return x0, p_ee, spatial.rot_to_quat(R_ee)


def _hold_targets(model: RobotModel, cfg) -> TargetTrajectories:
    x0, p_ee, quat = _spawn_ee(model, cfg)
    state = torch.cat([x0, p_ee, quat])
    return TargetTrajectories.create(
        torch.tensor([0.0, 1e5], dtype=model.dtype, device=model.device),
        torch.stack([state, state]), torch.zeros((2, 30), dtype=model.dtype, device=model.device))


def walk_targets(model: RobotModel, cfg, v: float, duration: float,
                 sim_cfg: SimConfig) -> TargetTrajectories:
    """Constant-velocity walk with the base/EE height reference following
    the terrain height-field (elevation-map-fed cmd_vel pipeline role). The
    knots are made on the host in float64."""
    from .sim import terrain

    x0, p_ee, quat = (a.double().cpu().numpy() for a in _spawn_ee(model, cfg))
    ts = np.linspace(0.0, duration + cfg.mpc.time_horizon + 0.5, 8)
    xb = v * ts
    zt = terrain.terrain_height(sim_cfg.terrain, torch.as_tensor(xb),
                                torch.zeros(len(ts), dtype=torch.float64),
                                sim_cfg.terrain_params).numpy()
    states = []
    for xb_k, zt_k in zip(xb, zt):
        x = x0.copy()
        x[0] = v
        x[6] = xb_k
        x[8] = x0[8] + zt_k
        pe = p_ee.copy()
        pe[0] += xb_k
        pe[2] += zt_k
        states.append(np.concatenate([x, pe, quat]))
    as_t = lambda a: torch.as_tensor(a, dtype=model.dtype, device=model.device)  # noqa: E731
    return TargetTrajectories.create(as_t(ts), as_t(np.stack(states)),
                                     as_t(np.zeros((len(ts), 30))))


def make_scenario(name: str, model: Optional[RobotModel] = None, cfg=None,
                  duration: float = 3.0, separated: bool = False):
    """Build (runner, targets) for a registry scenario.

    ``separated`` selects the separated-system controller variant (the
    reference's ss/ launch set; combined cs/ is the default)."""
    from .sim.closed_loop import ClosedLoopRunner

    model = model or aliengo_z1()
    cfg = cfg or default_config()
    cfg.controller.leg_pd_start_time = -1.0
    cfg.wbc.arm_init_time = -1.0
    if name in DOOR_SCENARIOS:
        from .sim.door_loop import PULL_SCENARIO, DoorOpeningRunner, DoorScenario

        sc = PULL_SCENARIO if name == "pull_door" else DoorScenario()
        return DoorOpeningRunner(model, cfg, scenario=sc), None

    spec = SCENARIOS[name]
    sched = GaitSchedule()
    if spec.gait != "stance":
        sched.insert_template(GAIT_LIBRARY[spec.gait], 0.0, duration + 10.0)
    runner = ClosedLoopRunner(model, cfg, schedule=sched, sim_cfg=spec.sim_cfg,
                              separated=separated)
    if spec.targets == "walk":
        targets = walk_targets(model, cfg, spec.walk_speed, duration, spec.sim_cfg)
    else:
        # "circle" holds the spawn pose too: the first circle waypoint is the
        # EE goal, and runtime/planner.py:CirclePlanner advances the
        # waypoints as each is reached
        targets = _hold_targets(model, cfg)
    return runner, targets
