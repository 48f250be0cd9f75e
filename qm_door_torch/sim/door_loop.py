"""Door-opening closed loop: force-tracking NMPC + force-aware WBC + the
articulated door (port of qm_door_tpu/sim/door_loop.py; BASELINE config #4,
the reference's force-tracking branch in the push/pull-door Gazebo worlds,
qm_gazebo/launch/cs/{push,pull}_door.launch).

Scenario phases (host-side reference generation, re-planned every MPC cycle
from the *measured* door state):

  1. reach  [0, t_reach):  EE pose target on the handle, no grasp, zero wrench.
  2. press  [t_reach, ...): grasp engaged (sim spring coupling on); wrench
     reference presses the lever down until the latch releases.
  3. push   (after latch release): wrench reference switches to a
     panel-normal push that swings the door open; the EE target follows the
     moving handle along its arc.
  4. coast, done (or hold): the let-go and the recovery.

The robot is a batch of one of the batch-native simulation (sim/sim.py) and
the door (sim/door.py) a batch of one beside it, both in the model's dtype
on the model's device. The phase machine and the targets are host code:
they see the door and the measured rbd state through one read of a small
tensor a physics step, and do their arithmetic in numpy float64 (the
handle's arc through sim/door.py:handle_position on float64 CPU tensors),
as the JAX package's host code does through ``np.asarray``. A control tick
reads its log row and the safety flag back at once; a solve reads the
measured grasp force before it and its violation after it.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import List, NamedTuple, Optional

import numpy as np
import torch

from ..models import centroidal, kinematics, spatial
from ..models.model import RobotModel
from ..ocp.force import make_ocp_config_ft, widen_stage_data
from ..ocp.gait import GAIT_LIBRARY, GaitSchedule
from ..ocp.problem import build_stage_data
from ..ocp.reference import TargetTrajectories
from ..runtime.controller import QmController
from ..runtime.mrt import PolicyStore
from ..solver.sqp import SqpSolver
from ..wbc.wbc import WbcState
from .door import DoorConfig, DoorState, coupled_step, grasp_wrench, handle_position
from .sim import SimConfig, measured_rbd, sim_init

CPU64 = dict(dtype=torch.float64, device="cpu")


class DoorScenario(NamedTuple):
    """Door-opening sequencing (every constant is measurement-driven in the
    JAX package's experiments; the reasons stand beside each in
    qm_door_tpu/sim/door_loop.py:DoorScenario).

    Sequence: reach -> press (lever past the latch) -> push (EE reference
    leads along the handle arc; the grasp spring transmits the drive) ->
    instant release at release_angle -> short settle -> brisk retract.
    """

    t_reach: float = 0.5        # settle + reach the handle
    t_unlatch_min: float = 0.3  # press at least this long before pushing
    # EE z-target depth below the handle while pressing the lever
    # (2000 N/m grasp spring: 15 mm ~ 30 N down, lever arm 0.1 m ~ 3 N m
    # against the 2 N m/rad return spring)
    press_depth: float = 0.015
    open_target: float = -0.35   # shove end / coast start
    release_angle: float = -0.42  # instant let-go at this angle (or t_coast_max)
    t_coast_max: float = 0.45    # coast window cap
    coast_grip: float = 0.0     # gate target during the coast
    t_coast_grip: float = 0.3   # grip fade time within the coast
    t_coast_unlean: float = 0.3  # base un-lean ramp time within the coast
    door_rate_ref: float = -0.3  # arc-lead rate of the EE reference
    # post-release: freeze the reference at the measured release pose for
    # t_settle, then retract the EE home over t_retract
    t_settle: float = 0.4
    t_retract: float = 1.0
    t_release_ramp: float = 0.0  # instant
    # capture-point offset of the done-phase xy reference: capture_gain *
    # v_com_xy, clipped to capture_max (m)
    capture_gain: float = 0.35
    capture_max: float = 0.25
    # trot -> stance stand-down delay after the retract completes ...
    t_stand_down: float = 0.5
    # ... once the measured base xy speed is below this (m/s)
    stand_down_speed: float = 0.15
    # post-retract reference follow toward the measured pose, per MPC cycle
    follow_gain: float = 0.3
    # stance push: base reference lean toward the handle displacement
    lean_gain: float = 0.3
    # anticipatory left counter-lean (m), scaled in with the panel angle
    lean_y: float = 0.05
    # handle spawn point relative to the spawn EE pose
    handle_ahead: float = 0.06
    # step through the release, inserting the trot at "release" or "coast"
    trot_on_release: bool = True
    trot_at: str = "coast"
    # pull door (door_pull.urdf: the push door's frame mounted mirrored)
    pull: bool = False
    # alternative terminal behaviors: push to open_target and keep gripping
    hold_open: bool = False
    # insert a trot past this angle and transport the base with the arc
    walk_in_at: float = None
    walk: bool = False          # trot through the whole push
    walk_gait: str = "trot"


# Pull-door preset (cs/pull_door_world.launch parity): mirrored mount plus
# re-tuned sequencing for the toward-the-robot swing.
PULL_SCENARIO = DoorScenario(
    pull=True,
    lean_gain=0.5,
    lean_y=-0.05,
    open_target=-0.30,
    release_angle=-0.36,
    door_rate_ref=-0.25,
)


@dataclass
class DoorLog:
    """One row a control tick (numpy float64 on the host), the MPC's
    violation, time and phase a solve after t = 0, and whether every tick
    was safe."""

    t: List[float] = field(default_factory=list)
    panel: List[float] = field(default_factory=list)
    lever: List[float] = field(default_factory=list)
    base_pose: List[np.ndarray] = field(default_factory=list)
    feet_z: List[np.ndarray] = field(default_factory=list)   # (4,) world foot heights
    ee_pos: List[np.ndarray] = field(default_factory=list)
    ee_err: List[float] = field(default_factory=list)
    wrench_plan: List[np.ndarray] = field(default_factory=list)
    mpc_viol: List[float] = field(default_factory=list)
    mpc_t: List[float] = field(default_factory=list)
    mpc_phase: List[str] = field(default_factory=list)
    safe: bool = True


class DoorOpeningRunner:
    """Closed-loop door opening with the full force-tracking stack on the
    model's device (``model.device``: CUDA unless the model was built with
    ``device="cpu"``)."""

    def __init__(
        self,
        model: RobotModel,
        cfg,
        door_cfg: Optional[DoorConfig] = None,
        scenario: DoorScenario = DoorScenario(),
        sim_cfg: SimConfig = SimConfig(),
        control_decimation: int = 2,
        mpc_decimation: int = 10,
    ):
        self.model = model
        self.cfg = cfg
        self.scenario = scenario
        self.sim_cfg = sim_cfg
        # Door contact is a large, fast-changing disturbance relative to
        # trot: two SQP iterations a 100 Hz solve keep the nonlinear defects
        # bounded through the push (one lets them grow)
        cfg.sqp.sqp_iterations = max(cfg.sqp.sqp_iterations, 2)
        self.ocp = make_ocp_config_ft(model, cfg)
        self.solver = SqpSolver(model, self.ocp, cfg)
        self.controller = QmController(model, cfg, force_tracking=True)
        self.control_decimation = control_decimation
        self.mpc_decimation = mpc_decimation
        self.schedule = GaitSchedule()  # stance until the push inserts trot

        # Place the door FACING the robot: the panel plane runs along y
        # (hinge_yaw = pi/2) with the hinge 0.8 m to the robot's right, and
        # the handle a hand-width ahead of the spawn EE pose. Opening
        # (negative panel angle) then moves the handle mostly FORWARD.
        x0 = torch.as_tensor(cfg.initial_state(), dtype=model.dtype, device=model.device)
        _, p_ee = kinematics.ee_pose(model, x0[6:30])
        if door_cfg is None:
            handle_target = p_ee.double().cpu().numpy() + np.array(
                [scenario.handle_ahead, 0.0, 0.0])
            base = DoorConfig()
            ox, oy, oz = base.handle_offset
            # push: hinge 0.8 m to the robot's right (yaw +pi/2), opening
            # moves the handle AWAY (+x). pull: the mirrored mount (yaw
            # -pi/2, hinge 0.8 m to the robot's left), opening moves the
            # handle TOWARD the robot (-x), door_pull.urdf's flipped frame.
            yaw0 = -np.pi / 2 if scenario.pull else np.pi / 2
            c, s = np.cos(yaw0), np.sin(yaw0)
            off = np.array([c * ox - s * oy, s * ox + c * oy])
            door_cfg = base._replace(
                hinge_yaw=yaw0,
                hinge_pos=(float(handle_target[0] - off[0]),
                           float(handle_target[1] - off[1])),
                handle_offset=(ox, oy, float(handle_target[2])),
                # a hollow-core interior door (~9 kg slab: m w^2 / 3 = 2.4);
                # DoorConfig's default 8.53 models a heavy solid slab
                panel_inertia=2.4,
            )
        self.door_cfg = door_cfg

        # the phase machine's state (run() sets it again at its start)
        self._done = False
        self._unlatched = False
        self._holding = False
        self._t_coast = None      # when the coast began
        self._x_coast = None      # measured centroidal state at the coast's start
        self._a_walk_in = None    # panel angle where the walk-in trot began
        self._walking = False
        self._x_done = None       # measured centroidal state at the release
        self._p_ee_done = None    # measured EE position at the release
        self._t_done = 0.0
        self._a_release = None
        self._g_release = scenario.coast_grip
        self._w_ref = np.zeros(3)
        self._x_nom = None        # spawn centroidal state, grounded (numpy float64)
        self._ee_home = None      # spawn EE position (numpy float64)
        self._handle0 = None      # closed door's handle position (numpy float64)

    def _handle(self, angle):
        """Handle position (numpy float64, (3,)) at panel angle ``angle``."""
        d = dataclasses.replace(DoorState.init(**CPU64), angle=torch.as_tensor(angle, **CPU64))
        return handle_position(self.door_cfg, d).numpy()

    # --- reference generation per MPC cycle -------------------------------

    def _phase(self, t, door: DoorState):
        sc = self.scenario
        # sticky: grip jitter can let the lever spring back above the latch
        # threshold for a moment; once the latch released, it stays released
        if (float(door.lever) < self.door_cfg.latch_release
                or float(door.angle) < -1e-3):
            self._unlatched = True
        if self._done:
            return "done"  # grasp released, door open, hold posture
        if sc.hold_open:
            if self._holding or float(door.angle) <= sc.open_target:
                self._holding = True
                return "hold"
        coasting = self._t_coast is not None
        if (not sc.hold_open) and (coasting or float(door.angle) <= sc.open_target):
            if not coasting:
                self._t_coast = t
            unleaned = t >= self._t_coast + sc.t_coast_unlean  # ramp complete
            if ((float(door.angle) <= sc.release_angle and unleaned)
                    or t >= self._t_coast + sc.t_coast_max):
                self._done = True
                self._a_release = float(door.angle)
                self._t_done = t
                # the done ramp continues the coast's gate fade from its
                # current value (a restart from coast_grip would step)
                self._g_release = self._grasp("coast", t)
                return "done"
            return "coast"
        if t < sc.t_reach:
            return "reach"
        if self._unlatched and t >= sc.t_reach + sc.t_unlatch_min:
            return "push"
        return "press"

    def _grasp(self, phase, t):
        """Grasp gate in [0, 1]: on through press/push, loosened through the
        coast (DoorScenario.coast_grip), ramped off after release."""
        if phase == "reach":
            return 0.0
        if phase == "hold":
            return 1.0  # never lets go
        if phase == "coast":
            # soften in step with the target-lead decay (see _targets)
            r = min(1.0, (t - self._t_coast) / max(self.scenario.t_coast_grip, 1e-9))
            return float((1.0 - r) * 1.0 + r * self.scenario.coast_grip)
        if phase == "done":
            r = self.scenario.t_release_ramp
            if r <= 0.0:
                return 0.0
            g0 = self._g_release
            return float(g0 * np.clip(1.0 - (t - self._t_done) / r, 0.0, 1.0))
        return 1.0

    def _wrench_world(self, phase, F_meas):
        """Reference wrench ON THE ROBOT = the MEASURED grasp force, smoothed
        (an admittance design: the solver's model of the interaction force
        always matches what the spring delivers)."""
        w = np.zeros(6)
        # "done" stays admittance-tracked through the release ramp: F_meas
        # arrives pre-gated by the grasp gate, so w fades with the coupling
        if phase in ("press", "push", "coast", "hold", "done"):
            alpha = 0.5
            self._w_ref = (1 - alpha) * self._w_ref + alpha * np.asarray(F_meas)
            w[0:3] = self._w_ref
        else:
            self._w_ref = np.zeros(3)
        return w

    def _yawed_quat(self, yaw, ee_quat_hold):
        """The held EE orientation turned by ``yaw`` about z (numpy float64)."""
        q_yaw = spatial.rot_to_quat(spatial.zyx_to_rot(torch.tensor([yaw, 0.0, 0.0], **CPU64)))
        return spatial.quat_mul(q_yaw, torch.as_tensor(ee_quat_hold, **CPU64)).numpy()

    def _trajectories(self, times, states):
        """TargetTrajectories on the model's device and dtype from numpy
        float64 knots."""
        as_t = lambda a: torch.as_tensor(np.asarray(a), dtype=self.model.dtype,  # noqa: E731
                                         device=self.model.device)
        return TargetTrajectories.create(as_t(times), as_t(np.stack(states)),
                                         as_t(np.zeros((len(states), 30))))

    def _targets(self, phase, door: DoorState, ee_quat_hold, t=0.0):
        """EE target on the handle (``ee_quat_hold`` (4,), numpy). During the
        push the target PREDICTS the handle's arc over the MPC horizon;
        through the braking hold it keeps following the handle. After
        release (done) the arm RETRACTS to the home EE pose carried along
        with the base reference."""
        sc = self.scenario
        ee_quat_hold = np.asarray(ee_quat_hold, dtype=np.float64)
        if phase == "push":
            # Predict the panel angle with a blend of the measured rate and
            # the arc-lead setpoint (so the target leads a static door),
            # saturated at the open target where the coast takes over;
            # capped at the reference rate (an uncapped blend self-reinforces)
            dts = np.linspace(0.0, 1.2, 8)
            rate_pred = np.clip(0.5 * (float(door.rate) + sc.door_rate_ref),
                                sc.door_rate_ref, 0.0)
            angles = np.clip(float(door.angle) + rate_pred * dts, sc.open_target, 0.0)
        elif phase == "coast":
            # ride the handle with the horizon lead DECAYING to zero over
            # t_coast_grip
            dts = np.linspace(0.0, 1.2, 8)
            beta = min(1.0, max(0.0, (t - self._t_coast) / max(sc.t_coast_grip, 1e-9)))
            rate_pred = (1.0 - beta) * np.clip(0.5 * (float(door.rate) + sc.door_rate_ref),
                                               sc.door_rate_ref, 0.0)
            angles = np.clip(float(door.angle) + rate_pred * dts, sc.release_angle, 0.0)
        elif phase == "done":
            dts = np.array([0.0, 1e5])
            # settle (s = 0: everything held at the measured release pose),
            # then a smooth retract: measured EE at release -> home pose
            # transported by the base pose held at release
            t0 = self._t_done + sc.t_settle
            if sc.t_retract <= 0.0:
                s = 0.0  # hold the release posture
            else:
                s = min(1.0, max(0.0, (t - t0) / sc.t_retract))
            yaw_ref = self._x_done[9]
            c, sn = np.cos(yaw_ref), np.sin(yaw_ref)
            Rz2 = np.array([[c, -sn], [sn, c]])
            rel = self._ee_home[0:2] - self._x_nom[6:8]
            cap_ee = np.clip(sc.capture_gain * self._x_done[0:2], -sc.capture_max,
                             sc.capture_max)
            p_ret = np.concatenate([self._x_done[6:8] + cap_ee + Rz2 @ rel,
                                    [self._ee_home[2]]])
            p_t = (1.0 - s) * self._p_ee_done + s * p_ret
            quat = self._yawed_quat(yaw_ref, ee_quat_hold)
            # hold the capture-led release xy/yaw and ramp the height/tilt
            # reference from the measured release pose to upright-nominal
            # over the retract
            x = self._x_nom.copy()
            cap = np.clip(sc.capture_gain * self._x_done[0:2], -sc.capture_max, sc.capture_max)
            x[6:8] = self._x_done[6:8] + cap
            x[8] = (1.0 - s) * self._x_done[8] + s * x[8]
            x[9] = yaw_ref
            x[10:12] = (1.0 - s) * self._x_done[10:12]
            xj = np.concatenate([x, p_t, quat])
            return self._trajectories(t + dts, [xj, xj])
        elif phase == "hold":
            # frozen on the held-open handle point
            dts = np.array([0.0, 1e5])
            angles = np.full(2, sc.open_target)
        else:
            dts = np.array([0.0, 1e5])
            angles = np.full(2, float(door.angle))
        x_base = self._x_nom
        if phase == "coast":
            c_un = min(1.0, max(0.0, (t - self._t_coast) / max(sc.t_coast_unlean, 1e-9)))
            # coast base anchor: the MEASURED base at coast entry plus the
            # capture lead of its residual momentum
            cap_c = np.clip(sc.capture_gain * self._x_coast[0:2], -sc.capture_max,
                            sc.capture_max)
            coast_xy = self._x_coast[6:8] + cap_c
        states = []
        for a in angles:
            p_t = self._handle(a)
            if phase == "press":
                # press the lever by targeting below the handle
                p_t = p_t - np.array([0.0, 0.0, sc.press_depth])
            if phase == "coast":
                # workspace clip: an out-of-reach EE target drags the base
                # through the EE cost instead of extending the arm
                center = coast_xy + (self._ee_home[0:2] - self._x_nom[6:8])
                delta = p_t[0:2] - center
                dist = float(np.linalg.norm(delta))
                r_max = 0.12
                if dist > r_max:
                    p_t = p_t.copy()
                    p_t[0:2] = center + delta * (r_max / dist)
            x = x_base.copy()
            quat = ee_quat_hold
            if phase == "push" and sc.walk:
                # walking variant: the spawn geometry base <- handle is
                # rigid-transported with the panel
                c, sn = np.cos(a), np.sin(a)
                Rz2 = np.array([[c, -sn], [sn, c]])
                rel = x_base[6:8] - self._handle0[0:2]
                x[6:8] = p_t[0:2] + Rz2 @ rel
                x[9] = a
                quat = self._yawed_quat(a, ee_quat_hold)
            elif phase in ("push", "hold"):
                # stance push/hold: lean the base reference a fraction of
                # the handle's travel; past the walk-in angle the base
                # additionally FOLLOWS the handle 1:1 (the trot carries it)
                x[6:8] = x_base[6:8] + sc.lean_gain * (p_t[0:2] - self._handle0[0:2])
                x[7] += sc.lean_y * min(1.0, abs(a) / 0.3)
                if self._a_walk_in is not None:
                    p_in = self._handle(self._a_walk_in)
                    adv = p_t[0:2] - p_in[0:2]
                    # only the part beyond the walk-in point, minus the lean
                    # share already applied above
                    x[6:8] = x[6:8] + (1.0 - sc.lean_gain) * np.where(np.abs(adv) > 0, adv, 0.0)
            elif phase == "coast":
                # ride loosely at the measured-anchor pose; the lateral
                # counter-lean fades with c_un
                x[6:8] = coast_xy
                x[7] += (1.0 - c_un) * sc.lean_y
            states.append(np.concatenate([x, p_t, quat]))
        return self._trajectories(t + dts, states)

    # --- main loop --------------------------------------------------------

    def _read(self, door: DoorState, rbd_est):
        """The step's one host read: the door (what the phase machine and the
        targets see: float64 0-d CPU tensors) and the measured rbd state
        (55,), numpy float64."""
        row = torch.cat([torch.stack([door.angle[0], door.rate[0], door.lever[0],
                                      door.lever_rate[0]]), rbd_est]).double().cpu()
        return DoorState(*row[0:4]), row[4:].numpy()

    def run(self, duration: float = 3.0) -> DoorLog:
        model, cfg, sc = self.model, self.cfg, self.scenario
        dtype, dev = model.dtype, model.device
        x_init = torch.as_tensor(cfg.initial_state(), dtype=dtype, device=dev)
        q0 = centroidal.pinocchio_q(x_init).clone()
        feet_z = torch.mean(kinematics.contact_positions(model, q0)[:, 2])
        q0[2] = q0[2] + (self.sim_cfg.terrain_height - feet_z)
        x_nom = x_init.clone()
        x_nom[8] = q0[2]
        self._x_nom = x_nom.double().cpu().numpy()
        sim = sim_init(model, q0[None], cfg=self.sim_cfg)
        door = DoorState.init(dtype=dtype, batch=(1,), device=dev)

        R_ee0, p_ee0 = kinematics.ee_pose(model, q0)
        ee_quat_hold = spatial.rot_to_quat(R_ee0).double().cpu().numpy()
        self._ee_home = p_ee0.double().cpu().numpy()
        self._done = False
        self._unlatched = False
        self._t_coast = None
        self._x_coast = None
        self._holding = False
        self._a_walk_in = None
        self._walking = False
        self._x_done = None
        self._p_ee_done = None
        self._t_done = 0.0
        self._handle0 = self._handle(0.0)

        rbd_est = measured_rbd(model, sim)[0]
        x_obs = centroidal.centroidal_state_from_rbd(model, rbd_est)
        self._w_ref = np.zeros(3)

        def make_stage(t, phase, sim, door, door_host):
            targets = self._targets(phase, door_host, ee_quat_hold, t)
            stage = build_stage_data(model, cfg, self.schedule, targets, t)
            grasp_now = self._grasp(phase, t)
            F = grasp_wrench(model, self.door_cfg, door, sim.q, sim.v)[0][0]
            F_meas = grasp_now * F.double().cpu().numpy()
            w = self._wrench_world(phase, F_meas)
            n_nodes = stage.times.shape[0]
            return widen_stage_data(stage, np.full(n_nodes, grasp_now), np.tile(w, (n_nodes, 1)))

        door_host, rbd_np = self._read(door, rbd_est)
        phase = self._phase(0.0, door_host)
        stage = make_stage(0.0, phase, sim, door, door_host)
        sol = self.solver.solve(stage, x_obs)
        sol = self.solver.solve(stage, x_obs, warm=(sol.times, sol.X, sol.U))
        policy = PolicyStore(times=sol.times, X=sol.X, U=sol.U)

        wbc_state = WbcState.init(dtype=dtype, nu=36, device=dev)
        log = DoorLog()
        command = None
        n_steps = int(round(duration / self.sim_cfg.dt))
        dt = self.sim_cfg.dt
        ctrl_period = dt * self.control_decimation

        for step in range(n_steps):
            t = step * dt
            if step > 0:
                door_host, rbd_np = self._read(door, rbd_est)
            phase = self._phase(t, door_host)
            if self._t_coast is not None and self._x_coast is None:
                # measured state at coast entry: the coast reference anchor
                self._x_coast = centroidal.centroidal_state_from_rbd(
                    model, rbd_est).double().cpu().numpy()
            if phase == "push" and sc.walk and not self._walking:
                # walk with the door: trot from the first push cycle
                self._walking = True
                self.schedule.insert_template(GAIT_LIBRARY[sc.walk_gait], t, t + 60.0)
            if (phase in ("push", "hold") and sc.walk_in_at is not None
                    and float(door_host.angle) <= sc.walk_in_at and not self._walking):
                # step in: the stance arm is at its reach ceiling
                self._walking = True
                self._a_walk_in = float(door_host.angle)
                self.schedule.insert_template(GAIT_LIBRARY[sc.walk_gait], t, t + 60.0)
            if (phase == "coast" and sc.trot_on_release and sc.trot_at == "coast"
                    and not self._walking):
                # step BEFORE the release: the push leaves the base moving
                # forward past the front feet
                self._walking = True
                self.schedule.insert_template(GAIT_LIBRARY[sc.walk_gait], t, t + 60.0)
            if phase == "done" and self._x_done is None:
                # freeze the retract anchor at the measured release state
                self._x_done = centroidal.centroidal_state_from_rbd(
                    model, rbd_est).double().cpu().numpy()
                self._p_ee_done = rbd_np[48:51].copy()
                if sc.trot_on_release and not self._walking:
                    # step through the release: catch the forward momentum
                    self._walking = True
                    self.schedule.insert_template(GAIT_LIBRARY[sc.walk_gait], t, t + 60.0)
            settled = (
                float(np.linalg.norm(rbd_np[27:29])) < sc.stand_down_speed
                and abs(float(rbd_np[26])) < 2.0 * sc.stand_down_speed  # yaw rate
                and float(np.abs(rbd_np[1:3]).max()) < 0.15             # tilt
            )
            if (self._walking and self._x_done is not None
                    and t >= self._t_done + sc.t_settle + sc.t_retract + sc.t_stand_down
                    and settled):
                # stand down once settled and slow (DoorScenario.stand_down_speed)
                self._walking = False
                self.schedule.insert_template(GAIT_LIBRARY["stance"], t, t + 60.0)
            grasp_now = self._grasp(phase, t)

            if step % self.mpc_decimation == 0 and step > 0:
                x_obs = centroidal.centroidal_state_from_rbd(model, rbd_est)
                if phase == "done" and self._x_done is not None:
                    # from the release on, the anchor follows the measured
                    # pose (DoorScenario.follow_gain)
                    meas = x_obs.double().cpu().numpy()
                    self._x_done[6:8] += sc.follow_gain * (meas[6:8] - self._x_done[6:8])
                    self._x_done[9] += sc.follow_gain * (meas[9] - self._x_done[9])
                    # the capture lead decays with the momentum it led
                    self._x_done[0:2] *= (1.0 - sc.follow_gain)
                stage = make_stage(t, phase, sim, door, door_host)
                sol = self.solver.solve(stage, x_obs, warm=(sol.times, sol.X, sol.U))
                policy = PolicyStore(times=sol.times, X=sol.X, U=sol.U)
                log.mpc_viol.append(float(sol.constraint_violation))
                log.mpc_t.append(t)
                log.mpc_phase.append(phase)

            if step % self.control_decimation == 0 or command is None:
                flags = torch.as_tensor(self.schedule.contact_flags_at(t), dtype=dtype,
                                        device=dev)
                res = self.controller.tick(policy, flags, rbd_est, wbc_state, t, ctrl_period,
                                           grasp=grasp_now)
                wbc_state = res.wbc_state
                command = res.command.stack()
                # one read back a tick: the log row and the safety flag
                row = torch.cat([res.safe.reshape(1).to(dtype), sim.q[0, 0:6],
                                 kinematics.contact_positions(model, sim.q[0])[:, 2],
                                 res.u_opt[30:36]]).double().cpu().numpy()
                if not row[0]:
                    log.safe = False
                    break
                p_h = self._handle(float(door_host.angle))
                log.t.append(t)
                log.panel.append(float(door_host.angle))
                log.lever.append(float(door_host.lever))
                log.base_pose.append(row[1:7])
                log.feet_z.append(row[7:11])
                log.ee_pos.append(rbd_np[48:51])
                log.ee_err.append(float(np.linalg.norm(rbd_np[48:51] - p_h)))
                log.wrench_plan.append(row[11:17])

            sim, door = coupled_step(model, self.sim_cfg, self.door_cfg, sim, door,
                                     command[None], latched=True, grasp_on=grasp_now)
            rbd_est = measured_rbd(model, sim)[0]

        return log
