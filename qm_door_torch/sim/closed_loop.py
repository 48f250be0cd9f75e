"""Closed-loop orchestration of one robot: physics (1 kHz) + controller
(500 Hz) + MPC (100 Hz), the cadence of the reference stack (Gazebo 1 kHz
physics, ros_control ~500 Hz update, mpcDesiredFrequency 100). Port of
qm_door_tpu/sim/closed_loop.py.

A host-side loop mirroring QMController::starting/update and the MPC
thread, in the same order as the JAX package's: the MPC runs synchronously
at its cadence (deterministic replay). The robot is a batch of one of the
batch-native simulation (sim/sim.py); everything runs on the model's
device. A control tick reads one small tensor back to the host (the log
row and the safety flag, which stops the run on the first unsafe tick);
an MPC solve reads its cost and violation.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch

from ..models import centroidal, kinematics
from ..models.model import RobotModel
from ..ocp.gait import GaitSchedule
from ..ocp.problem import build_stage_data, make_ocp_config
from ..ocp.reference import TargetTrajectories
from ..runtime.controller import QmController
from ..runtime.mrt import PolicyStore
from ..solver.sqp import SqpSolver
from ..wbc.wbc import WbcState
from . import terrain
from .sim import SimConfig, contact_flags_from_sim, measured_rbd, sim_init, sim_step

# consumer-IMU-grade sensor noise std-devs (sensor_noise="default")
DEFAULT_SENSOR_NOISE = {"gyro": 0.005, "acc": 0.1, "zyx": 0.002, "enc_q": 5e-4, "enc_v": 0.01}


@dataclass
class ClosedLoopLog:
    """One row a control tick (numpy float64 on the host), the MPC's cost
    and violation a solve after t = 0, and whether every tick was safe."""

    t: List[float] = field(default_factory=list)
    base_pose: List[np.ndarray] = field(default_factory=list)
    x_obs: List[np.ndarray] = field(default_factory=list)
    tau: List[np.ndarray] = field(default_factory=list)
    ee_pos: List[np.ndarray] = field(default_factory=list)
    mpc_cost: List[float] = field(default_factory=list)
    mpc_viol: List[float] = field(default_factory=list)
    safe: bool = True


class ClosedLoopRunner:
    """Deterministic closed-loop rollout of the full stack on the model's
    device (``model.device``: CUDA unless the model was built with
    ``device="cpu"``)."""

    def __init__(
        self,
        model: RobotModel,
        cfg,
        schedule: Optional[GaitSchedule] = None,
        sim_cfg: SimConfig = SimConfig(),
        control_decimation: int = 2,   # physics steps per control tick (500 Hz)
        mpc_decimation: int = 10,      # physics steps per MPC solve (100 Hz)
        solver: Optional[SqpSolver] = None,
        estimator: str = "ground_truth",  # or "kalman" (IMU + leg odometry KF)
        separated: bool = False,  # separated-system WBC (the reference's ss/ launch set)
        sensor_noise: Optional[dict] = None,
        noise_seed: int = 0,
        kf_params=None,  # estimation.KfParams override (kalman only)
    ):
        """``sensor_noise`` (kalman estimator only): Gaussian noise std-devs
        injected on the synthesized sensor readings each physics step —
        keys "gyro" (rad/s), "acc" (m/s^2), "zyx" (rad, the IMU attitude
        estimate), "enc_q" (rad), "enc_v" (rad/s); missing keys are 0;
        ``"default"`` is DEFAULT_SENSOR_NOISE. The draws come from numpy's
        ``default_rng(noise_seed)`` in the JAX package's order, so both
        packages see the same noise."""
        if estimator not in ("ground_truth", "kalman"):
            raise ValueError(f"estimator={estimator!r}: expected 'ground_truth' or 'kalman'")
        self.model = model
        self.cfg = cfg
        self.sim_cfg = sim_cfg
        self.schedule = schedule or GaitSchedule()
        if solver is None:
            self.ocp = make_ocp_config(model, cfg)
            self.solver = SqpSolver(model, self.ocp, cfg)
        else:
            self.ocp = solver.ocp
            self.solver = solver
        self.controller = QmController(model, cfg, separated=separated)
        self.control_decimation = control_decimation
        self.mpc_decimation = mpc_decimation
        self.estimator = estimator
        if sensor_noise == "default":
            sensor_noise = DEFAULT_SENSOR_NOISE
        self.sensor_noise = sensor_noise
        self.noise_seed = noise_seed
        self.kf_params = kf_params

    def _phase_heights(self, targets: TargetTrajectories, feet_xy, t_now):
        """Terrain-aware per-phase swing heights (the SwingTrajectoryPlanner
        role: ocs2 per-foot liftOff/touchDown height sequences): each foot's
        touchdown xy is its current xy (``feet_xy`` (4, 2), numpy) advanced
        by the commanded base velocity, finite-differenced from the targets;
        the heights are the terrain's there. None on flat terrain."""
        if self.sim_cfg.terrain == "flat":
            return None
        tt = targets.times
        d0, d1 = (targets.desired_state(torch.tensor(t, dtype=tt.dtype, device=tt.device))
                  .cpu().numpy() for t in (t_now, t_now + 0.1))
        v_cmd = (d1[6:8] - d0[6:8]) / 0.1

        def heights(foot, t0, t1):
            xy = np.stack([feet_xy[foot] + v_cmd * max(0.0, te - t_now) for te in (t0, t1)])
            h = terrain.terrain_height(self.sim_cfg.terrain, torch.as_tensor(xy[:, 0]),
                                       torch.as_tensor(xy[:, 1]), self.sim_cfg.terrain_params)
            return float(h[0]), float(h[1])

        return heights

    def run(self, targets: TargetTrajectories, duration: float, x0=None,
            start_height_offset: float = 0.0, external_wrench_fn=None) -> ClosedLoopLog:
        """``external_wrench_fn``: optional ``t -> (6,) base wrench`` applied
        in the sim each physics step (disturbance-rejection studies)."""
        model, cfg = self.model, self.cfg
        dtype, dev = model.dtype, model.device
        x_init = torch.as_tensor(cfg.initial_state() if x0 is None else x0, dtype=dtype,
                                 device=dev)
        q0 = centroidal.pinocchio_q(x_init).clone()
        # spawn with the feet exactly on the terrain (Gazebo drops the robot;
        # the drop is solved analytically) plus any requested extra offset
        feet_z = torch.mean(kinematics.contact_positions(model, q0)[:, 2])
        q0[2] = q0[2] + (self.sim_cfg.terrain_height - feet_z + start_height_offset)
        sim = sim_init(model, q0[None], cfg=self.sim_cfg)

        # estimator: ground truth (FromTopicStateEstimate parity) or the KF
        # fed from synthesized IMU readings
        kf = None
        if self.estimator == "kalman":
            from ..estimation import KalmanFilterEstimate
            from ..estimation.base import imu_from_state

            kf = (KalmanFilterEstimate(model) if self.kf_params is None
                  else KalmanFilterEstimate(model, self.kf_params))
            kf.reset(sim.q[0])
            noise_rng = np.random.default_rng(self.noise_seed)
        v_prev = sim.v[0]
        rbd_est = measured_rbd(model, sim)[0]

        def stage_at(t_now):
            feet_xy = None
            if self.sim_cfg.terrain != "flat":
                feet_xy = kinematics.contact_positions(model, sim.q[0])[:, 0:2].cpu().numpy()
            return build_stage_data(model, cfg, self.schedule, targets, t_now,
                                    phase_heights=self._phase_heights(targets, feet_xy, t_now))

        # the initial solve (QMController::starting: spin until a policy is
        # received), then one warm-started from it
        x_obs = centroidal.centroidal_state_from_rbd(model, rbd_est)
        stage = stage_at(0.0)
        sol = self.solver.solve(stage, x_obs)
        sol = self.solver.solve(stage, x_obs, warm=(sol.times, sol.X, sol.U))
        policy = PolicyStore(times=sol.times, X=sol.X, U=sol.U)

        wbc_state = WbcState.init(dtype=dtype, device=dev)
        log = ClosedLoopLog()
        command = None
        n_steps = int(round(duration / self.sim_cfg.dt))
        dt = self.sim_cfg.dt
        ctrl_period = dt * self.control_decimation

        for step in range(n_steps):
            t = step * dt
            if step % self.mpc_decimation == 0 and step > 0:
                x_obs = centroidal.centroidal_state_from_rbd(model, rbd_est)
                sol = self.solver.solve(stage_at(t), x_obs, warm=(sol.times, sol.X, sol.U))
                policy = PolicyStore(times=sol.times, X=sol.X, U=sol.U)
                cost_viol = torch.stack([sol.cost, sol.constraint_violation]).double().cpu()
                log.mpc_cost.append(float(cost_viol[0]))
                log.mpc_viol.append(float(cost_viol[1]))

            if step % self.control_decimation == 0 or command is None:
                rbd = rbd_est
                flags = torch.as_tensor(self.schedule.contact_flags_at(t), dtype=dtype,
                                        device=dev)
                res = self.controller.tick(policy, flags, rbd, wbc_state, t, ctrl_period)
                wbc_state = res.wbc_state
                command = res.command.stack()
                # one read back a tick: the log row and the safety flag
                row = torch.cat([sim.q[0, 0:6], res.x_obs, res.command.tau_ff, rbd[48:51],
                                 res.safe.reshape(1).to(dtype)]).double().cpu().numpy()
                if not row[-1]:
                    log.safe = False
                    break
                log.t.append(t)
                log.base_pose.append(row[0:6])
                log.x_obs.append(row[6:36])
                log.tau.append(row[36:54])
                log.ee_pos.append(row[54:57])

            wrench = (None if external_wrench_fn is None else torch.as_tensor(
                external_wrench_fn(t), dtype=dtype, device=dev)[None])
            sim = sim_step(model, self.sim_cfg, sim, command[None], external_wrench=wrench)
            if kf is None:
                rbd_est = measured_rbd(model, sim)[0]
                continue
            q, v = sim.q[0], sim.v[0]
            a_w = (v[0:3] - v_prev[0:3]) / dt
            v_prev = v
            zyx, omega_w, acc_body = imu_from_state(model, q, v, a_w)
            enc_q, enc_v = q[6:24], v[6:24]
            if self.sensor_noise:
                sn = self.sensor_noise

                def nrm(key, n):
                    return torch.as_tensor(noise_rng.normal(size=n) * sn.get(key, 0.0),
                                           dtype=dtype, device=dev)

                zyx = zyx + nrm("zyx", 3)
                omega_w = omega_w + nrm("gyro", 3)
                acc_body = acc_body + nrm("acc", 3)
                enc_q = enc_q + nrm("enc_q", 18)
                enc_v = enc_v + nrm("enc_v", 18)
            # the estimator consumes the contact SENSOR, not the gait plan
            # (QMHWSim.cpp:71-88 ContactManager flags feeding
            # StateEstimateBase::updateContact): at a phase flip the planned
            # stance foot is still airborne for the touchdown lag, and
            # trusting it as ground-fixed injects phantom base velocity
            kf_flags = contact_flags_from_sim(model, q, cfg=self.sim_cfg)
            # per-foot terrain height under the filter's own foot estimate
            # (the foot-height rows assume z = h(x, y))
            pf = kf.state.xe[6:18].reshape(4, 3)
            th = terrain.terrain_height(self.sim_cfg.terrain, pf[:, 0], pf[:, 1],
                                        self.sim_cfg.terrain_params)
            rbd_est = kf.update(zyx, omega_w, acc_body, enc_q, enc_v, kf_flags, dt,
                                terrain_height=th)

        return log
