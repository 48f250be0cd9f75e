"""The system under test: qm_door_torch's batched MPC, built from a
configuration file of the benchmark.

Only this module imports the program. It builds what the program's own
set-up builds (the model, the OCP, the solver, ``BatchedMpc``, the stage
data of each ring phase) from the configuration's settings, and wraps the
names ``solver/batched_sqp.py`` looks up at call time to record host spans
of its layers when asked to.
"""
from __future__ import annotations

import os
import time
from contextlib import contextmanager

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD_DIR = os.path.join(ROOT, "build", "qm_door_torch")

# the layers of the step, by the names batched_sqp_iteration calls
LAYER_OF = {"linearize_ocp": "linearize", "project_ocp_batched": "lq_stage",
            "lqr_solve_batched": "lq_stage", "evaluate_trajectory": "linesearch"}


def target_state(cfg, model, qc, dtype, device):
    """The (37,) target the stage data track: the configuration's
    ``target`` (base state, EE position, EE quaternion x, y, z, w) where it
    has one, else the initial state with its own EE pose."""
    from qm_door_torch.models import kinematics, spatial

    if "target" in cfg:
        tg = cfg["target"]
        return torch.tensor(tg["state"] + tg["ee_position"] + tg["ee_quat"], dtype=dtype,
                            device=device)
    x0 = torch.tensor(qc.initial_state(), dtype=dtype, device=device)
    R_ee, p_ee = kinematics.ee_pose(model, x0[6:30])
    return torch.cat([x0, p_ee, spatial.rot_to_quat(R_ee)])


def program_config(cfg):
    """The program's QmConfig with the configuration file's settings."""
    from qm_door_torch.config import default_config

    qc = default_config()
    s = cfg["sqp"]
    for key in ("dt", "sqp_iterations", "linesearch_steps", "lin_tangents", "sensitivity",
                "g_max", "g_min", "armijo_factor", "max_step", "step_reduction",
                "hessian_shift"):
        setattr(qc.sqp, key, s[key])
    qc.mpc.time_horizon = cfg["horizon_s"]
    qc.mpc.mpc_frequency = cfg["mpc_frequency_hz"]
    for section in ("cost", "friction", "joint_limits", "swing"):
        for key, value in cfg[section].items():
            setattr(getattr(qc, section), key,
                    np.asarray(value, dtype=np.float64) if isinstance(value, list) else value)
    if cfg["force_tracking"] is not None:
        qc.force_tracking.r_ee_force = cfg["force_tracking"]["r_ee_force"]
        qc.force_tracking.r_ee_torque = cfg["force_tracking"]["r_ee_torque"]
    if not np.array_equal(qc.initial_state(), np.asarray(cfg["initial_state"])):
        raise ValueError("the configuration's initial_state differs from the program's")
    return qc


class System:
    """The program set up for one configuration on one device: ``ring``
    holds the stage data of every ring phase, ``mpc`` the BatchedMpc."""

    def __init__(self, cfg, device, dtype=torch.float32, shared_stage=True):
        from qm_door_torch.models.model import load_model
        from qm_door_torch.ocp import force
        from qm_door_torch.ocp.gait import GaitSchedule, ModeSequenceTemplate, flags_to_mode
        from qm_door_torch.ocp.problem import build_stage_data, make_ocp_config
        from qm_door_torch.ocp.reference import TargetTrajectories
        from qm_door_torch.parallel.batched import BatchedMpc
        from qm_door_torch.solver.sqp import SqpSolver
        from qm_door_torch.utils import compile_cache

        compile_cache.enable_persistent_cache(BUILD_DIR)
        self.cfg, self.device, self.dtype = cfg, device, dtype
        qc = program_config(cfg)
        model = load_model(os.path.join(ROOT, cfg["model_file"]), dtype=dtype, device=device)
        ft = cfg["force_tracking"]
        ocp = (force.make_ocp_config_ft if ft is not None else make_ocp_config)(model, qc)
        self.solver = SqpSolver(model, ocp, qc)
        self.mpc = BatchedMpc(self.solver, shared_stage=shared_stage,
                              backend=cfg["sqp"]["backend"])
        self.N = self.solver.n_intervals
        tstate = target_state(cfg, model, qc, dtype, device)
        targets = TargetTrajectories.create(
            torch.tensor([0.0, 1e5], dtype=dtype, device=device), torch.stack([tstate, tstate]),
            torch.zeros((2, 30), dtype=dtype, device=device))
        gait = cfg["gait"]
        template = ModeSequenceTemplate([int(flags_to_mode(f)) for f in gait["modes"]],
                                        list(gait["switching_times"]))
        period = 1.0 / cfg["mpc_frequency_hz"]
        schedule = GaitSchedule()
        schedule.insert_template(template, 0.0, gait["ring_start_s"] + gait["ring_length"] * period)
        self.period = period
        self.ring = []
        for k in range(gait["ring_length"]):
            t0 = gait["ring_start_s"] + k * period
            stage = build_stage_data(model, qc, schedule, targets, t0)
            if ft is not None:
                n = stage.times.shape[0]
                stage = force.widen_stage_data(
                    stage, np.full(n, ft["grasp"]),
                    np.tile(np.asarray(ft["wrench_ref"], dtype=np.float64), (n, 1)))
            self.ring.append(stage)
        self.times = self.ring[0].times
        self._stacked = None

    def stage_for(self, phases):
        """The stage data of a step: one ring phase shared by every scenario
        (an int), or one a scenario ((B,) long tensor, per-scenario data)."""
        if isinstance(phases, int):
            return self.ring[phases]
        from qm_door_torch.ocp.problem import StageData

        if self._stacked is None:
            first = self.ring[0]
            self._stacked = {k: torch.stack([getattr(s, k) for s in self.ring])
                             for k in vars(first) if getattr(first, k) is not None}
        return StageData(**{k: v[phases] for k, v in self._stacked.items()})

    def cold_start(self, stage, x_init):
        return self.mpc.cold_start(stage, x_init)

    def warm_start(self, X, U):
        """The previous solution shifted one MPC period onto the next grid."""
        return self.solver.warm_start(self.times, X, U, self.times + self.period)

    def step(self, stage, x_init, X, U):
        return self.mpc.step(stage, x_init, X, U)


@contextmanager
def layer_spans(spans, annotate):
    """Record a host span (name, start_ns, end_ns) around every call of the
    step's layers, and with ``annotate`` a profiler range of the layer's
    name; the program's names are restored on exit."""
    from qm_door_torch.solver import batched_sqp

    saved = {name: getattr(batched_sqp, name) for name in LAYER_OF}

    def wrap(name, fn):
        layer = LAYER_OF[name]

        def call(*args, **kwargs):
            t0 = time.perf_counter_ns()
            if annotate:
                with torch.profiler.record_function(layer):
                    out = fn(*args, **kwargs)
            else:
                out = fn(*args, **kwargs)
            spans.append((name, t0, time.perf_counter_ns()))
            return out
        return call

    try:
        for name, fn in saved.items():
            setattr(batched_sqp, name, wrap(name, fn))
        yield
    finally:
        for name, fn in saved.items():
            setattr(batched_sqp, name, fn)


def k1_counters():
    """A copy of K1's launch counters: (total, by (batch, n, m))."""
    from qm_door_torch.ops.spd_solve import spd_solve

    return spd_solve.launches, dict(spd_solve.launches_by_shape)
