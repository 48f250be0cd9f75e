"""The single-robot closed loop (sim/closed_loop.py:ClosedLoopRunner), torch
port against the JAX package in float64 on the CPU.

- Short horizon (N = 10, torch_parity.configs) and a 20 ms window (20
  physics steps, 10 ticks, the cold and warm solves at t = 0 and one at
  10 ms), legs and arm commanded from t = 0 as in the canonical trot:
  three runs, the ground-truth estimator with an external wrench on the
  base, the separated-system WBC, and the Kalman filter fed
  sensor_noise="default". The JAX side is one reference a test run
  (torch_parity.shared_reference), its three runners sharing one
  SqpSolver (solver=). Every log field at 1e-8 (rtol = atol).
- ``_phase_heights`` on stairs (the only caller of build_stage_data's
  phase_heights): the heights and the stage's swing references against
  JAX's at 1e-10.
- At full width (AlienGo+Z1, default_config(), N = 67) the canonical trot
  (tools/record_trace.py:canonical_trot_run's set-up) for 6 ticks against
  the first rows of docs/artifacts/trot_2s_trace.jsonl at the bands of
  tests/test_trace_golden.py (the golden is a file: no JAX compile).
"""
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qm_door_torch import config as t_config
from qm_door_torch.models import kinematics as t_kin
from qm_door_torch.models import spatial as t_spatial
from qm_door_torch.models.model import aliengo_z1 as t_aliengo_z1
from qm_door_torch.ocp.gait import GAIT_LIBRARY as T_GAITS
from qm_door_torch.ocp.gait import GaitSchedule as TGaitSchedule
from qm_door_torch.ocp.problem import build_stage_data as t_build_stage_data
from qm_door_torch.ocp.reference import TargetTrajectories as TTargets
from qm_door_torch.sim import closed_loop as t_cl
from qm_door_torch.sim.sim import SimConfig as TSimConfig
from torch_parity import F64, configs, shared_reference, to_np
from torch_parity import release_jax_executables  # noqa: F401 (autouse, module scope)

TOL = dict(rtol=1e-8, atol=1e-8)
DURATION = 0.02
WRENCH_AMPLITUDE = (20.0, -10.0, 15.0, 1.0, -0.5, 0.5)
RUNS = {  # name -> ClosedLoopRunner arguments beyond (model, cfg, schedule)
    "ground_truth_wrench": dict(),
    "separated": dict(separated=True),
    "kalman_noise": dict(estimator="kalman", sensor_noise="default", noise_seed=3),
}
LOG_FIELDS = ("t", "base_pose", "x_obs", "tau", "ee_pos", "mpc_cost", "mpc_viol")
GOLDEN = os.path.join(os.path.dirname(__file__), "..", "docs", "artifacts",
                      "trot_2s_trace.jsonl")


def wrench_at(t):
    """The ground-truth run's base wrench at time t (a smooth push)."""
    return np.asarray(WRENCH_AMPLITUDE) * np.sin(40.0 * t + 0.3)


def runner_config(package_config):
    """configs()'s short-horizon config with the canonical trot's gates
    (legs and arm commanded from t = 0)."""
    cfg = package_config
    cfg.controller.leg_pd_start_time = -1.0
    cfg.wbc.arm_init_time = -1.0
    return cfg


def _log_arrays(log):
    out = {name: np.asarray(getattr(log, name), dtype=np.float64) for name in LOG_FIELDS}
    out["safe"] = np.asarray(log.safe)
    return out


def jax_runs():
    """The JAX package's three runs (RUNS) of DURATION on the trot: the
    logs' fields as float64 numpy, by run."""
    from qm_door_tpu.models import aliengo_z1, kinematics, spatial
    from qm_door_tpu.ocp.gait import GAIT_LIBRARY, GaitSchedule
    from qm_door_tpu.ocp.problem import make_ocp_config
    from qm_door_tpu.ocp.reference import TargetTrajectories
    from qm_door_tpu.sim.closed_loop import ClosedLoopRunner
    from qm_door_tpu.solver.sqp import SqpSolver

    cfg = runner_config(configs()[0])
    model = aliengo_z1(dtype=jnp.float64)
    solver = SqpSolver(model, make_ocp_config(model, cfg), cfg)
    x0 = jnp.asarray(cfg.initial_state())
    R_ee, p_ee = kinematics.ee_pose(model, x0[6:30])
    state = jnp.concatenate([x0, p_ee, spatial.rot_to_quat(R_ee)])
    targets = TargetTrajectories.create(jnp.array([0.0, 1e5]), jnp.stack([state, state]),
                                        jnp.zeros((2, 30)))
    out = {}
    for name, kw in RUNS.items():
        sched = GaitSchedule()
        sched.insert_template(GAIT_LIBRARY["trot"], 0.0, 5.0)
        runner = ClosedLoopRunner(model, cfg, schedule=sched, solver=solver, **kw)
        fn = wrench_at if name == "ground_truth_wrench" else None
        out[name] = _log_arrays(runner.run(targets, DURATION, external_wrench_fn=fn))
    return out


def _port_targets(model, cfg, dtype=F64):
    x0 = torch.tensor(cfg.initial_state(), dtype=dtype, device=model.device)
    R_ee, p_ee = t_kin.ee_pose(model, x0[6:30])
    state = torch.cat([x0, p_ee, t_spatial.rot_to_quat(R_ee)])
    return TTargets.create(torch.tensor([0.0, 1e5], dtype=dtype, device=model.device),
                           torch.stack([state, state]),
                           torch.zeros((2, 30), dtype=dtype, device=model.device))


def _trot(final):
    sched = TGaitSchedule()
    sched.insert_template(T_GAITS["trot"], 0.0, final)
    return sched


@pytest.mark.parametrize("run", list(RUNS))
def test_runner_log_matches_jax(tmp_path_factory, run):
    """The port's ClosedLoopRunner of `run` against JAX's: every log field
    (t, base pose, observation, torques, EE position, MPC cost and
    violation, safe) at 1e-8, the same number of rows."""
    ref = shared_reference(tmp_path_factory, "jax_closed_loop_runner_runs", jax_runs)[run]
    cfg = runner_config(configs()[1])
    tm = t_aliengo_z1(dtype=F64, device="cpu")
    runner = t_cl.ClosedLoopRunner(tm, cfg, schedule=_trot(5.0), **RUNS[run])
    fn = wrench_at if run == "ground_truth_wrench" else None
    out = _log_arrays(runner.run(_port_targets(tm, cfg), DURATION, external_wrench_fn=fn))
    assert bool(out["safe"]) and bool(ref["safe"])
    assert len(out["t"]) == len(ref["t"]) == 10 and len(ref["mpc_cost"]) == 1
    for name in LOG_FIELDS:
        assert out[name].shape == ref[name].shape, name
        np.testing.assert_allclose(out[name], ref[name], err_msg=f"{run}: {name}", **TOL)


def test_phase_heights_on_stairs_match_jax():
    """_phase_heights on the stairs world with a walking target (0.3 m/s in
    x): each foot's lift-off and touch-down heights for a few phases, and
    the stage data it makes (build_stage_data's phase_heights: the swing
    height and velocity references), against JAX's at 1e-10."""
    from qm_door_tpu.models import aliengo_z1
    from qm_door_tpu.ocp.gait import GAIT_LIBRARY, GaitSchedule
    from qm_door_tpu.ocp.problem import build_stage_data
    from qm_door_tpu.ocp.reference import TargetTrajectories
    from qm_door_tpu.sim.closed_loop import ClosedLoopRunner
    from qm_door_tpu.sim.sim import SimConfig
    from qm_door_tpu.sim.terrain import default_params

    jcfg, tcfg = (runner_config(c) for c in configs())
    params = default_params("stairs")
    jm = aliengo_z1(dtype=jnp.float64)
    tm = t_aliengo_z1(dtype=F64, device="cpu")
    start = to_np(_port_targets(tm, tcfg).states[0])
    goal = start.copy()
    goal[6] += 0.6  # 0.3 m/s in x over 2 s
    times, states = np.array([0.0, 2.0]), np.stack([start, goal])
    t_targets = TTargets.create(torch.tensor(times), torch.tensor(states),
                                torch.zeros((2, 30), dtype=F64))
    j_targets = TargetTrajectories.create(jnp.asarray(times), jnp.asarray(states),
                                          jnp.zeros((2, 30)))
    jr = ClosedLoopRunner(jm, jcfg, schedule=GaitSchedule(),
                          sim_cfg=SimConfig(terrain="stairs", terrain_params=params))
    tr = t_cl.ClosedLoopRunner(tm, tcfg, schedule=TGaitSchedule(),
                               sim_cfg=TSimConfig(terrain="stairs", terrain_params=params))
    feet_xy = np.array([[0.45, 0.15], [0.45, -0.15], [-0.05, 0.15], [-0.05, -0.15]])
    for t_now in (0.0, 0.37):
        jh, th = jr._phase_heights(j_targets, feet_xy, t_now), tr._phase_heights(
            t_targets, feet_xy, t_now)
        for foot, (a, b) in enumerate(((t_now, t_now + 0.3), (t_now + 0.1, t_now + 0.8),
                                       (t_now - 0.2, t_now + 0.25), (t_now + 0.5, t_now + 1.2))):
            np.testing.assert_allclose(th(foot, a, b), jh(foot, a, b), rtol=1e-10, atol=1e-10)
        ts = _trot(5.0)
        js = GaitSchedule()
        js.insert_template(GAIT_LIBRARY["trot"], 0.0, 5.0)
        j_stage = build_stage_data(jm, jcfg, js, j_targets, t_now, phase_heights=jh)
        t_stage = t_build_stage_data(tm, tcfg, ts, t_targets, t_now, phase_heights=th)
        for name in ("z_pos_ref", "z_vel_ref", "x_nom"):
            np.testing.assert_allclose(to_np(getattr(t_stage, name)),
                                       np.asarray(getattr(j_stage, name)), rtol=1e-10,
                                       atol=1e-10, err_msg=f"t = {t_now}: {name}")
        assert np.ptp(to_np(t_stage.z_pos_ref)) > 0.01  # the stairs reach the references
    assert jr._phase_heights(j_targets, feet_xy, 0.0) is not None
    flat = t_cl.ClosedLoopRunner(tm, tcfg, schedule=TGaitSchedule())
    assert flat._phase_heights(t_targets, feet_xy, 0.0) is None


def test_canonical_trot_at_full_width_follows_the_golden():
    """tools/record_trace.py:canonical_trot_run's set-up on the port in
    float64 (default_config(), N = 67, the trot template to 7 s, targets
    held at the spawn pose): 12 physics steps, 6 ticks and the cold, warm
    and 10 ms solves, held to the golden's first 6 rows at
    tests/test_trace_golden.py's bands (t at 1e-9, base xyz 5e-3 m, rpy
    2e-2 rad, EE 1e-2 m, torques p95 1 Nm and max 20 Nm)."""
    rows = [json.loads(line) for line in open(GOLDEN)][:6]
    cfg = t_config.default_config()
    cfg.controller.leg_pd_start_time = -1.0
    cfg.wbc.arm_init_time = -1.0
    tm = t_aliengo_z1(dtype=F64, device="cpu")
    runner = t_cl.ClosedLoopRunner(tm, cfg, schedule=_trot(7.0))
    assert runner.solver.n_intervals == 67
    log = runner.run(_port_targets(tm, cfg), duration=0.012)
    assert log.safe and len(log.t) == len(rows) and len(log.mpc_cost) == 1
    np.testing.assert_allclose(log.t, [r["t"] for r in rows], rtol=0, atol=1e-9)
    base = np.abs(np.stack(log.base_pose) - np.array([r["base_pose"] for r in rows]))
    ee = np.abs(np.stack(log.ee_pos) - np.array([r["ee_pos"] for r in rows]))
    tau = np.abs(np.stack(log.tau) - np.array([r["tau"] for r in rows]))
    assert base[:, 0:3].max() < 5e-3 and base[:, 3:6].max() < 2e-2, base.max(axis=0)
    assert ee.max() < 1e-2, ee.max()
    assert np.percentile(tau, 95) < 1.0 and tau.max() < 20.0, (np.percentile(tau, 95), tau.max())
