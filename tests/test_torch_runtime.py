"""The port's runtime (qm_door_torch/runtime: targets, msgs, metrics,
async_runner) against the JAX package, float64 on the CPU: the four target
converters at 1e-12 (cmd_vel's sticky EE target re-anchored past 0.1 m and
kept within it), the message layouts and round trips, Metrics and
TrajectoryRecorder; the launch counters exact under 8 threads;
PolicyMailbox and AsyncMpcLoop with a stub solve, with an exception in the
thread, and with the port's SqpSolver.solve (N = 10), every published
policy the solve's output bit for bit; realtime_run.py's real-time run at
N = 10 on the CPU and its refusal to start without CUDA."""
import json
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from qm_door_torch.ops import cuda_build
from qm_door_torch.runtime import async_runner as t_async
from qm_door_torch.runtime import metrics as t_metrics
from qm_door_torch.runtime import msgs as t_msgs
from qm_door_torch.runtime import targets as t_tg
from qm_door_torch.runtime.mrt import PolicyStore
from qm_door_tpu.runtime import metrics as j_metrics
from qm_door_tpu.runtime import msgs as j_msgs
from qm_door_tpu.runtime import targets as j_tg
from torch_parity import HORIZON, to_np
from torch_parity import release_jax_executables  # noqa: F401 (autouse, module scope)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=1e-12, atol=1e-12)


@pytest.fixture(scope="module")
def cfgs():
    from qm_door_torch.config import default_config as t_default
    from qm_door_tpu.config import default_config as j_default

    return j_default(), t_default()


def _inputs(seed):
    rng = np.random.default_rng(seed)
    obs = rng.normal(size=30) * 0.1
    obs[6:12] = [rng.normal(), rng.normal(), 0.4, rng.uniform(-np.pi, np.pi), 0.02, -0.01]
    q = rng.normal(size=4)
    ee = np.concatenate([obs[6:9] + [0.6, 0.0, 0.4], q / np.linalg.norm(q)])
    return rng, obs, ee


def _same(t_tt, j_tt):
    for f in ("times", "states", "inputs"):
        np.testing.assert_allclose(to_np(getattr(t_tt, f)), np.asarray(getattr(j_tt, f)),
                                   err_msg=f, **TOL)
        assert getattr(t_tt, f).dtype == torch.float64
        assert getattr(t_tt, f).device.type == "cpu"


@pytest.mark.parametrize("seed", [0, 1])
def test_ee_goal_and_ee_cmd_vel_targets_match_jax(cfgs, seed):
    jc, tc = cfgs
    rng, obs, ee = _inputs(seed)
    q = rng.normal(size=4)
    goal = (ee[:3] + rng.normal(size=3) * 0.3, q / np.linalg.norm(q))
    _same(t_tg.ee_goal_to_target_trajectories(*goal, obs, ee, 0.7, tc, 0.02, device="cpu"),
          j_tg.ee_goal_to_target_trajectories(*goal, obs, ee, 0.7, jc, 0.02))
    cmd, last = rng.normal(size=4) * 0.3, ee + rng.normal(size=7) * 0.01
    _same(t_tg.ee_cmd_vel_to_target_trajectories(cmd, last, obs, ee, 1.1, tc, device="cpu"),
          j_tg.ee_cmd_vel_to_target_trajectories(cmd, last, obs, ee, 1.1, jc))


@pytest.mark.parametrize("drift,anchored", [(0.05, False), (0.15, True)])
def test_cmd_vel_targets_match_jax(cfgs, drift, anchored):
    """The sticky EE target: kept while it lies within 0.1 m of the measured
    EE, re-anchored onto it past 0.1 m."""
    jc, tc = cfgs
    rng, obs, ee = _inputs(2)
    cmd = rng.normal(size=4) * 0.4
    last = ee.copy()
    last[:3] += drift * np.array([0.6, 0.0, 0.8])
    t_tt, t_last = t_tg.cmd_vel_to_target_trajectories(cmd, last, obs, ee, 0.3, tc, 0.01,
                                                       device="cpu")
    j_tt, j_last = j_tg.cmd_vel_to_target_trajectories(cmd, last, obs, ee, 0.3, jc, 0.01)
    _same(t_tt, j_tt)
    np.testing.assert_allclose(t_last, j_last, **TOL)
    np.testing.assert_allclose(t_last[:3], ee[:3] if anchored else last[:3], **TOL)
    np.testing.assert_allclose(t_last[3:], last[3:], **TOL)


def test_initial_target_matches_jax_and_takes_dtype_and_device(cfgs):
    jc, tc = cfgs
    rng, obs, _ = _inputs(3)
    rbd = rng.normal(size=55)
    x_init = tc.initial_state()
    t_tt = t_tg.initial_target(torch.as_tensor(obs), rbd, tc, x_init, 0.25, device="cpu")
    _same(t_tt, j_tg.initial_target(obs, rbd, jc, x_init, 0.25))
    f32 = t_tg.initial_target(obs, rbd, tc, x_init, 0.25, dtype=torch.float32, device="cpu")
    assert f32.states.dtype == torch.float32
    np.testing.assert_allclose(to_np(f32.states), to_np(t_tt.states), rtol=1e-6, atol=1e-6)
    if not torch.cuda.is_available():  # CUDA unless the caller asks for the CPU
        with pytest.raises(RuntimeError, match="CUDA"):
            t_tg.initial_target(obs, rbd, tc, x_init)


MSGS = {"EeState": 7, "BaseState": 6, "ArmTorque": 6}


def test_msgs_round_trip_and_match_jax():
    rng = np.random.default_rng(4)
    for name, n in MSGS.items():
        t_cls, j_cls = getattr(t_msgs, name), getattr(j_msgs, name)
        a = rng.normal(size=n + 1)
        t_msg = t_cls.from_array(a)
        np.testing.assert_array_equal(t_msg.to_array(), j_cls.from_array(a).to_array())
        np.testing.assert_array_equal(t_msg.to_array(), a)
    a = np.concatenate([[0.5], rng.normal(size=60), [7]])
    t_obs = t_msgs.Observation.from_array(a)
    assert t_obs.mode == 7 and t_obs.time == 0.5
    np.testing.assert_array_equal(t_obs.to_array(), a)
    np.testing.assert_array_equal(t_obs.to_array(), j_msgs.Observation.from_array(a).to_array())


def test_metrics_and_recorder_match_jax(tmp_path):
    summaries, dumps = [], []
    for mod in (t_metrics, j_metrics):
        m = mod.Metrics()
        for _ in range(3):
            m.timer("solve").start()
            m.timer("solve").stop()
        m.count("solves")
        m.count("solves", 2.0)
        m.gauge("violation", 1e-6)
        s = m.summary()
        assert s["timers"]["solve"]["count"] == 3 and s["timers"]["solve"]["max_ms"] >= 0.0
        s["timers"] = {k: v["count"] for k, v in s["timers"].items()}
        summaries.append(s)
        assert len(m.report().splitlines()) == 2
        rec = mod.TrajectoryRecorder()
        rec.record(0.0, base=np.arange(3.0), cost=2.5)
        rec.record(0.002, base=torch.arange(3.0).numpy() + 1, cost=np.float64(2.0))
        path = tmp_path / f"{mod.__name__}.jsonl"
        rec.dump(str(path))
        dumps.append(path.read_text())
    assert summaries[0] == summaries[1]
    assert dumps[0] == dumps[1]
    assert json.loads(dumps[0].splitlines()[1]) == {"t": 0.002, "base": [1.0, 2.0, 3.0],
                                                    "cost": 2.0}


def test_launch_counters_are_exact_under_8_threads():
    """cuda_build.count_launch from 8 threads at once: every count lands."""
    def wrapper():
        pass

    wrapper.launches = 0
    wrapper.launches_by_variant = {"reg32": 0, "reg64": 0}
    wrapper.launches_by_shape = {}
    n, threads = 20000, 8
    start = threading.Barrier(threads)

    def hammer(i):
        start.wait()
        for j in range(n):
            cuda_build.count_launch(wrapper, "reg32" if j % 2 else "reg64", (i % 2, j % 3))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)  # switch threads as often as the interpreter allows
    try:
        pool = [threading.Thread(target=hammer, args=(i,)) for i in range(threads)]
        for t in pool:
            t.start()
        for t in pool:
            t.join()
    finally:
        sys.setswitchinterval(old)
    assert wrapper.launches == n * threads
    assert wrapper.launches_by_variant == {"reg32": n * threads // 2, "reg64": n * threads // 2}
    assert sum(wrapper.launches_by_shape.values()) == n * threads
    assert wrapper.launches_by_shape[(0, 0)] == 4 * len(range(0, n, 3))


def _stub_policy(k, n=8, like=np.float64):
    return PolicyStore(times=np.linspace(0, 0.1, n) + k, X=np.full((n, 30), float(k), like),
                       U=np.zeros((n - 1, 30), like))


def test_policy_mailbox_publishes_host_copies():
    mbox = t_async.PolicyMailbox(n_nodes=8)
    assert mbox.latest() == (0, None)
    p = PolicyStore(times=torch.linspace(0, 0.1, 8, dtype=torch.float64),
                    X=torch.randn(8, 30, dtype=torch.float32), U=torch.randn(7, 36))
    assert mbox.publish(p) == 2
    seq, got = mbox.latest()
    assert seq == 2
    for f in ("times", "X", "U"):
        a = getattr(got, f)
        assert isinstance(a, np.ndarray) and a.dtype == getattr(p, f).numpy().dtype
        np.testing.assert_array_equal(a, getattr(p, f).numpy())


def test_async_loop_with_a_stub_solve():
    mbox = t_async.PolicyMailbox(n_nodes=8)
    calls = [0]

    def solve():
        calls[0] += 1
        return _stub_policy(calls[0])

    loop = t_async.AsyncMpcLoop(solve, mpc_hz=200.0, mailbox=mbox, device="cpu")
    assert loop.stream is None
    loop.start()
    seqs = []
    t_end = time.monotonic() + 0.2
    while time.monotonic() < t_end:
        seq, policy = mbox.latest()
        if seq:
            seqs.append(seq)
            # a snapshot is one solve's: every X entry and the times agree
            k = policy.X[0, 0]
            assert np.all(policy.X == k) and policy.times[0] == k
        time.sleep(0.002)
    loop.stop()
    assert loop.error is None and calls[0] >= 5
    assert seqs == sorted(seqs) and seqs[-1] <= 2 * calls[0]
    assert loop.metrics.counters["mpc_solves"] == calls[0]
    assert loop.metrics.timers["mpc_solve"].count == calls[0]


def test_async_loop_keeps_the_threads_exception():
    mbox = t_async.PolicyMailbox(n_nodes=8)
    calls = [0]

    def solve():
        calls[0] += 1
        if calls[0] == 3:
            raise FloatingPointError("solve diverged")
        return _stub_policy(calls[0])

    loop = t_async.AsyncMpcLoop(solve, mpc_hz=500.0, mailbox=mbox)
    loop.start()
    loop._thread.join(5.0)
    assert not loop._thread.is_alive()
    assert isinstance(loop.error, FloatingPointError)
    assert mbox.latest()[0] == 4  # the two solves before it were published
    loop.stop()


def test_async_loop_with_the_ports_solve():
    """The MPC thread running SqpSolver.solve (N = 10, f64), warm-started
    from its previous solution, beside a reader: every policy read is, bit
    for bit, a solution the solve returned, and the sequence never falls."""
    from qm_door_torch.config import default_config
    from qm_door_torch.models.model import aliengo_z1
    from qm_door_torch.ocp.gait import GAIT_LIBRARY, GaitSchedule
    from qm_door_torch.ocp.problem import build_stage_data, make_ocp_config
    from qm_door_torch.ocp.reference import TargetTrajectories
    from qm_door_torch.solver.sqp import SqpSolver

    cfg = default_config()
    cfg.mpc.time_horizon = HORIZON
    model = aliengo_z1(dtype=torch.float64, device="cpu")
    solver = SqpSolver(model, make_ocp_config(model, cfg), cfg)
    x0 = torch.tensor(cfg.initial_state(), dtype=torch.float64)
    state = torch.cat([x0, torch.tensor([-1.4, 0.0, 0.44, 0.0, 0.0, 0.0, 1.0],
                                        dtype=torch.float64)])
    targets = TargetTrajectories.create(torch.tensor([0.0, 1e5], dtype=torch.float64),
                                        torch.stack([state, state]),
                                        torch.zeros(2, 30, dtype=torch.float64))
    sched = GaitSchedule()
    sched.insert_template(GAIT_LIBRARY["trot"], 0.0, 5.0)
    stage = build_stage_data(model, cfg, sched, targets, 0.0)
    outputs, warm = [], [None]

    def solve():
        w = warm[0]
        sol = solver.solve(stage, x0, warm=None if w is None else (w.times, w.X, w.U))
        warm[0] = sol
        outputs.append(tuple(getattr(sol, f).numpy().copy() for f in ("times", "X", "U")))
        return PolicyStore(times=sol.times, X=sol.X, U=sol.U)

    mbox = t_async.PolicyMailbox(n_nodes=solver.n_intervals + 1)
    loop = t_async.AsyncMpcLoop(solve, mpc_hz=100.0, mailbox=mbox, device="cpu")
    loop.start()
    reads = []
    while len(outputs) < 3 and loop.error is None:
        seq, policy = mbox.latest()
        if seq:
            reads.append((seq, policy))
        time.sleep(0.01)
    loop.stop()
    assert loop.error is None
    reads.append(mbox.latest())
    assert [s for s, _ in reads] == sorted(s for s, _ in reads)
    for seq, policy in reads:
        out = outputs[seq // 2 - 1]
        for a, b in zip((policy.times, policy.X, policy.U), out):
            np.testing.assert_array_equal(a, b)
    assert reads[-1][0] == 2 * len(outputs)


def test_realtime_run_on_the_cpu():
    """realtime_run.py's path at N = 10 on the CPU for 2 ticks: the MPC
    thread solved and published beside the control loop, every tick read a
    published policy bit for bit, the sequence never fell, every tick safe
    and the base at its height."""
    sys.path.insert(0, ROOT)
    import realtime_run

    run = realtime_run.RealtimeRun(duration=0.004, horizon=HORIZON, device="cpu")
    run.prepare()
    assert run.solve_alone_ms > 0.0
    res = run.run()
    assert res["safe"] and res["ctrl"]["ticks"] == 2 and res["impl"] == "torch"
    assert res["solves_completed"] >= 1 and res["mpc"]["solves"] == res["solves_completed"]
    assert res["mailbox"]["reads"] == 2 and res["mailbox"]["seq_never_fell"]
    assert res["mailbox"]["every_read_published"]
    assert res["overruns"] == res["ctrl"]["overruns"] >= 1  # a tick takes longer than 2 ms
    assert res["base_height_max_dev_m"] < 0.05 and res["base_roll_pitch_max_rad"] < 0.1
    assert res["solve_device_ms"] is None and res["dispatch_rtt_ms"] is None


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the refusal without CUDA")
def test_realtime_run_refuses_to_start_without_cuda():
    out = subprocess.run([sys.executable, os.path.join(ROOT, "realtime_run.py"),
                          "--duration", "0.002"], capture_output=True, text=True, timeout=120)
    assert out.returncode == 2
    assert "--device cpu" in out.stderr or "device='cpu'" in out.stderr
    assert out.stdout.strip() == ""
