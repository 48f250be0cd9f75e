"""The batched closed loop (sim/batched_rollout.py:BatchedClosedLoop), torch
port against the JAX package in float64 on the CPU, in one JAX reference
call a test run (torch_parity.shared_reference): B = 3 scenarios, N = 10
nodes, 2 MPC cycles of 4 physics steps with a WBC tick every 2, the trot
from t = 0.

- scenario 0 is nominal, scenario 1 carries an external wrench on its base,
  scenario 2 starts with its roll past pi/2, so the quarantine freezes its
  carry at the first cycle while the other two go on;
- the port runs its batch-major SQP iteration (``bm_k1``), JAX vmaps its
  per-scenario one (tests/test_batched_sqp.py holds the two equal);
- held at 1e-8 (rtol = atol): the log's base pose, MPC cost and violation
  of scenarios 0 and 1 after each cycle, and the final carry (physics
  state, delay ring, warm start, WBC memory, command) of both; for
  scenario 2, ``alive`` and its frozen carry (equal to its initial one
  exactly), not its solve, which need not be finite;
- ``alive`` exactly; the initial carry, ``_flags_at``, the batched warm
  start and ``stack_stages`` against JAX's (no loop compile: each test
  that reads the loop reference may wait for it);
- ``solve_chunk`` and ``cycle_chunk`` against the unchunked port loop (port
  against port): the same log and carry at 1e-12.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qm_door_torch import convert
from qm_door_torch.models.model import aliengo_z1 as t_aliengo_z1
from qm_door_torch.ocp.gait import GAIT_LIBRARY as T_GAITS
from qm_door_torch.ocp.gait import GaitSchedule as TGaitSchedule
from qm_door_torch.ocp.problem import make_ocp_config as t_make_ocp_config
from qm_door_torch.sim import batched_rollout as t_br
from qm_door_torch.sim.sim import SimConfig as TSimConfig
from qm_door_torch.solver.sqp import SqpSolver as TSqpSolver
from torch_parity import F64, as_numpy_fields, configs, shared_reference, to_np
from torch_parity import release_jax_executables  # noqa: F401 (autouse, module scope)

B, CYCLES, MPC_DECIM, CONTROL_DECIM = 3, 2, 4, 2
TOL = dict(rtol=1e-8, atol=1e-8)
CHUNK_TOL = dict(rtol=1e-12, atol=1e-12)
WRENCH = (25.0, -15.0, -30.0, 1.0, 0.5, -0.5)  # scenario 1, every cycle
ROLL = 1.7  # scenario 2's roll (rad), past pi/2
LIVE = [0, 1]


def _inputs():
    """The three scenarios' start (q0b (3, 24): the nominal pose with its
    feet on the ground; scenario 1 moved 1 cm, scenario 2 rolled past
    pi/2) and the wrenches (CYCLES, 3, 6): scenario 1's every cycle."""
    from qm_door_torch.models import centroidal, kinematics

    cfg = configs()[1]
    q0 = centroidal.pinocchio_q(torch.tensor(cfg.initial_state(), dtype=F64)).clone()
    q0[2] -= kinematics.contact_positions(t_aliengo_z1(dtype=F64, device="cpu"), q0)[:, 2].mean()
    q0b = np.tile(q0.numpy(), (B, 1))
    q0b[1, 0] += 0.01
    q0b[2, 5] = ROLL
    wrenches = np.zeros((CYCLES, B, 6))
    wrenches[:, 1] = WRENCH
    return q0b, wrenches


class Jax:
    """The JAX package's loop on the same problem, not yet run."""

    def __init__(self):
        from qm_door_tpu.models import aliengo_z1, kinematics, spatial
        from qm_door_tpu.ocp.gait import GAIT_LIBRARY, GaitSchedule
        from qm_door_tpu.ocp.problem import make_ocp_config
        from qm_door_tpu.ocp.reference import TargetTrajectories
        from qm_door_tpu.sim.batched_rollout import BatchedClosedLoop, stack_stages
        from qm_door_tpu.sim.sim import SimConfig
        from qm_door_tpu.solver.sqp import SqpSolver

        cfg = configs()[0]
        jm = aliengo_z1(dtype=jnp.float64)
        self.loop = BatchedClosedLoop(jm, cfg, SqpSolver(jm, make_ocp_config(jm, cfg), cfg),
                                      SimConfig(), CONTROL_DECIM, MPC_DECIM)
        x0 = jnp.asarray(cfg.initial_state())
        R_ee, p_ee = kinematics.ee_pose(jm, x0[6:30])
        tstate = jnp.concatenate([x0, p_ee, spatial.rot_to_quat(R_ee)])
        targets = TargetTrajectories.create(
            jnp.array([0.0, 1e5]), jnp.stack([tstate, tstate]), jnp.zeros((2, 30)))
        sched = GaitSchedule()
        sched.insert_template(GAIT_LIBRARY["trot"], 0.0, 5.0)
        self.stages = stack_stages(jm, cfg, sched, targets, 0.0, CYCLES, MPC_DECIM * 0.001,
                                   jnp.float64)
        self.q0b, self.wrenches = _inputs()

    def init_carry(self):
        return self.loop.init_carry(jax.tree.map(lambda a: a[0], self.stages),
                                    jnp.asarray(self.q0b))


def _jax_rollout():
    """JAX's whole loop on the three scenarios: the initial and final carry
    and the log."""
    j = Jax()
    carry0 = j.init_carry()
    carry, log = j.loop.run(j.stages, carry0, jnp.asarray(j.wrenches))
    return dict(carry0=carry0, carry=carry, log=log)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """JAX's loop, once per test run (~140 s of compile on one worker)."""
    return shared_reference(tmp_path_factory, "BatchedClosedLoop.run", _jax_rollout, *_inputs())


@pytest.fixture(scope="module")
def jax_side():
    return Jax()


def _carry_fields(carry):
    return {**as_numpy_fields(carry), "sim": as_numpy_fields(carry.sim)}


class Port:
    """The port's side of the same loop: model, solver, its own stacked
    stages and initial carry, the wrenches."""

    def __init__(self):
        from qm_door_torch.models import kinematics, spatial
        from qm_door_torch.ocp.reference import TargetTrajectories

        self.cfg = configs()[1]
        self.model = t_aliengo_z1(dtype=F64, device="cpu")
        self.solver = TSqpSolver(self.model, t_make_ocp_config(self.model, self.cfg), self.cfg)
        x0 = torch.tensor(self.cfg.initial_state(), dtype=F64)
        R_ee, p_ee = kinematics.ee_pose(self.model, x0[6:30])
        tstate = torch.cat([x0, p_ee, spatial.rot_to_quat(R_ee)])
        targets = TargetTrajectories.create(torch.tensor([0.0, 1e5], dtype=F64),
                                            torch.stack([tstate, tstate]),
                                            torch.zeros(2, 30, dtype=F64))
        sched = TGaitSchedule()
        sched.insert_template(T_GAITS["trot"], 0.0, 5.0)
        self.stages = t_br.stack_stages(self.model, self.cfg, sched, targets, 0.0, CYCLES,
                                        MPC_DECIM * 0.001, F64)
        q0b, wrenches = _inputs()
        self.q0b = torch.as_tensor(q0b)
        self.carry0 = self.loop().init_carry(t_br.cycle_stage(self.stages, 0), self.q0b)
        self.wrenches = torch.as_tensor(wrenches)

    def loop(self, **kw):
        return t_br.BatchedClosedLoop(self.model, self.cfg, self.solver, TSimConfig(),
                                      CONTROL_DECIM, MPC_DECIM, **kw)

    def run(self, **kw):
        return self.loop(**kw).run(self.stages, self.carry0, self.wrenches)


@pytest.fixture(scope="module")
def port():
    return Port()


def _outcome(carry, log):
    """A run's final carry (by dotted name) and log, as numpy."""
    return dict(carry=_flat(carry), log={k: to_np(v) for k, v in vars(log).items()})


@pytest.fixture(scope="module")
def run(tmp_path_factory, port):
    """The port's unchunked loop, run once per test run like the reference
    (the tests that read it may sit on several workers)."""
    return shared_reference(tmp_path_factory, "port BatchedClosedLoop.run",
                            lambda: _outcome(*port.run()), *_inputs())


def _flat(carry):
    """A carry's tensors (or arrays) by dotted name."""
    out = {}
    for name, v in (_carry_fields(carry) if not isinstance(carry, t_br.RolloutCarry) else
                    {**vars(carry), "sim": vars(carry.sim)}).items():
        if isinstance(v, dict):
            out.update({f"sim.{k}": to_np(a) for k, a in v.items()})
        else:
            out[name] = to_np(v)
    return out


def test_init_carry_matches_jax(port, jax_side):
    want = _flat(jax_side.init_carry())
    for name, a in _flat(port.carry0).items():
        np.testing.assert_allclose(a, want[name], err_msg=name, rtol=1e-12, atol=1e-12)
    assert port.carry0.sim.buf_head.dtype == torch.int64
    assert port.carry0.alive.dtype == torch.bool
    # the carrier brings JAX's carry across as it is
    carried = _flat(convert.rollout_carry_from_numpy(_carry_fields(jax_side.init_carry()),
                                                     device="cpu"))
    for name, a in carried.items():
        np.testing.assert_array_equal(a, want[name], err_msg=name)


def test_stack_stages_matches_jax(port, jax_side):
    """The port's own stacked stage data for the same schedule and targets."""
    for f in dataclasses.fields(port.stages):
        a, want = getattr(port.stages, f.name), getattr(jax_side.stages, f.name)
        if a is None:
            assert want is None
            continue
        assert a.shape[0] == CYCLES
        np.testing.assert_allclose(to_np(a), np.asarray(want), err_msg=f.name,
                                   rtol=1e-12, atol=1e-12)


FLAG_TIMES = (0.0, 0.0031, 0.16, 0.5)


def test_flags_at_and_batched_warm_start_match_jax(port, jax_side):
    from qm_door_tpu.sim.batched_rollout import _flags_at as j_flags_at

    j_stage = jax.tree.map(lambda a: a[1], jax_side.stages)
    stage = t_br.cycle_stage(port.stages, 1)
    for t in FLAG_TIMES:
        got = t_br._flags_at(stage, torch.tensor(t, dtype=F64))
        np.testing.assert_array_equal(to_np(got), np.asarray(j_flags_at(j_stage, t)))
    rng = np.random.default_rng(4)
    N = port.solver.n_intervals
    X, U = rng.normal(size=(B, N + 1, 30)), rng.normal(size=(B, N, 30))
    prev = j_stage.times - MPC_DECIM * 0.001
    want = jax.vmap(lambda a, b: jax_side.loop.solver.warm_start(prev, a, b, j_stage.times))(
        jnp.asarray(X), jnp.asarray(U))
    got = port.solver.warm_start(stage.times - MPC_DECIM * 0.001, torch.as_tensor(X),
                                 torch.as_tensor(U), stage.times)
    for a, b in zip(got, want):
        np.testing.assert_allclose(to_np(a), np.asarray(b), rtol=1e-12, atol=1e-12)


def test_log_matches_jax(run, ref):
    """Base pose, MPC cost and violation of the live scenarios after each
    cycle; ``alive`` of all three, scenario 2 quarantined from cycle 0."""
    log, jlog = run["log"], ref["log"]
    np.testing.assert_array_equal(log["alive"], np.asarray(jlog.alive))
    np.testing.assert_array_equal(log["alive"], [[True, True, False]] * CYCLES)
    for name in ("base_pose", "mpc_cost", "mpc_viol"):
        got, want = log[name], np.asarray(getattr(jlog, name))
        assert got.shape == want.shape, name
        np.testing.assert_allclose(got[:, LIVE], want[:, LIVE], err_msg=name, **TOL)
    assert np.isfinite(log["base_pose"]).all()
    # the robots moved: two cycles are 8 ms of physics with the MPC's plan
    assert np.abs(log["base_pose"][-1, LIVE] - log["base_pose"][0, LIVE]).max() > 1e-6


def test_final_carry_matches_jax(run, ref):
    want = _flat(ref["carry"])
    assert sorted(run["carry"]) == sorted(want)
    for name, a in run["carry"].items():
        if name == "alive":
            np.testing.assert_array_equal(a, want[name])
        else:
            np.testing.assert_allclose(a[LIVE], want[name][LIVE], err_msg=name, **TOL)


def test_quarantine_freezes_the_fallen_scenario(port, run, ref):
    """Scenario 2's carry after both cycles is its initial carry, bit for
    bit, in the port and in JAX; its logged pose is the frozen one."""
    start, want, j_start = _flat(port.carry0), _flat(ref["carry"]), _flat(ref["carry0"])
    assert not run["carry"]["alive"][2] and not want["alive"][2]
    for name, a in run["carry"].items():
        if name == "alive":
            continue
        np.testing.assert_array_equal(a[2], start[name][2], err_msg=name)
        np.testing.assert_array_equal(want[name][2], j_start[name][2], err_msg=name)
    np.testing.assert_array_equal(run["log"]["base_pose"][:, 2],
                                  np.tile(to_np(port.q0b)[2, 0:6], (CYCLES, 1)))


@pytest.mark.parametrize("chunk", ["solve_chunk", "cycle_chunk"])
def test_chunks_match_the_unchunked_loop(port, run, chunk):
    """At most 2 scenarios in a stage at once (a full and a ragged chunk):
    the same log and carry as the unchunked loop."""
    got = _outcome(*port.run(**{chunk: 2}))
    for name in ("base_pose", "mpc_cost", "mpc_viol"):
        np.testing.assert_allclose(got["log"][name][:, LIVE], run["log"][name][:, LIVE],
                                   err_msg=name, **CHUNK_TOL)
    np.testing.assert_array_equal(got["log"]["alive"], run["log"]["alive"])
    for name, a in got["carry"].items():
        np.testing.assert_allclose(a, run["carry"][name], err_msg=name, **CHUNK_TOL)


def test_unknown_backend_is_refused(port):
    with pytest.raises(ValueError, match="backend"):
        port.loop(backend="bm_pallas")
