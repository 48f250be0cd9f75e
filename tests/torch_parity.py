"""Shared set-up of the torch-port parity tests (tests/test_torch_*.py): the
same short-horizon trot problem built in both packages, in float64 on the
CPU, with the JAX objects carried across through qm_door_torch.convert; and the
run-wide store of the expensive JAX references (``shared_reference``)."""
import dataclasses
import fcntl
import hashlib
import json
import os
import pickle

import numpy as np
import pytest
import torch

# one intra-op thread a process: the test workers (xdist) already share the
# machine's cores, and torch's default (a thread a core in every worker)
# oversubscribes them several times over
torch.set_num_threads(1)

CPU = torch.device("cpu")
F64 = torch.float64
HORIZON = 0.15  # N = 10 nodes at dt 0.015


def as_numpy_fields(obj):
    """A JAX dataclass as a mapping of field name -> numpy array / value."""
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        out[f.name] = v if v is None or isinstance(v, (bool, int, float, str, tuple)) \
            else np.asarray(v)
    return out


@pytest.fixture(scope="module", autouse=True)
def release_jax_executables():
    """After a test module's last test on a worker, drop every executable
    JAX holds in memory (jax.clear_caches): a worker's compiled executables
    pile up over the run, and the XLA CPU compiler aborts once enough have
    (pytest.ini); the suite's last files run on workers that have run
    these. Each test module that imports it gets it."""
    yield
    import jax

    jax.clear_caches()


def _run_dir(tmp_path_factory):
    """The directory of this test run that every xdist worker of it shares
    (the workers' base temps sit in the controller's), or the base temp of
    a run without workers. pytest makes a new one for every run."""
    base = tmp_path_factory.getbasetemp()
    return base.parent if os.environ.get("PYTEST_XDIST_WORKER") else base


def shared_reference(tmp_path_factory, name, compute, *inputs):
    """The value of ``compute()`` (a pytree of JAX or numpy arrays) as numpy,
    computed once per test run: the first worker to ask computes it under a
    lock file and stores it in the run's temp directory; the others wait for
    the lock and read it. Keyed by ``name`` (what it computes) and the bytes
    of ``inputs`` (what it is computed from), so test files that build the
    same reference share it. Nothing outlives the run: a new run has a new
    directory and computes every reference again."""
    import jax

    key = hashlib.sha256(name.encode())
    for a in inputs:
        a = np.ascontiguousarray(np.asarray(a))
        key.update(f"{a.dtype}{a.shape}".encode())
        key.update(a.tobytes())
    root = _run_dir(tmp_path_factory) / "jax_references"
    root.mkdir(exist_ok=True)
    path = root / f"{key.hexdigest()[:32]}.pkl"
    with open(f"{path}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if path.exists():
            with open(path, "rb") as f:
                return pickle.load(f)
        value = jax.tree.map(np.asarray, compute())
        with open(f"{path}.tmp", "wb") as f:
            pickle.dump(value, f)
        os.replace(f"{path}.tmp", path)
        return value


def to_np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def configs(lin_tangents="analytic", quad_only=False):
    from qm_door_torch import config as t_config
    from qm_door_tpu import config as j_config

    name = "quad_only_config" if quad_only else "default_config"
    out = []
    for make in (getattr(j_config, name), getattr(t_config, name)):
        cfg = make()
        cfg.mpc.time_horizon = HORIZON
        cfg.sqp.linesearch_steps = 2
        cfg.sqp.lin_tangents = lin_tangents
        cfg.sqp.sensitivity = "frozen"
        out.append(cfg)
    return out


class Problem:
    """Both packages' model, OCP config, stage data and a perturbed batch."""

    def __init__(self, B=3, seed=3, lin_tangents="analytic", x_scale=0.03, quad_only=False):
        import jax.numpy as jnp
        from qm_door_tpu.models import aliengo_z1, kinematics, spatial
        from qm_door_tpu.ocp.gait import GAIT_LIBRARY, GaitSchedule
        from qm_door_tpu.ocp.problem import build_stage_data, make_ocp_config
        from qm_door_tpu.ocp.reference import TargetTrajectories
        from qm_door_torch import convert
        from qm_door_torch.models.model import aliengo_z1 as t_aliengo_z1
        from qm_door_torch.ocp.problem import make_ocp_config as t_make_ocp_config

        self.jcfg, self.tcfg = configs(lin_tangents, quad_only)
        self.jmodel = aliengo_z1(dtype=jnp.float64)
        self.jocp = make_ocp_config(self.jmodel, self.jcfg)
        x0 = jnp.asarray(self.jcfg.initial_state())
        R_ee, p_ee = kinematics.ee_pose(self.jmodel, x0[6:30])
        tstate = jnp.concatenate([x0, p_ee, spatial.rot_to_quat(R_ee)])
        self.jtargets = TargetTrajectories.create(
            jnp.array([0.0, 1e5]), jnp.stack([tstate, tstate]), jnp.zeros((2, 30)))
        sched = GaitSchedule()
        sched.insert_template(GAIT_LIBRARY["trot"], 0.0, 5.0)
        self.jstage = build_stage_data(self.jmodel, self.jcfg, sched, self.jtargets, 0.0)

        self.tmodel = t_aliengo_z1(dtype=F64, device="cpu")
        self.tocp = t_make_ocp_config(self.tmodel, self.tcfg)
        self.tstage = convert.stage_data_from_numpy(as_numpy_fields(self.jstage), device="cpu")
        self.ttargets = convert.target_trajectories_from_numpy(
            as_numpy_fields(self.jtargets), device="cpu")

        rng = np.random.default_rng(seed)
        self.N = int(round(HORIZON / self.jcfg.sqp.dt))
        self.xb = np.asarray(x0)[None] + rng.normal(size=(B, 30)) * x_scale
        self.X = np.tile(self.xb[:, None, :], (1, self.N + 1, 1))
        self.U = np.broadcast_to(np.asarray(self.jstage.u_nom[:self.N]), (B, self.N, 30)).copy()

    def t(self, a):
        return torch.tensor(np.asarray(a), dtype=F64)


GRASP_FROM = 0.06  # s: the short horizon's later nodes grasp
WRENCH_REF = (4.0, 0.0, -9.0, 0.0, 0.0, 0.4)


class ProblemFT(Problem):
    """The force-tracking problem (nu = 36) in both packages: the trot stage
    widened with a grasp from GRASP_FROM on and the wrench reference
    WRENCH_REF, the widened R, and inputs with zero wrench (each package's
    own ocp/force.py builds its side)."""

    def __init__(self, B=2, seed=5, lin_tangents="analytic", x_scale=0.03):
        from qm_door_torch.ocp import force as t_force
        from qm_door_tpu.ocp import force as j_force

        super().__init__(B=B, seed=seed, lin_tangents=lin_tangents, x_scale=x_scale)
        times = np.asarray(self.jstage.times)
        self.grasp = (times >= GRASP_FROM).astype(float)
        self.wref = np.tile(np.asarray(WRENCH_REF), (times.shape[0], 1))
        self.jocp = j_force.make_ocp_config_ft(self.jmodel, self.jcfg)
        self.jstage = j_force.widen_stage_data(self.jstage, self.grasp, self.wref)
        self.tocp = t_force.make_ocp_config_ft(self.tmodel, self.tcfg)
        self.tstage = t_force.widen_stage_data(self.tstage, self.grasp, self.wref)
        self.U = np.concatenate([self.U, np.zeros(self.U.shape[:-1] + (6,))], axis=-1)


def jax_loop_states(dtype_name, batch=4, cycles=2):
    """The JAX package's closed loop in ``dtype_name`` ("float32" or
    "float64") on chip_smoke.py (i)'s configuration and its first `batch`
    scenarios (AlienGo+Z1, default_config() with lin_chunk = 0, the trot from
    t = 0, N = 67, SimConfig(), 10 physics steps a cycle, a WBC tick every
    2, the bench's payloads and pushes), on the CPU: q (cycles, batch, 24)
    after each cycle, as float64 numpy. Run in a process of its own: the
    float32 loop needs x64 off, as tools/rollout_bench.py runs it."""
    import sys

    import jax
    import jax.numpy as jnp

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", dtype_name == "float64")
    jax.config.update("jax_default_matmul_precision", "highest")
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import chip_smoke
    from qm_door_tpu.config import default_config
    from qm_door_tpu.models import aliengo_z1, kinematics, spatial
    from qm_door_tpu.ocp.gait import GAIT_LIBRARY, GaitSchedule
    from qm_door_tpu.ocp.problem import make_ocp_config
    from qm_door_tpu.ocp.reference import TargetTrajectories
    from qm_door_tpu.sim.batched_rollout import BatchedClosedLoop, stack_stages
    from qm_door_tpu.sim.sim import SimConfig
    from qm_door_tpu.solver.sqp import SqpSolver

    dtype = getattr(jnp, dtype_name)
    cfg = default_config()
    cfg.sqp.lin_chunk = 0
    model = aliengo_z1(dtype=dtype)
    # the start in float64, the same for both runs and for chip_smoke.py's
    # (the port's model grounds the feet, as there)
    from qm_door_torch.models import kinematics as t_kin
    from qm_door_torch.models.model import aliengo_z1 as t_aliengo_z1

    q0 = torch.tensor(cfg.initial_state()[6:30], dtype=F64)
    q0[2] -= t_kin.contact_positions(t_aliengo_z1(dtype=F64, device="cpu"), q0)[:, 2].mean()
    q0b, wr = chip_smoke.loop_inputs(q0.numpy(), batch, cycles)
    loop = BatchedClosedLoop(model, cfg, SqpSolver(model, make_ocp_config(model, cfg, dtype=dtype),
                                                   cfg),
                             SimConfig(), chip_smoke.LOOP_CONTROL_DECIM, chip_smoke.LOOP_MPC_DECIM)
    x0 = jnp.asarray(cfg.initial_state(), dtype=dtype)
    R_ee, p_ee = kinematics.ee_pose(model, x0[6:30])
    tstate = jnp.concatenate([x0, p_ee, spatial.rot_to_quat(R_ee)])
    targets = TargetTrajectories.create(jnp.array([0.0, 1e5], dtype=dtype),
                                        jnp.stack([tstate, tstate]),
                                        jnp.zeros((2, 30), dtype=dtype))
    sched = GaitSchedule()
    sched.insert_template(GAIT_LIBRARY["trot"], 0.0, 60.0)
    stages = stack_stages(model, cfg, sched, targets, 0.0, cycles,
                          chip_smoke.LOOP_MPC_DECIM * 0.001, dtype)
    carry = loop.init_carry(jax.tree.map(lambda a: a[0], stages), jnp.asarray(q0b, dtype))
    qs = []
    for i in range(cycles):  # one cycle a call: the state after each
        carry, _ = loop.run(jax.tree.map(lambda a: a[i:i + 1], stages), carry,
                            jnp.asarray(wr[i:i + 1], dtype))
        qs.append(np.asarray(carry.sim.q, dtype=np.float64))
    assert bool(np.asarray(carry.alive).all())
    return np.stack(qs)


def jax_loop_f32_deviation():
    """How far the JAX package's own f32 closed loop strays from its f64 loop
    on the same inputs (jax_loop_states, each in a process of its own): the
    max abs difference of the base pose and of the joint positions after
    each cycle. The card's f32 loop is held to twice these, rounded up,
    against the CPU's f64 loop (chip_smoke.LOOP_CROSS_BARS)."""
    import subprocess
    import sys

    q = {}
    for name in ("float32", "float64"):
        out = subprocess.run([sys.executable, os.path.abspath(__file__), "loop-states", name],
                             capture_output=True, text=True, check=True)
        q[name] = np.asarray(json.loads(out.stdout.strip().splitlines()[-1]))
    d = np.abs(q["float32"] - q["float64"]).max(axis=1)  # (cycles, 24)
    return {"base_pose_dev_by_cycle": d[:, 0:6].max(axis=1).tolist(),
            "joint_q_dev_by_cycle": d[:, 6:24].max(axis=1).tolist()}


if __name__ == "__main__":
    import sys

    if sys.argv[1:2] == ["loop-states"]:
        print(json.dumps(jax_loop_states(sys.argv[2]).tolist()))
    elif sys.argv[1:] == ["loop-bars"]:
        print(json.dumps(jax_loop_f32_deviation()))
    else:
        sys.exit("usage: python tests/torch_parity.py loop-bars")
