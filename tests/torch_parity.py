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


# The controller tick's cases (tests/test_torch_controller.py and
# tests/test_torch_wbc_single.py): the JAX package's QmController of each
# variant is built once a test run and its jitted tick serves both files.
TICK_N = 10
TICK_PERIOD = 0.002
TICK_GATES = dict(leg_pd_start_time=0.05, arm_init_time=0.1)
# before both gates; the legs on, the arm still initializing; after both
TICK_TIMES = (0.03, 0.07, 0.12)
TICK_GRASP = (1.0, 0.0, 1.0)
# the float64 ticks against JAX's, relative to max|wbc_cmd|: 1e-8, and 1e-7
# for the combined stack (arm_locked too) while t < arm_init_time. There T1
# is the arm-joint hold alone, so the swing legs' joint accelerations are
# pinned by nothing but the levels' 1e-9 regularization: on these inputs the JAX package's
# own jitted and eager ticks differ by up to 8.2e-9 of max|cmd|, and the
# port's (K1's plain Cholesky in float64) by up to 6.5e-8, unchanged from
# 30 to 60 interior-point iterations.
TICK_BAR = 1e-8
TICK_BAR_ARM_INIT = 1e-7
TICK_VARIANTS = {
    "combined": dict(separated=False, force_tracking=False, arm_locked=False),
    "arm_locked": dict(separated=False, force_tracking=False, arm_locked=True),
    "separated": dict(separated=True, force_tracking=False, arm_locked=False),
    "ft_priority0": dict(separated=False, force_tracking=True, wrench_priority=0),
    "ft_priority2": dict(separated=False, force_tracking=True, wrench_priority=2),
}
# the combined variant's QmController sequence: ticks at these times, the
# gains swapped (TICK_SWAP) before the fourth
TICK_SEQ_TIMES = (0.11, 0.112, 0.114, 0.116, 0.118)
TICK_SWAP = dict(swing_kp=500.0, base_height_kp=300.0, friction_coefficient=0.5)


def tick_config(module, variant):
    """The default config of ``module`` (either package's config module)
    with the tick cases' gates and the variant's arm lock and wrench
    priority."""
    cfg = module.default_config()
    cfg.controller.leg_pd_start_time = TICK_GATES["leg_pd_start_time"]
    cfg.wbc.arm_init_time = TICK_GATES["arm_init_time"]
    spec = TICK_VARIANTS[variant]
    cfg.model.arm_locked = spec.get("arm_locked", False)
    cfg.force_tracking.wrench_priority = spec.get("wrench_priority", 0)
    return cfg


def tick_inputs(variant, seed=0):
    """Seeded tick inputs (numpy float64): a policy of TICK_N nodes near the
    nominal pose (times, X, U; U 36 wide with a wrench when force-tracking),
    a trot pair's contact flags, the measured rbd of a perturbed pose with
    its yaw near +pi and yaw_last near -pi (the unwrap crosses the wrap),
    the last input. The policy's yaw is the unwrapped one, near -pi: a
    planned heading half a turn off the measured one would put the WBC's
    orientation error at the log map's cut (pi), where both packages'
    ticks move by ~1e-7 of max|cmd| under rounding alone."""
    from qm_door_torch import config as t_config
    from qm_door_torch.models import centroidal as t_cen
    from qm_door_torch.models.model import aliengo_z1 as t_aliengo_z1

    rng = np.random.default_rng(seed)
    nu = 36 if TICK_VARIANTS[variant]["force_tracking"] else 30
    x0 = t_config.default_config().initial_state()
    flags = np.array([1.0, 0.0, 0.0, 1.0])
    tm = t_aliengo_z1(dtype=F64, device="cpu")
    u0 = to_np(t_cen.weight_compensating_input(tm, torch.as_tensor(flags)))
    if nu == 36:
        u0 = np.concatenate([u0, [5.0, 0.0, -3.0, 0.0, 0.0, 0.5]])
    times = np.linspace(0.0, TICK_N * 0.015, TICK_N + 1) + 0.02
    X = x0[None] + rng.normal(size=(TICK_N + 1, 30)) * 0.01
    X[:, 9] += -np.pi - 0.02
    U = u0[None] + rng.normal(size=(TICK_N, nu)) * 0.05
    q = x0[6:30] + rng.normal(size=24) * 0.01
    q[3] = np.pi - 0.02
    v = rng.normal(size=24) * 0.1
    rbd = to_np(t_cen.rbd_from_generalized(tm, torch.as_tensor(q), torch.as_tensor(v)))
    last = u0 + rng.normal(size=nu) * 1e-3
    return dict(times=times, X=X, U=U, flags=flags, rbd=rbd, input_last=last,
                yaw_last=-np.pi + 0.03)


def _tick_out(res):
    c = res.command
    return dict(pos_des=c.pos_des, vel_des=c.vel_des, kp=c.kp, kd=c.kd, tau_ff=c.tau_ff,
                x_obs=res.x_obs, x_opt=res.x_opt, u_opt=res.u_opt, wbc_cmd=res.wbc_cmd,
                safe=res.safe, input_last=res.wbc_state.input_last)


def jax_tick_references(variant):
    """The JAX package's ticks of a variant on tick_inputs(variant), in
    float64: through one QmController's jitted tick, at each of TICK_TIMES
    (grasp TICK_GRASP), and for "combined" also QmController.tick at
    TICK_SEQ_TIMES carrying yaw_last, with TICK_SWAP's gains from the
    fourth tick on."""
    import jax.numpy as jnp
    from qm_door_tpu import config as j_config
    from qm_door_tpu.models import aliengo_z1
    from qm_door_tpu.runtime.controller import QmController
    from qm_door_tpu.runtime.mrt import PolicyStore
    from qm_door_tpu.wbc.wbc import WbcState

    spec = TICK_VARIANTS[variant]
    model = aliengo_z1(dtype=jnp.float64)
    ctl = QmController(model, tick_config(j_config, variant), separated=spec["separated"],
                       force_tracking=spec["force_tracking"])
    a = {k: jnp.asarray(v) for k, v in tick_inputs(variant).items()}
    policy = PolicyStore(times=a["times"], X=a["X"], U=a["U"])
    state = WbcState(input_last=a["input_last"])
    out = {}
    for k, (t, grasp) in enumerate(zip(TICK_TIMES, TICK_GRASP)):
        res = ctl._tick(ctl.gains, ctl.ctrl, policy, a["flags"], a["rbd"], state,
                        jnp.asarray(t), jnp.asarray(TICK_PERIOD), a["yaw_last"],
                        grasp=jnp.asarray(grasp))
        out[f"t{k}"] = _tick_out(res)
    if variant == "combined":
        ctl.yaw_last = float(a["yaw_last"])
        for k, t in enumerate(TICK_SEQ_TIMES):
            if k == 3:
                ctl.gains = ctl.gains.replace(**{
                    name: jnp.asarray(v, dtype=jnp.float32) for name, v in TICK_SWAP.items()})
            res = ctl.tick(policy, a["flags"], a["rbd"], state, t, TICK_PERIOD)
            state = res.wbc_state
            out[f"seq{k}"] = dict(_tick_out(res), yaw_last=ctl.yaw_last)
    return out


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


def _jax_trot_runner(dtype_name, runner_kw=None):
    """tools/record_trace.py:canonical_trot_run's set-up in the JAX package
    on the CPU, in ``dtype_name`` ("float32": x64 off, as the JAX package
    runs on its chip; "float64"): (runner, targets)."""
    import sys

    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", dtype_name == "float64")
    jax.config.update("jax_default_matmul_precision", "highest")
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import jax.numpy as jnp
    from qm_door_tpu.config import default_config
    from qm_door_tpu.models import aliengo_z1, kinematics, spatial
    from qm_door_tpu.ocp.gait import GAIT_LIBRARY, GaitSchedule
    from qm_door_tpu.ocp.reference import TargetTrajectories
    from qm_door_tpu.sim.closed_loop import ClosedLoopRunner

    dtype = getattr(jnp, dtype_name)
    model = aliengo_z1(dtype=dtype)
    cfg = default_config()
    cfg.controller.leg_pd_start_time = -1.0
    cfg.wbc.arm_init_time = -1.0
    x0 = jnp.asarray(cfg.initial_state(), dtype=dtype)
    R_ee, p_ee = kinematics.ee_pose(model, x0[6:30])
    state = jnp.concatenate([x0, p_ee, spatial.rot_to_quat(R_ee)])
    targets = TargetTrajectories.create(jnp.array([0.0, 1e5], dtype=dtype),
                                        jnp.stack([state, state]), jnp.zeros((2, 30), dtype=dtype))
    sched = GaitSchedule()
    sched.insert_template(GAIT_LIBRARY["trot"], 0.0, 7.0)  # the golden's 2 s run's template
    return ClosedLoopRunner(model, cfg, schedule=sched, **(runner_kw or {})), targets


def _log_lists(log):
    as_list = lambda rows: np.asarray(rows, dtype=np.float64).tolist()  # noqa: E731
    return {"t": as_list(log.t), "base_pose": as_list(log.base_pose), "tau": as_list(log.tau),
            "ee_pos": as_list(log.ee_pos), "x_obs": as_list(log.x_obs), "safe": bool(log.safe)}


def jax_trot_log(dtype_name, duration, runner_kw=None):
    """tools/record_trace.py:canonical_trot_run's run in ``dtype_name`` on
    the CPU for ``duration`` s (_jax_trot_runner): the log's t, base pose,
    torques, EE position and observation as float64 lists, and safe. Run
    in a process of its own."""
    runner, targets = _jax_trot_runner(dtype_name, runner_kw)
    return _log_lists(runner.run(targets, duration=duration))


def port_trot_log(dtype_name, duration):
    """The torch port's canonical trot (chip_smoke.trot_runner) on the CPU in
    ``dtype_name`` for ``duration`` s, two torch threads: as jax_trot_log."""
    import sys

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import chip_smoke

    torch.set_num_threads(2)
    runner, targets = chip_smoke.trot_runner(CPU, getattr(torch, dtype_name))
    return _log_lists(runner.run(targets, duration=duration))


TROT_SWAPS = ("none", "tick", "solve", "rbd", "sim", "sim_dynamics", "sim_contacts")


def jax_trot_swapped(component="none", duration=2.0, height_offset=0.0):
    """The JAX package's f32 canonical trot (_jax_trot_runner, ground truth,
    the loop of its ClosedLoopRunner.run) on the CPU with one part taken
    from the torch port in f32, two torch threads: the controller tick
    ("tick"), the MPC solve ("solve"), the rbd state read from the
    simulation ("rbd"), the physics step ("sim"), or the port's physics step
    with JAX's contact forces ("sim_dynamics": the port's forward dynamics
    left) or with JAX's forward dynamics ("sim_contacts": the port's contact
    forces left). ``height_offset`` (m) raises the spawn, as
    ClosedLoopRunner.run's start_height_offset does. Returns the log as
    jax_trot_log does; with "sim" also the f32 forward dynamics of both
    packages on the run's states (every 25th step from 1.3 s, no applied
    force) against the port's f64: the max abs acceleration error of each,
    median and max over the states."""
    import jax.numpy as jnp

    runner, targets = _jax_trot_runner("float32")
    import chip_smoke
    from qm_door_tpu.models import centroidal, kinematics
    from qm_door_tpu.models import dynamics as j_dyn
    from qm_door_tpu.ocp.problem import build_stage_data
    from qm_door_tpu.runtime.mrt import PolicyStore
    from qm_door_tpu.sim import sim as j_sim
    from qm_door_tpu.wbc.wbc import WbcState
    from qm_door_torch.models import dynamics as t_dyn
    from qm_door_torch.models.model import aliengo_z1 as t_aliengo_z1
    from qm_door_torch.ocp.problem import build_stage_data as t_build_stage_data
    from qm_door_torch.runtime import mrt as t_mrt
    from qm_door_torch.sim import sim as t_sim
    from qm_door_torch.wbc import wbc as t_wbc

    assert component in TROT_SWAPS, component
    torch.set_num_threads(2)
    f32 = torch.float32
    T = lambda a: torch.as_tensor(np.array(a), dtype=f32)  # noqa: E731
    J = lambda t: jnp.asarray(t.detach().cpu().numpy())  # noqa: E731
    model, cfg, sched, sim_cfg = runner.model, runner.cfg, runner.schedule, runner.sim_cfg
    port, port_targets = chip_smoke.trot_runner(CPU, f32)
    t_dyn_module, t_contacts = t_sim.dynamics, t_sim._contact_forces
    if component == "sim_dynamics":
        def contacts(_, cfg_, q, v, anchor=None):
            F, Jc, on, an = j_sim._contact_forces(model, sim_cfg, J(q[0]), J(v[0]), J(anchor[0]))
            return T(F)[None], T(Jc)[None], torch.as_tensor(np.array(on))[None], T(an)[None]
        t_sim._contact_forces = contacts
    if component == "sim_contacts":
        class JaxDynamics:
            @staticmethod
            def forward_dynamics(_, q, v, tau_gen):
                return T(j_dyn.forward_dynamics(model, J(q[0]), J(v[0]), J(tau_gen[0])))[None]
        t_sim.dynamics = JaxDynamics

    q0 = centroidal.pinocchio_q(jnp.asarray(cfg.initial_state()))
    q0 = q0.at[2].add(sim_cfg.terrain_height + height_offset
                      - float(jnp.mean(kinematics.contact_positions(model, q0)[:, 2])))
    sim = j_sim.sim_init(model, q0, cfg=sim_cfg)
    port_sim = t_sim.sim_init(port.model, T(q0)[None], cfg=port.sim_cfg)

    def rbd_of(sim):
        if component == "rbd":
            return J(t_sim.measured_rbd(port.model, t_sim.SimState(
                T(sim.q)[None], T(sim.v)[None], None, None, None, None))[0])
        return j_sim.measured_rbd(model, sim)

    def solve(t_now, x_obs, warm):
        if component != "solve":
            return runner.solver.solve(build_stage_data(model, cfg, sched, targets, t_now),
                                       x_obs, warm=warm)
        st = t_build_stage_data(port.model, port.cfg, port.schedule, port_targets, t_now)
        sol = port.solver.solve(st, T(x_obs), warm=None if warm is None else tuple(
            T(a) for a in warm))
        return PolicyStore(times=J(sol.times), X=J(sol.X), U=J(sol.U))

    model64 = t_aliengo_z1(dtype=torch.float64, device=CPU)
    fd_err = {"port": [], "jax": []}
    try:
        rbd_est = rbd_of(sim)
        x_obs = centroidal.centroidal_state_from_rbd(model, rbd_est)
        sol = solve(0.0, x_obs, None)
        sol = solve(0.0, x_obs, (sol.times, sol.X, sol.U))
        policy = PolicyStore(times=sol.times, X=sol.X, U=sol.U)
        wbc_state = WbcState.init(dtype=jnp.float32)
        port_wbc_state = t_wbc.WbcState.init(dtype=f32, device=CPU)
        log = {"t": [], "base_pose": [], "x_obs": [], "tau": [], "ee_pos": [], "safe": True}
        command, dt = None, sim_cfg.dt
        for step in range(int(round(duration / dt))):
            t = step * dt
            if step % runner.mpc_decimation == 0 and step > 0:
                x_obs = centroidal.centroidal_state_from_rbd(model, rbd_est)
                sol = solve(t, x_obs, (sol.times, sol.X, sol.U))
                policy = PolicyStore(times=sol.times, X=sol.X, U=sol.U)
            if step % runner.control_decimation == 0 or command is None:
                flags = jnp.asarray(sched.contact_flags_at(t), dtype=jnp.float32)
                if component == "tick":
                    res = port.controller.tick(
                        t_mrt.PolicyStore(times=T(policy.times), X=T(policy.X), U=T(policy.U)),
                        T(flags), T(rbd_est), port_wbc_state, t, dt * runner.control_decimation)
                    port_wbc_state = res.wbc_state
                    command = J(res.command.stack())
                    safe, x_tick, tau = bool(res.safe), J(res.x_obs), J(res.command.tau_ff)
                else:
                    res = runner.controller.tick(policy, flags, rbd_est, wbc_state, t,
                                                 dt * runner.control_decimation)
                    wbc_state = res.wbc_state
                    c = res.command
                    command = jnp.stack([c.pos_des, c.vel_des, c.kp, c.kd, c.tau_ff])
                    safe, x_tick, tau = bool(res.safe), res.x_obs, c.tau_ff
                if not safe:
                    log["safe"] = False
                    break
                q = J(port_sim.q[0]) if component.startswith("sim") else sim.q
                for key, row in (("t", t), ("base_pose", q[0:6]), ("x_obs", x_tick),
                                 ("tau", tau), ("ee_pos", rbd_est[48:51])):
                    log[key].append(np.asarray(row, dtype=np.float64).tolist())
            if component.startswith("sim"):
                if component == "sim" and t >= 1.3 - 1e-9 and step % 25 == 0:
                    q32, v32 = port_sim.q, port_sim.v
                    a64 = t_dyn.forward_dynamics(model64, q32.double(), v32.double(),
                                                 torch.zeros_like(q32, dtype=torch.float64))
                    a_port = t_dyn.forward_dynamics(port.model, q32, v32, torch.zeros_like(q32))
                    a_jax = j_dyn.forward_dynamics(model, J(q32[0]), J(v32[0]),
                                                   jnp.zeros(24, jnp.float32))
                    fd_err["port"].append(float((a_port.double() - a64).abs().max()))
                    fd_err["jax"].append(float(np.abs(np.asarray(a_jax, np.float64)
                                                      - a64[0].numpy()).max()))
                port_sim = t_sim.sim_step(port.model, port.sim_cfg, port_sim, T(command)[None])
                sim = sim.replace(q=J(port_sim.q[0]), v=J(port_sim.v[0]))
            else:
                sim = j_sim.sim_step(model, sim_cfg, sim, command)
            rbd_est = rbd_of(sim)
    finally:
        t_sim.dynamics, t_sim._contact_forces = t_dyn_module, t_contacts
    if fd_err["port"]:
        log["forward_dynamics_f32_err"] = {k: {"median": float(np.median(v)), "max": max(v),
                                                "states": len(v)} for k, v in fd_err.items()}
    return log


def golden_report(log, duration):
    """A run's deviation from the golden trace (chip_smoke.golden_deviation)
    and its ticks in [1.6, 2.0) s with a torque more than 2 Nm off it."""
    import sys
    import types

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import chip_smoke

    rows = [json.loads(line) for line in open(chip_smoke.TROT_GOLDEN)]
    out = dict(chip_smoke.golden_deviation(types.SimpleNamespace(**log), rows),
               safe=log["safe"], duration=duration)
    n = len(log["t"])
    tau_dev = np.abs(np.asarray(log["tau"]) - np.asarray([r["tau"] for r in rows[:n]])).max(axis=1)
    out["ticks_over_2nm_1.6_to_2.0"] = int((tau_dev[800:1000] > 2.0).sum())
    out["base_xyz_by_0.2_s"] = [float(np.abs(np.asarray(log["base_pose"])[:k, 0:3]
                                             - np.asarray([r["base_pose"] for r in rows[:k]])
                                             [:, 0:3]).max()) for k in range(100, n + 1, 100)]
    if "forward_dynamics_f32_err" in log:
        out["forward_dynamics_f32_err"] = log["forward_dynamics_f32_err"]
    return out


def jax_trot_deviation(duration=0.4):
    """How far the JAX package's own canonical trot strays from the golden
    (docs/artifacts/trot_2s_trace.jsonl, recorded in float64) over its
    first `duration` s, in float32 and in float64 (jax_trot_log, each in a
    process of its own). The card's float32 run of the same window is held
    to a golden band where JAX's own float32 run stays inside it, and to
    twice JAX's float32 deviation where it does not (chip_smoke.TROT_BARS)."""
    import subprocess
    import sys
    import types

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import chip_smoke

    rows = [json.loads(line) for line in open(chip_smoke.TROT_GOLDEN)]
    out = {}
    for name in ("float32", "float64"):
        run = subprocess.run([sys.executable, os.path.abspath(__file__), "trot-log", name,
                              str(duration)], capture_output=True, text=True, check=True)
        log = json.loads(run.stdout.strip().splitlines()[-1])
        out[name] = dict(chip_smoke.golden_deviation(types.SimpleNamespace(**log), rows),
                         safe=log["safe"])
    return out


def jax_side_deviation(duration=0.02):
    """How far the JAX package's own f32 run strays from its f64 run on the
    canonical trot's set-up with the separated WBC and with the Kalman
    filter (sensor_noise="default"), over `duration` s (jax_trot_log, each
    run in a process of its own): the max abs difference over every tick of
    the base pose, the leg joints' positions (the observation's [12:24]) and
    the arm joints' ([24:30]), as chip_smoke.py (j) compares the card's f32
    run with the CPU's f64 one (chip_smoke.side_deviation, SIDE_BARS)."""
    import subprocess
    import sys

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import chip_smoke

    out = {}
    for name in chip_smoke.SIDE_PATHS:
        logs = {}
        for dtype_name in ("float32", "float64"):
            run = subprocess.run([sys.executable, os.path.abspath(__file__), "trot-log",
                                  dtype_name, str(duration), name],
                                 capture_output=True, text=True, check=True)
            logs[dtype_name] = json.loads(run.stdout.strip().splitlines()[-1])
        a, b = logs["float32"], logs["float64"]
        out[name] = dict(
            chip_smoke.side_deviation(*(np.asarray(log["base_pose"]) for log in (a, b)),
                                      *(np.asarray(log["x_obs"])[:, 12:30] for log in (a, b))),
            rows=[len(a["t"]), len(b["t"])], safe=[a["safe"], b["safe"]])
    return out


def _jax_door_runner(dtype_name):
    """chip_smoke.py (k)'s set-up in the JAX package on the CPU, in
    ``dtype_name`` ("float32": x64 off, as the JAX package runs on its
    chip; "float64"): DoorOpeningRunner on the push door, default_config()
    with the gates at -1 (as scenarios.make_scenario sets them), N = 67,
    DoorScenario(**chip_smoke.DOOR_SCENARIO)."""
    import sys

    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", dtype_name == "float64")
    jax.config.update("jax_default_matmul_precision", "highest")
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import chip_smoke
    import jax.numpy as jnp
    from qm_door_tpu.config import default_config
    from qm_door_tpu.models import aliengo_z1
    from qm_door_tpu.sim.door_loop import DoorOpeningRunner, DoorScenario

    cfg = default_config()
    cfg.controller.leg_pd_start_time = -1.0
    cfg.wbc.arm_init_time = -1.0
    return DoorOpeningRunner(aliengo_z1(dtype=getattr(jnp, dtype_name)), cfg,
                             scenario=DoorScenario(**chip_smoke.DOOR_SCENARIO))


def jax_door_rows(dtype_name, duration):
    """The JAX package's run of chip_smoke.py (k)'s set-up (_jax_door_runner)
    for ``duration`` s, as chip_smoke.door_rows. Run in a process of its
    own."""
    runner = _jax_door_runner(dtype_name)
    import chip_smoke

    return chip_smoke.door_rows(runner.run(duration=duration))


def _door_rows_in_process(dtype_name, duration):
    import subprocess
    import sys

    run = subprocess.run([sys.executable, os.path.abspath(__file__), "door-log", dtype_name,
                          str(duration)], capture_output=True, text=True, check=True)
    return json.loads(run.stdout.strip().splitlines()[-1])


def write_door_trace(duration):
    """docs/artifacts/door_press_trace.jsonl: the JAX package's f64 run of
    chip_smoke.py (k)'s set-up for ``duration`` s, one JSON row a tick, then
    one a solve after t = 0, then the safe flag (chip_smoke.door_rows)."""
    import sys

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import chip_smoke

    rows = _door_rows_in_process("float64", duration)
    with open(chip_smoke.DOOR_TRACE, "w") as f:
        for row in rows:
            f.write(json.dumps(row) + "\n")
    return {"rows": len(rows), "path": os.path.relpath(chip_smoke.DOOR_TRACE)}


def jax_door_deviation(duration):
    """How far the JAX package's own f32 run of chip_smoke.py (k)'s set-up
    strays from its f64 run over ``duration`` s (each run in a process of
    its own), by field (chip_smoke.door_deviation), and how far the f64 run
    is from docs/artifacts/door_press_trace.jsonl. The card's f32 run is
    held to a band of chip_smoke.TROT_BANDS where JAX's f32 run stays inside
    it, and to twice JAX's f32 deviation (rounded up) elsewhere
    (chip_smoke.DOOR_BARS)."""
    import sys

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import chip_smoke

    rows = {name: _door_rows_in_process(name, duration) for name in ("float32", "float64")}
    trace = [json.loads(line) for line in open(chip_smoke.DOOR_TRACE)]
    return {"float32_vs_float64": chip_smoke.door_deviation(rows["float32"], rows["float64"]),
            "float64_vs_trace": chip_smoke.door_deviation(rows["float64"], trace),
            "safe": [rows[k][-1]["safe"] for k in ("float32", "float64")]}


if __name__ == "__main__":
    import sys

    if sys.argv[1:2] == ["loop-states"]:
        print(json.dumps(jax_loop_states(sys.argv[2]).tolist()))
    elif sys.argv[1:] == ["loop-bars"]:
        print(json.dumps(jax_loop_f32_deviation()))
    elif sys.argv[1:2] == ["trot-log"]:
        sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
        import chip_smoke

        kw = chip_smoke.SIDE_PATHS[sys.argv[4]] if len(sys.argv) > 4 else None
        print(json.dumps(jax_trot_log(sys.argv[2], float(sys.argv[3]), kw)))
    elif sys.argv[1:2] == ["side-bars"]:
        print(json.dumps(jax_side_deviation(*(float(a) for a in sys.argv[2:3]))))
    elif sys.argv[1:2] == ["trot-bars"]:
        print(json.dumps(jax_trot_deviation(*(float(a) for a in sys.argv[2:3]))))
    elif sys.argv[1:2] == ["port-trot"]:
        duration = float(sys.argv[3]) if len(sys.argv) > 3 else 2.0
        print(json.dumps(golden_report(port_trot_log(sys.argv[2], duration), duration)))
    elif sys.argv[1:2] == ["trot-swap"]:
        duration = float(sys.argv[3]) if len(sys.argv) > 3 else 2.0
        offset = float(sys.argv[4]) if len(sys.argv) > 4 else 0.0
        print(json.dumps(golden_report(jax_trot_swapped(sys.argv[2], duration, offset),
                                       duration)))
    elif sys.argv[1:2] == ["door-log"]:
        print(json.dumps(jax_door_rows(sys.argv[2], float(sys.argv[3]))))
    elif sys.argv[1:2] == ["door-trace"]:
        print(json.dumps(write_door_trace(float(sys.argv[2]) if len(sys.argv) > 2 else 0.04)))
    elif sys.argv[1:2] == ["door-bars"]:
        print(json.dumps(jax_door_deviation(float(sys.argv[2]) if len(sys.argv) > 2 else 0.04)))
    else:
        sys.exit("usage: python tests/torch_parity.py loop-bars | trot-bars [duration_s] | "
                 "side-bars [duration_s] | port-trot float32|float64 [duration_s] | "
                 "trot-swap " + "|".join(TROT_SWAPS) + " [duration_s [height_offset_m]] | "
                 "door-trace [duration_s] | door-bars [duration_s]")
