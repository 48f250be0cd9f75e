"""The port's scenario mesh (qm_door_torch/parallel/mesh.py) and
BatchedMpc(mesh=...) against the unsharded port step and the JAX package's
8-device sharded step (tests/test_parallel.py's problem: B = 8 at N = 8),
with shared and per-scenario stage data. Two gloo processes
(tests/torch_mesh_worker.py) each step their half of the batch; the mesh of
one runs in this process."""
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qm_door_torch import convert
from qm_door_torch.config import default_config as t_default_config
from qm_door_torch.models.model import aliengo_z1 as t_aliengo_z1
from qm_door_torch.ocp.problem import make_ocp_config as t_make_ocp_config
from qm_door_torch.parallel import mesh as t_mesh
from qm_door_torch.parallel.batched import BatchedMpc as TBatchedMpc
from qm_door_torch.solver.sqp import SqpSolver as TSqpSolver
from torch_parity import F64, as_numpy_fields, shared_reference, to_np
from torch_parity import release_jax_executables  # noqa: F401 (autouse, module scope)

WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_mesh_worker.py")
B = 8
NODES = 8            # tests/test_parallel.py's horizon: 8 * dt
T0S = (0.0, 0.21)    # per-scenario stage data: the trot from these starts in turn
SAME = dict(rtol=0.0, atol=1e-12)
JAX_TOL = dict(rtol=0.0, atol=1e-8)  # tests/test_parallel.py's
STAGES = ("shared", "per_scenario")


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _jax_problem():
    from qm_door_tpu.config import default_config
    from qm_door_tpu.models import aliengo_z1, kinematics, spatial
    from qm_door_tpu.ocp.gait import GAIT_LIBRARY, GaitSchedule
    from qm_door_tpu.ocp.problem import build_stage_data, make_ocp_config
    from qm_door_tpu.ocp.reference import TargetTrajectories
    from qm_door_tpu.solver.sqp import SqpSolver

    model = aliengo_z1()
    cfg = default_config()
    cfg.mpc.time_horizon = NODES * cfg.sqp.dt
    solver = SqpSolver(model, make_ocp_config(model, cfg), cfg)
    x0 = jnp.asarray(cfg.initial_state())
    R_ee, p_ee = kinematics.ee_pose(model, x0[6:30])
    tstate = jnp.concatenate([x0, p_ee, spatial.rot_to_quat(R_ee)])
    targets = TargetTrajectories.create(jnp.array([0.0, 1e5]), jnp.stack([tstate, tstate]),
                                        jnp.zeros((2, 30)))
    sched = GaitSchedule()
    sched.insert_template(GAIT_LIBRARY["trot"], 0.0, 5.0)
    stages = [build_stage_data(model, cfg, sched, targets, t0, horizon=cfg.mpc.time_horizon)
              for t0 in T0S]
    pick = np.arange(B) % len(T0S)
    stage_b = jax.tree.map(lambda *a: jnp.stack(a)[pick], *stages)
    xb = np.asarray(x0)[None] + np.random.default_rng(0).normal(size=(B, 30)) * 0.01
    return cfg, solver, {"shared": stages[0], "per_scenario": stage_b}, xb


@pytest.fixture(scope="module")
def P():
    """Both packages' problem: the JAX config, solver and stage data, and the
    port's stage data converted from it (f64, the CPU)."""
    cfg, solver, jstages, xb = _jax_problem()
    tstages = {k: convert.stage_data_from_numpy(as_numpy_fields(v), device="cpu")
               for k, v in jstages.items()}
    return dict(cfg=cfg, solver=solver, jstages=jstages, tstages=tstages, xb=xb,
                horizon=cfg.mpc.time_horizon)


@pytest.fixture(scope="module")
def t_solver(P):
    cfg = t_default_config()
    cfg.mpc.time_horizon = P["horizon"]
    model = t_aliengo_z1(dtype=F64, device="cpu")
    return TSqpSolver(model, t_make_ocp_config(model, cfg), cfg)


@pytest.fixture(scope="module")
def unsharded(P, t_solver):
    """The port's step without a mesh, by stage kind."""
    out = {}
    for kind in STAGES:
        mpc = TBatchedMpc(t_solver, shared_stage=kind == "shared")
        xb = torch.tensor(P["xb"], dtype=F64)
        X, U = mpc.cold_start(P["tstages"][kind], xb)
        out[kind] = mpc.step(P["tstages"][kind], xb, X, U)
    return out


@pytest.fixture(scope="module")
def jax_sharded(P, tmp_path_factory):
    """JAX's BatchedMpc step over its 8-device scenario mesh, shared stage
    data (tests/test_parallel.py's case). The per-scenario step is held to
    the unsharded port step, which tests/test_torch_options.py holds to
    JAX's per-scenario iteration; a second JAX compile would cost ~35 s."""
    from qm_door_tpu.parallel.batched import BatchedMpc
    from qm_door_tpu.parallel.mesh import scenario_mesh, shard_batch

    def compute():
        mesh = scenario_mesh(8)
        stage, xb = P["jstages"]["shared"], jnp.asarray(P["xb"])
        X, U = BatchedMpc(P["solver"]).cold_start(stage, xb)
        X, U, stats = BatchedMpc(P["solver"], mesh=mesh).step(
            stage, shard_batch(xb, mesh), shard_batch(X, mesh), shard_batch(U, mesh))
        assert len(X.sharding.device_set) == 8
        return X, U, stats

    return shared_reference(tmp_path_factory, "mesh step shared", compute, P["xb"])


@pytest.fixture(scope="module")
def gloo_ranks(P, tmp_path_factory):
    """The two gloo processes' results, by rank (as numpy: run once a test
    run and shared by the workers, as the JAX references are)."""
    def compute():
        tmp = tmp_path_factory.mktemp("mesh")
        inputs = str(tmp / "inputs.pt")
        torch.save({"xb": torch.tensor(P["xb"], dtype=F64), "stage": P["tstages"]["shared"],
                    "stage_b": P["tstages"]["per_scenario"], "horizon": P["horizon"]}, inputs)
        port = _free_port()
        env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
        procs = [subprocess.Popen([sys.executable, WORKER, str(rank), "2", str(port), inputs,
                                   str(tmp / f"rank{rank}.pt")], env=env,
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                 for rank in (0, 1)]
        for p in procs:
            out, _ = p.communicate(timeout=300)
            assert p.returncode == 0, out[-3000:]
        return [torch.load(tmp / f"rank{rank}.pt", weights_only=False) for rank in (0, 1)]

    return shared_reference(tmp_path_factory, "mesh gloo ranks", compute, P["xb"])


@pytest.mark.parametrize("kind", STAGES)
def test_two_gloo_processes_equal_the_unsharded_step(kind, gloo_ranks, unsharded):
    Xr, Ur, _ = unsharded[kind]
    half = B // 2
    for rank, res in enumerate(gloo_ranks):
        r = res[kind]
        assert res["mesh_size"] == 2
        assert r["sharded"]
        assert r["local_X"].shape[0] == half
        rows = slice(rank * half, (rank + 1) * half)
        np.testing.assert_allclose(to_np(r["local_X"]), to_np(Xr[rows]), **SAME)
        np.testing.assert_allclose(to_np(r["local_U"]), to_np(Ur[rows]), **SAME)
        np.testing.assert_allclose(to_np(r["X"]), to_np(Xr), **SAME)
        np.testing.assert_allclose(to_np(r["U"]), to_np(Ur), **SAME)
        assert r["alpha_min"] > 0.0


def test_sharded_step_matches_jax_mesh(gloo_ranks, jax_sharded):
    Xj, Uj, (cost, viol, _) = jax_sharded
    r = gloo_ranks[0]["shared"]
    np.testing.assert_allclose(to_np(r["X"]), Xj, **JAX_TOL)
    np.testing.assert_allclose(to_np(r["U"]), Uj, **JAX_TOL)
    np.testing.assert_allclose(r["viol_mean"], float(np.mean(viol)), rtol=1e-8, atol=1e-12)
    np.testing.assert_allclose(r["cost_mean"], float(np.mean(cost)), rtol=1e-8)


@pytest.mark.parametrize("kind", STAGES)
def test_fleet_mean_is_bitwise_equal_across_ranks(kind, gloo_ranks, unsharded):
    a, b = (res[kind] for res in gloo_ranks)
    assert a["viol_mean"] == b["viol_mean"] and a["cost_mean"] == b["cost_mean"]
    _, _, (cost, viol, _) = unsharded[kind]
    np.testing.assert_allclose(a["viol_mean"], float(viol.mean()), rtol=1e-12)
    np.testing.assert_allclose(a["cost_mean"], float(cost.mean()), rtol=1e-12)


def test_a_batch_that_does_not_split_raises(gloo_ranks):
    assert all(res["odd_batch_raised"] for res in gloo_ranks)


@pytest.fixture
def mesh_of_one():
    """A gloo process group of this process alone, and its scenario mesh."""
    import torch.distributed as dist

    assert not dist.is_initialized()
    yield t_mesh.scenario_mesh(device="cpu")
    dist.destroy_process_group()


@pytest.mark.parametrize("kind", STAGES)
def test_a_mesh_of_one_equals_no_mesh(kind, mesh_of_one, P, t_solver, unsharded):
    shared = kind == "shared"
    mpc = TBatchedMpc(t_solver, mesh=mesh_of_one, shared_stage=shared)
    stage = P["tstages"][kind]
    stage = t_mesh.replicate(stage, mesh_of_one) if shared else t_mesh.shard_batch(
        stage, mesh_of_one)
    xb = t_mesh.shard_batch(torch.tensor(P["xb"], dtype=F64), mesh_of_one)
    X, U = mpc.cold_start(stage, xb)
    out = mpc.step(stage, xb, X, U)
    ref = unsharded[kind]
    for a, b in zip(out[:2] + tuple(out[2]), ref[:2] + tuple(ref[2])):
        assert tuple(a.placements) == (t_mesh.Shard(0),)
        np.testing.assert_array_equal(to_np(a.to_local()), to_np(b))
    with pytest.raises(ValueError, match="expected S"):
        mpc.step(stage, t_mesh.replicate(torch.tensor(P["xb"], dtype=F64), mesh_of_one),
                 X, U)
