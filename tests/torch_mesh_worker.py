"""One process of tests/test_torch_mesh.py's scenario mesh (gloo, the CPU).

    python tests/torch_mesh_worker.py RANK WORLD PORT INPUTS OUT

Joins a process group of WORLD processes at localhost:PORT through
qm_door_torch.parallel.mesh.multihost_mesh, loads the problem the test wrote
to INPUTS (torch.save: the batch, shared and per-scenario stage data, the
config's horizon), and for shared and per-scenario stage data runs
BatchedMpc(mesh=...)'s cold start and one step on its shard of the batch.
Writes to OUT (torch.save): its local rows, the whole X and U gathered from
every rank, the fleet's mean cost and violation (one all-reduce each), and
whether a batch that does not split over the mesh raised.
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

torch.set_num_threads(1)


def main(rank, world, port, inputs, out):
    import torch.distributed as dist
    from torch.distributed.tensor import Shard

    from qm_door_torch.config import default_config
    from qm_door_torch.models.model import aliengo_z1
    from qm_door_torch.ocp.problem import make_ocp_config
    from qm_door_torch.parallel.batched import BatchedMpc
    from qm_door_torch.parallel.mesh import multihost_mesh, shard_batch
    from qm_door_torch.solver.sqp import SqpSolver

    data = torch.load(inputs, weights_only=False)
    mesh = multihost_mesh(f"localhost:{port}", num_processes=world, process_id=rank,
                          device="cpu")
    cfg = default_config()
    cfg.mpc.time_horizon = data["horizon"]
    model = aliengo_z1(dtype=torch.float64, device="cpu")
    solver = SqpSolver(model, make_ocp_config(model, cfg), cfg)
    result = {"rank": rank, "mesh_size": mesh.size()}
    for label, shared, stage in (("shared", True, data["stage"]),
                                 ("per_scenario", False, data["stage_b"])):
        mpc = BatchedMpc(solver, mesh=mesh, shared_stage=shared)
        if not shared:
            stage = shard_batch(stage, mesh)
        xb = shard_batch(data["xb"], mesh)
        X, U = mpc.cold_start(stage, xb)
        X, U, (cost, viol, alpha) = mpc.step(stage, xb, X, U)
        result[label] = {
            "local_X": X.to_local(), "local_U": U.to_local(),
            "sharded": all(tuple(t.placements) == (Shard(0),) for t in (X, U, cost, viol, alpha)),
            "X": X.full_tensor(), "U": U.full_tensor(),
            "cost_mean": cost.mean().full_tensor().item(),
            "viol_mean": viol.mean().full_tensor().item(),
            "alpha_min": alpha.to_local().min().item()}
    try:
        shard_batch(data["xb"][:world + 1], mesh)
        result["odd_batch_raised"] = False
    except ValueError:
        result["odd_batch_raised"] = True
    torch.save(result, out)
    dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5])
