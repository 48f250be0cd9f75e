"""Batched scenario-parallel MPC (port of qm_door_tpu/parallel/batched.py):
B independent MPC problems advanced one SQP iteration per ``step`` (the
reference's 100 Hz advanceMpc, batched), on the device the solver's model
lives on, and optionally split over a scenario mesh (parallel/mesh.py).
"""
from __future__ import annotations

from torch.distributed.tensor import DTensor, Replicate, Shard

from .. import set_full_f32_matmuls
from ..ocp.problem import StageData
from ..solver.batched_sqp import BACKENDS, batched_sqp_iteration
from ..solver.sqp import SqpSolver
from .mesh import check_divides, local_rows, tree_map


class BatchedMpc:
    """B scenarios advanced in lock-step. Stage data is shared (no leading
    axis) or per scenario (a leading B axis, ``shared_stage=False``).
    ``backend`` picks the LQ stage of every step (``solver/batched_sqp.py``:
    "bm_k1", "bm_fused" or "lq_fused").

    With a ``mesh`` (parallel/mesh.py:scenario_mesh), every backend's kernels
    run on the process's local shard, as the JAX package's shard_map branch
    runs its Pallas kernels: the batch (and per-scenario stage data) come
    as ``Shard(0)`` DTensors, or as whole tensors that each process splits
    itself; shared stage data comes whole or ``Replicate()``; the step
    returns ``Shard(0)`` DTensors and makes no collective. B must divide by
    the mesh's size."""

    def __init__(self, solver: SqpSolver, mesh=None, shared_stage: bool = True,
                 backend: str = "bm_k1"):
        if backend not in BACKENDS:
            raise ValueError(f"backend={backend!r}: expected one of {BACKENDS}")
        set_full_f32_matmuls()
        self.solver = solver
        self.mesh = mesh
        self.shared_stage = shared_stage
        self.backend = backend

    def _local(self, tree, sharded: bool):
        """This process's part of ``tree``: its rows of a sharded batch, all
        of a replicated one."""
        want = Shard(0) if sharded else Replicate()

        def part(x):
            if isinstance(x, DTensor):
                if x.device_mesh != self.mesh or tuple(x.placements) != (want,):
                    raise ValueError(f"BatchedMpc: expected {want} on the scenario mesh, got "
                                     f"{tuple(x.placements)}")
                if sharded:
                    check_divides(x.shape[0], self.mesh)
                return x.to_local()
            return local_rows(x, self.mesh) if sharded else x

        return tree_map(part, tree)

    def _global(self, tree):
        return tree_map(lambda x: DTensor.from_local(x, self.mesh, [Shard(0)], run_check=False),
                        tree)

    def cold_start(self, stage: StageData, x_init_batch):
        """Constant-state, weight-compensating-input initializer per scenario."""
        if self.mesh is not None:
            return self._global(self._cold_start(self._local(stage, not self.shared_stage),
                                                 self._local(x_init_batch, True)))
        return self._cold_start(stage, x_init_batch)

    def _cold_start(self, stage, x_init_batch):
        N = self.solver.n_intervals
        B = x_init_batch.shape[0]
        X = x_init_batch[:, None, :].expand(B, N + 1, -1).clone()
        U = stage.u_nom[..., :N, :].expand(B, N, -1).clone()
        return X, U

    def step(self, stage: StageData, x_init_batch, X, U):
        """One batched SQP/MPC iteration -> (X, U, (cost, violation, step_size))."""
        if self.mesh is not None:
            stage = self._local(stage, not self.shared_stage)
            x_init_batch, X, U = (self._local(a, True) for a in (x_init_batch, X, U))
            return self._global(self._step(stage, x_init_batch, X, U))
        return self._step(stage, x_init_batch, X, U)

    def _step(self, stage, x_init_batch, X, U):
        s = self.solver
        return batched_sqp_iteration(s.model, s.ocp, stage, s.settings.dt, s.settings,
                                     x_init_batch, X, U, stage_batched=not self.shared_stage,
                                     backend=self.backend)
