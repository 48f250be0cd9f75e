"""Batched scenario-parallel MPC (port of qm_door_tpu/parallel/batched.py,
one device, no mesh): B independent MPC problems advanced one SQP
iteration per ``step`` (the reference's 100 Hz advanceMpc, batched), on the
device the solver's model lives on.
"""
from __future__ import annotations

from .. import set_full_f32_matmuls
from ..ocp.problem import StageData
from ..solver.batched_sqp import BACKENDS, batched_sqp_iteration
from ..solver.sqp import SqpSolver


class BatchedMpc:
    """B scenarios advanced in lock-step. Stage data is shared (no leading
    axis) or per scenario (a leading B axis, ``shared_stage=False``).
    ``backend`` picks the LQ stage of every step (``solver/batched_sqp.py``:
    "bm_k1", "bm_fused" or "lq_fused")."""

    def __init__(self, solver: SqpSolver, shared_stage: bool = True, backend: str = "bm_k1"):
        if backend not in BACKENDS:
            raise ValueError(f"backend={backend!r}: expected one of {BACKENDS}")
        set_full_f32_matmuls()
        self.solver = solver
        self.shared_stage = shared_stage
        self.backend = backend

    def cold_start(self, stage: StageData, x_init_batch):
        """Constant-state, weight-compensating-input initializer per scenario."""
        N = self.solver.n_intervals
        B = x_init_batch.shape[0]
        X = x_init_batch[:, None, :].expand(B, N + 1, -1).clone()
        U = stage.u_nom[..., :N, :].expand(B, N, -1).clone()
        return X, U

    def step(self, stage: StageData, x_init_batch, X, U):
        """One batched SQP/MPC iteration -> (X, U, (cost, violation, step_size))."""
        s = self.solver
        return batched_sqp_iteration(s.model, s.ocp, stage, s.settings.dt, s.settings,
                                     x_init_batch, X, U, stage_batched=not self.shared_stage,
                                     backend=self.backend)
