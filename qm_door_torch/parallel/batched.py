"""Batched scenario-parallel MPC (port of qm_door_tpu/parallel/batched.py,
one device, no mesh): B independent MPC problems advanced one SQP
iteration per ``step`` (the reference's 100 Hz advanceMpc, batched), on the
device the solver's model lives on.
"""
from __future__ import annotations

from .. import set_full_f32_matmuls
from ..ocp.problem import StageData
from ..solver.batched_sqp import batched_sqp_iteration
from ..solver.sqp import SqpSolver


class BatchedMpc:
    """B scenarios advanced in lock-step, sharing one StageData."""

    def __init__(self, solver: SqpSolver):
        set_full_f32_matmuls()
        self.solver = solver

    def cold_start(self, stage: StageData, x_init_batch):
        """Constant-state, weight-compensating-input initializer per scenario."""
        N = self.solver.n_intervals
        B = x_init_batch.shape[0]
        X = x_init_batch[:, None, :].expand(B, N + 1, -1).clone()
        U = stage.u_nom[:N].expand(B, N, -1).clone()
        return X, U

    def step(self, stage: StageData, x_init_batch, X, U):
        """One batched SQP/MPC iteration -> (X, U, (cost, violation, step_size))."""
        s = self.solver
        return batched_sqp_iteration(s.model, s.ocp, stage, s.settings.dt, s.settings,
                                     x_init_batch, X, U)
