"""Batched closed-loop rollouts: MPC as the policy of B scenarios (port of
qm_door_tpu/sim/batched_rollout.py).

Domain-randomized scenarios (initial-state perturbations, pushes,
payloads), each running the whole stack in lock-step on one device: the
physics at 1 kHz, the WBC at 500 Hz, the SQP MPC at 100 Hz. One MPC cycle
is one batched SQP iteration (``solver/batched_sqp.py``, one ``backend``
for every scenario), then ``mpc_decim`` physics steps with a batched WBC
tick every ``control_decim`` of them. The cycles and the physics steps are
plain Python loops: which step ticks the WBC is a Python int, and nothing
in a cycle reads a tensor back to the host but the SQP linesearch's early
exit.

Failure handling: scenarios whose safety check trips or whose solve goes
non-finite are frozen in place (per-scenario quarantine, ``torch.where``)
instead of poisoning the batch; the ``alive`` mask reports the survivors.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, fields

import torch

from ..models import centroidal
from ..models.model import RobotModel
from ..ocp.problem import StageData, build_stage_data
from ..runtime.mrt import PolicyStore, evaluate_policy
from ..runtime.safety import safety_check
from ..solver.batched_sqp import BACKENDS, batched_sqp_iteration
from ..solver.sqp import SqpSolver
from ..wbc.wbc import WbcState, as_gains, hierarchical_wbc_batched
from .sim import SimConfig, SimState, measured_rbd, sim_init, sim_step


def _map(obj, fn, *others):
    """A dataclass of tensors (SimStates nested) with ``fn`` applied field by
    field, with the same fields of ``others``."""
    out = {}
    for f in fields(obj):
        a, bs = getattr(obj, f.name), [getattr(o, f.name) for o in others]
        out[f.name] = _map(a, fn, *bs) if isinstance(a, SimState) else fn(a, *bs)
    return type(obj)(**out)


@dataclass(frozen=True)
class RolloutCarry:
    sim: SimState               # batched (leading B on every field)
    X: torch.Tensor             # (B, N+1, 30) MPC warm start
    U: torch.Tensor             # (B, N, 30)
    input_last: torch.Tensor    # (B, 30) WBC finite-difference memory
    command: torch.Tensor       # (B, 5, 18) latest hybrid command
    alive: torch.Tensor         # (B,) bool

    def map(self, fn, *others: "RolloutCarry") -> "RolloutCarry":
        return _map(self, fn, *others)


@dataclass(frozen=True)
class RolloutLog:
    base_pose: torch.Tensor     # (T, B, 6)
    mpc_cost: torch.Tensor      # (T, B)
    mpc_viol: torch.Tensor      # (T, B)
    alive: torch.Tensor         # (T, B)


def _flags_at(stage: StageData, t):
    """The stage's contact flags (4,) at time ``t`` (a 0-d tensor)."""
    idx = torch.clamp(torch.searchsorted(stage.times, t.reshape(1), right=True) - 1,
                      0, stage.times.shape[0] - 1)
    return torch.index_select(stage.contact_flags, 0, idx)[0]


def cycle_stage(stages: StageData, i) -> StageData:
    """Cycle ``i``'s StageData (an int) or a run of cycles (a slice) out of
    stages stacked along a leading cycle axis."""
    return StageData(**{f.name: None if getattr(stages, f.name) is None
                        else getattr(stages, f.name)[i] for f in fields(stages)})


class BatchedClosedLoop:
    """B scenarios for T MPC cycles on the solver's device."""

    def __init__(self, model: RobotModel, cfg, solver: SqpSolver,
                 sim_cfg: SimConfig = SimConfig(),
                 control_decim: int = 2, mpc_decim: int = 10,
                 solve_chunk: int = 0, cycle_chunk: int = 0, backend: str = "bm_k1"):
        if backend not in BACKENDS:
            raise ValueError(f"backend={backend!r}: expected one of {BACKENDS}")
        self.model = model
        self.cfg = cfg
        self.solver = solver
        self.sim_cfg = sim_cfg
        self.control_decim = control_decim
        self.mpc_decim = mpc_decim
        # solve_chunk > 0 runs the SQP iteration on at most that many
        # scenarios at once: the linearize/LQ workspace is the rollout's
        # memory peak (~2.5 GB per 1024 scenarios at 67 nodes)
        self.solve_chunk = solve_chunk
        # cycle_chunk > 0 runs the whole cycle (solve, WBC ticks, physics) on
        # at most that many scenarios at once
        self.cycle_chunk = cycle_chunk
        self.backend = backend
        # the WBC gains on the model's device once, not at every tick
        self.gains = as_gains(cfg.wbc, model.dtype, model.device)

    def init_carry(self, stage0: StageData, q0_batch, v0_batch=None) -> RolloutCarry:
        B = q0_batch.shape[0]
        model = self.model
        sim = sim_init(model, q0_batch, v0_batch, self.sim_cfg)
        x_obs = centroidal.centroidal_state_from_rbd(model, measured_rbd(model, sim))
        N = self.solver.n_intervals
        X = x_obs[:, None, :].expand(B, N + 1, -1).clone()
        U = stage0.u_nom[:N].expand(B, N, -1).clone()
        # initial command: hold the measured joints, modest PD
        q_j = q0_batch[:, 6:24]
        command = torch.stack(
            [q_j, torch.zeros_like(q_j), torch.full_like(q_j, 60.0),
             torch.full_like(q_j, 3.0), torch.zeros_like(q_j)], dim=1)
        return RolloutCarry(
            sim=sim, X=X, U=U,
            input_last=torch.zeros(B, 30, dtype=q0_batch.dtype, device=q0_batch.device),
            command=command,
            alive=torch.ones(B, dtype=torch.bool, device=q0_batch.device),
        )

    def _solve(self, stage: StageData, x_obs, Xw, Uw):
        """One SQP iteration of every scenario, ``solve_chunk`` at a time."""
        s = self.solver

        def solve(x, X, U):
            return batched_sqp_iteration(self.model, s.ocp, stage, s.settings.dt, s.settings,
                                         x, X, U, backend=self.backend)

        B = x_obs.shape[0]
        c = self.solve_chunk
        if not c or c >= B:
            return solve(x_obs, Xw, Uw)
        outs = [solve(x_obs[i:i + c], Xw[i:i + c], Uw[i:i + c]) for i in range(0, B, c)]
        return (torch.cat([o[0] for o in outs]), torch.cat([o[1] for o in outs]),
                tuple(torch.cat([o[2][k] for o in outs]) for k in range(3)))

    def _control_tick(self, stage, X, U, sim, input_last, t_local, ctrl_period):
        """One batched WBC tick -> (command (B,5,18), input_last)."""
        model = self.model
        flags = _flags_at(stage, t_local)
        rbd = measured_rbd(model, sim)
        x_opt, u_opt = evaluate_policy(PolicyStore(times=stage.times, X=X, U=U), t_local)
        B = X.shape[0]
        cmd, new_state = hierarchical_wbc_batched(
            model, self.gains, x_opt, u_opt, rbd, flags.expand(B, -1),
            WbcState(input_last=input_last), ctrl_period, use_arm_init=False)
        tau = cmd[:, 36:54]
        pos_des = x_opt[:, 12:30]
        vel_des = torch.cat([u_opt[:, 12:24], torch.zeros_like(tau[:, :6])], dim=1)
        kp = torch.zeros_like(tau)
        ctrl = self.cfg.controller
        kd = torch.cat([torch.full_like(tau[:, :12], ctrl.leg_kd),
                        torch.full_like(tau[:, 12:], ctrl.arm_kd)], dim=1)
        return torch.stack([pos_des, vel_des, kp, kd, tau], dim=1), new_state.input_last

    def _physics_step(self, sim, command, wrench):
        return sim_step(self.model, self.sim_cfg, sim, command, external_wrench=wrench)

    def _mpc_cycle(self, carry: RolloutCarry, stage: StageData, wrench):
        model, sim_cfg = self.model, self.sim_cfg
        ctrl_period = sim_cfg.dt * self.control_decim

        x_obs = centroidal.centroidal_state_from_rbd(model, measured_rbd(model, carry.sim))

        # warm-start shift onto the new grid, then one SQP iteration (100 Hz)
        prev_times = stage.times - sim_cfg.dt * self.mpc_decim
        Xw, Uw = self.solver.warm_start(prev_times, carry.X, carry.U, stage.times)
        Xw[:, 0] = x_obs
        X, U, (cost, viol, _) = self._solve(stage, x_obs, Xw, Uw)

        sim, input_last, command = carry.sim, carry.input_last, carry.command
        for step_idx in range(self.mpc_decim):
            if step_idx % self.control_decim == 0:
                t_local = stage.times[0] + step_idx * sim_cfg.dt
                command, input_last = self._control_tick(
                    stage, X, U, sim, input_last, t_local, ctrl_period)
            sim = self._physics_step(sim, command, wrench)

        # per-scenario quarantine
        alive = (carry.alive & safety_check(x_obs) & torch.isfinite(cost)
                 & torch.all(torch.isfinite(sim.q), dim=-1))

        def freeze(new, old):
            return torch.where(alive.reshape((-1,) + (1,) * (new.ndim - 1)), new, old)

        new = RolloutCarry(sim=sim, X=X, U=U, input_last=input_last, command=command,
                           alive=alive)
        new_carry = dataclasses.replace(new.map(freeze, carry), alive=alive)
        return new_carry, (new_carry.sim.q[:, 0:6], cost, viol, alive)

    def _mpc_cycle_chunked(self, carry: RolloutCarry, stage: StageData, wrench):
        """``_mpc_cycle`` with every stage capped at ``cycle_chunk`` scenarios."""
        B, c = carry.alive.shape[0], self.cycle_chunk
        parts = [self._mpc_cycle(carry.map(lambda a: a[i:i + c]), stage, wrench[i:i + c])
                 for i in range(0, B, c)]
        new = parts[0][0].map(lambda *xs: torch.cat(xs), *(p[0] for p in parts[1:]))
        return new, tuple(torch.cat([p[1][k] for p in parts]) for k in range(4))

    def run(self, stages: StageData, carry: RolloutCarry, wrenches=None):
        """``stages``: StageData stacked along a leading (T, ...) cycle axis
        (``stack_stages``). ``wrenches`` (T, B, 6): the world-frame
        force/torque on each scenario's base, per MPC cycle: the
        domain-randomization channel for pushes (transient lateral force)
        and payloads (persistent -z force). None = undisturbed. Returns the
        final carry and the RolloutLog."""
        T = stages.times.shape[0]
        B = carry.alive.shape[0]
        if wrenches is None:
            wrenches = torch.zeros(T, B, 6, dtype=carry.sim.q.dtype, device=carry.sim.q.device)
        cycle = self._mpc_cycle
        if self.cycle_chunk and self.cycle_chunk < B:
            cycle = self._mpc_cycle_chunked
        logs = []
        for i in range(T):
            carry, out = cycle(carry, cycle_stage(stages, i), wrenches[i])
            logs.append(out)
        base, cost, viol, alive = (torch.stack([o[k] for o in logs]) for k in range(4))
        return carry, RolloutLog(base_pose=base, mpc_cost=cost, mpc_viol=viol, alive=alive)


def stack_stages(model, cfg, schedule, targets, t0, n_cycles, mpc_period, dtype):
    """Each cycle's StageData, stacked along a leading time axis."""
    stages = [build_stage_data(model, cfg, schedule, targets, t0 + i * mpc_period, dtype=dtype)
              for i in range(n_cycles)]
    return StageData(**{f.name: None if getattr(stages[0], f.name) is None
                        else torch.stack([getattr(s, f.name) for s in stages])
                        for f in fields(StageData)})
