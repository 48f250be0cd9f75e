#!/usr/bin/env python3
"""The state mismatch that ``mpc_stream`` draws: how far the measured state
lies from the MPC's own prediction one period later, in the port's batched
closed loop (``sim/batched_rollout.py``) with the farm's domain
randomization.

    python3 perfbench/tools/state_mismatch.py --config perfbench/configs/aliengo-z1-trot.json \
        [--batch 4] [--cycles 140] [--skip 70] [--seeds 0 1] [--leave-out-above 0.03] \
        [--out PREFIX] [--gaps PREFIX-s0.npy ...]

The loop runs the configuration's OCP and solver settings in float64:
the physics at 1 kHz, the WBC at 500 Hz, one SQP iteration a 10 ms period,
over scenarios drawn as ``tools/rollout_bench.py`` draws them (the
nominal pose perturbed by 0.01 a coordinate, a payload of 0-60 N on -z
every cycle, a lateral push of 0-60 N at a random heading in cycles 5-7).
At the start of every cycle the measured centroidal state is set against
the previous solution shifted onto the new grid (its first node, as
``SqpSolver.warm_start`` gives it). Each seed runs a loop of ``--batch``
scenarios. Prints one JSON object: the root mean square of that gap a
state row over the scenarios and the cycles from ``--skip`` on (the
traffic file's ``state_noise``), its mean and the largest gap a row, the
root mean square a scenario and a cycle. A scenario whose root mean square
over those cycles is above ``--leave-out-above`` is falling (the loop's
quarantine would soon freeze it) and is left out and named. ``--gaps``
reads the gaps that ``--out`` saved instead of running the loop.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", required=True)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--cycles", type=int, default=140)
    ap.add_argument("--skip", type=int, default=70)
    ap.add_argument("--seeds", type=int, nargs="+", default=[0])
    ap.add_argument("--leave-out-above", type=float, default=float("inf"))
    ap.add_argument("--threads", type=int, default=4)
    ap.add_argument("--out", default="",
                    help="save each seed's gaps (cycles - 1, B, 30) as PREFIX-s<seed>.npy")
    ap.add_argument("--gaps", nargs="+", default=[], help="saved gaps to read instead of running")
    args = ap.parse_args(argv)
    if args.gaps:
        gaps = np.concatenate([np.load(f) for f in args.gaps], axis=1)
    else:
        gaps = np.concatenate([measure(args, seed) for seed in args.seeds], axis=1)
    print(json.dumps(summary(gaps, args.skip, args.leave_out_above)), flush=True)


def summary(gaps, skip, leave_out_above):
    """The readings of gaps (cycles - 1, B, 30), gaps[j] cycle j + 1's."""
    kept = gaps[max(skip - 1, 0):]
    by_scenario = np.sqrt((kept ** 2).mean((0, 2)))
    out_rows = np.nonzero(by_scenario > leave_out_above)[0]
    rows = kept[:, by_scenario <= leave_out_above].reshape(-1, 30)
    return {"cycles": gaps.shape[0] + 1, "skip": skip, "scenarios": gaps.shape[1],
            "left_out": out_rows.tolist(), "rms_by_scenario": by_scenario.tolist(),
            "rms": np.sqrt((rows ** 2).mean(0)).tolist(), "mean": rows.mean(0).tolist(),
            "max": np.abs(rows).max(0).tolist(),
            "rms_by_cycle": np.sqrt((gaps ** 2).mean((1, 2))).tolist()}


def measure(args, seed):
    """The gaps (cycles - 1, batch, 30) of one seed's loop."""
    import torch

    from qm_door_torch.models import centroidal, kinematics, spatial
    from qm_door_torch.models.model import load_model
    from qm_door_torch.ocp.gait import GaitSchedule, ModeSequenceTemplate, flags_to_mode
    from qm_door_torch.ocp.problem import make_ocp_config
    from qm_door_torch.ocp.reference import TargetTrajectories
    from qm_door_torch.sim.batched_rollout import BatchedClosedLoop, cycle_stage, stack_stages
    from qm_door_torch.sim.sim import SimConfig, measured_rbd
    from qm_door_torch.solver.sqp import SqpSolver

    from perfbench.system import program_config

    torch.set_num_threads(args.threads)
    with open(os.path.join(ROOT, args.config)) as f:
        cfg = json.load(f)
    dtype, dev = torch.float64, torch.device("cpu")
    qc = program_config(cfg)
    model = load_model(os.path.join(ROOT, cfg["model_file"]), dtype=dtype, device=dev)
    solver = SqpSolver(model, make_ocp_config(model, qc), qc)
    x0 = torch.tensor(qc.initial_state(), dtype=dtype, device=dev)
    R_ee, p_ee = kinematics.ee_pose(model, x0[6:30])
    tstate = torch.cat([x0, p_ee, spatial.rot_to_quat(R_ee)])
    targets = TargetTrajectories.create(
        torch.tensor([0.0, 1e5], dtype=dtype, device=dev), torch.stack([tstate, tstate]),
        torch.zeros((2, 30), dtype=dtype, device=dev))
    gait = cfg["gait"]
    template = ModeSequenceTemplate([int(flags_to_mode(f)) for f in gait["modes"]],
                                    list(gait["switching_times"]))
    sim_cfg = SimConfig()
    mpc_decim, period = 10, 1.0 / cfg["mpc_frequency_hz"]
    sched = GaitSchedule()
    sched.insert_template(template, 0.0, args.cycles * period + 2.0)
    loop = BatchedClosedLoop(model, qc, solver, sim_cfg, 2, mpc_decim,
                             backend=cfg["sqp"]["backend"])
    stages = stack_stages(model, qc, sched, targets, 0.0, args.cycles, period, dtype)

    # tools/rollout_bench.py's draws
    B = args.batch
    rng = np.random.default_rng(seed)
    q0 = centroidal.pinocchio_q(x0).clone()
    q0[2] -= kinematics.contact_positions(model, q0)[:, 2].mean()
    q0b = q0.cpu().numpy()[None] + rng.normal(size=(B, 24)) * 0.01
    wr = np.zeros((args.cycles, B, 6))
    wr[:, :, 2] -= rng.uniform(0.0, 60.0, size=B)[None, :]
    heading = rng.uniform(0.0, 2 * np.pi, size=B)
    push = rng.uniform(0.0, 60.0, size=B)
    lo, hi = min(5, args.cycles - 1), min(8, args.cycles)
    wr[lo:hi, :, 0] += (push * np.cos(heading))[None, :]
    wr[lo:hi, :, 1] += (push * np.sin(heading))[None, :]
    wrenches = torch.tensor(wr, dtype=dtype, device=dev)
    carry = loop.init_carry(cycle_stage(stages, 0), torch.tensor(q0b, dtype=dtype, device=dev))

    gaps, prev_times = [], None
    for i in range(args.cycles):
        stage = cycle_stage(stages, i)
        if prev_times is not None:
            x_obs = centroidal.centroidal_state_from_rbd(model, measured_rbd(model, carry.sim))
            Xw, _ = solver.warm_start(prev_times, carry.X, carry.U, stage.times)
            gaps.append((x_obs - Xw[:, 0]).cpu().numpy())
        carry, _ = loop.run(cycle_stage(stages, slice(i, i + 1)), carry, wrenches[i:i + 1])
        prev_times = stage.times
        print(f"seed {seed} cycle {i}: alive {int(carry.alive.sum())}/{B}", file=sys.stderr,
              flush=True)
    gaps = np.stack(gaps)  # (cycles - 1, B, 30): gaps[j] is cycle j + 1's
    if args.out:
        np.save(f"{args.out}-s{seed}.npy", gaps)
    return gaps


if __name__ == "__main__":
    main()
