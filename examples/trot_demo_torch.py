#!/usr/bin/env python
"""Closed-loop trot demo of the torch port (examples/trot_demo.py on
qm_door_torch; the `qm_gazebo empty_world + load_controller` role).

Runs the full stack — sim(1 kHz) + WBC(500 Hz) + NMPC(100 Hz) — for a few
seconds of trotting on flat ground and renders the trajectory. The set-up
is the golden trot's (tools/record_trace.py:canonical_trot_run).

    python examples/trot_demo_torch.py [duration_s] [--device cpu] [--out DIR]
        [--no-figures]

On the CUDA device in float32 by default; ``--device cpu`` runs on the CPU
in float64. Writes trot_demo.png and trot_report.png into DIR (default: the
working directory), unless --no-figures.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import numpy as np  # noqa: E402
import torch  # noqa: E402


def parse(argv, default_duration, doc):
    """The examples' arguments: the window, --device and --out."""
    parser = argparse.ArgumentParser(description=doc.splitlines()[0])
    parser.add_argument("duration", nargs="?", type=float, default=default_duration,
                        help=f"seconds of simulated time (default {default_duration})")
    parser.add_argument("--device", default=None,
                        help="cpu to run on the CPU in float64 (default: the CUDA device, "
                             "float32)")
    parser.add_argument("--out", default=".",
                        help="directory for the figures (default: the working directory)")
    parser.add_argument("--no-figures", action="store_true",
                        help="run and print without drawing (drawing needs matplotlib)")
    args = parser.parse_args(argv)
    if not args.no_figures:
        os.makedirs(args.out, exist_ok=True)
    return args


def last_violation(log):
    """The last MPC violation a log holds, as the demos print it (a window
    under one MPC period holds only the solves at t = 0, which it does not
    log)."""
    return f"{log.mpc_viol[-1]:.2e}" if log.mpc_viol else "none after t = 0"


def main(argv=None):
    args = parse(argv, 2.0, __doc__)
    from qm_door_torch.config import default_config
    from qm_door_torch.device import resolve_precision
    from qm_door_torch.models import kinematics, spatial
    from qm_door_torch.models.model import aliengo_z1
    from qm_door_torch.ocp.gait import GAIT_LIBRARY, GaitSchedule
    from qm_door_torch.ocp.reference import TargetTrajectories
    from qm_door_torch.sim.closed_loop import ClosedLoopRunner
    from qm_door_torch.utils.dashboard import flight_report
    from qm_door_torch.utils.viz import plot_closed_loop

    duration = args.duration
    dev, dtype = resolve_precision(args.device)
    model = aliengo_z1(dtype=dtype, device=dev)
    cfg = default_config()
    cfg.controller.leg_pd_start_time = -1.0
    cfg.wbc.arm_init_time = -1.0

    x0 = torch.tensor(cfg.initial_state(), dtype=dtype, device=dev)
    R_ee, p_ee = kinematics.ee_pose(model, x0[6:30])
    quat = spatial.rot_to_quat(R_ee)
    state = torch.cat([x0, p_ee, quat])
    targets = TargetTrajectories.create(
        torch.tensor([0.0, 1e5], dtype=dtype, device=dev), torch.stack([state, state]),
        torch.zeros((2, 30), dtype=dtype, device=dev))

    sched = GaitSchedule()
    sched.insert_template(GAIT_LIBRARY["trot"], 0.0, duration + 5.0)
    runner = ClosedLoopRunner(model, cfg, schedule=sched)
    log = runner.run(targets, duration=duration)

    base = np.stack(log.base_pose)
    print(f"safe: {log.safe}; final base pose: {np.round(base[-1], 3)}")
    print(f"MPC violation (last): {last_violation(log)}")
    if not args.no_figures:
        path = plot_closed_loop(log, os.path.join(args.out, "trot_demo.png"),
                                f"{duration:.1f}s trot")
        flight_report(log, os.path.join(args.out, "trot_report.png"),
                      f"{duration:.1f}s trot flight report")
        print(f"wrote {path}")
    return log


if __name__ == "__main__":
    main()
