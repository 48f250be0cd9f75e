#!/usr/bin/env python
"""End-effector goal tracking demo of the torch port
(examples/ee_tracking_demo.py on qm_door_torch; the RViz interactive-marker
flow).

Commands the arm EE to a goal pose through the same converter the reference's
marker/planner uses (EEgoalPoseToTargetTrajectories) while holding stance.

    python examples/ee_tracking_demo_torch.py [duration_s] [--device cpu] [--out DIR]
        [--no-figures]

On the CUDA device in float32 by default; ``--device cpu`` runs on the CPU
in float64. The window is 1.5 s unless given. Writes ee_tracking_report.png
(the flight report) into DIR (default: the working directory), unless
--no-figures.
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from trot_demo_torch import parse  # noqa: E402


def main(argv=None):
    args = parse(argv, 1.5, __doc__)
    from qm_door_torch.config import default_config
    from qm_door_torch.device import resolve_precision
    from qm_door_torch.models import kinematics, spatial
    from qm_door_torch.models.model import aliengo_z1
    from qm_door_torch.runtime.targets import ee_goal_to_target_trajectories
    from qm_door_torch.sim.closed_loop import ClosedLoopRunner
    from qm_door_torch.utils.dashboard import flight_report

    duration = args.duration
    dev, dtype = resolve_precision(args.device)
    model = aliengo_z1(dtype=dtype, device=dev)
    cfg = default_config()
    cfg.controller.leg_pd_start_time = -1.0
    cfg.wbc.arm_init_time = -1.0

    x0 = cfg.initial_state()
    q0 = torch.tensor(x0[6:30], dtype=dtype, device=dev)
    R_ee, p_ee = kinematics.ee_pose(model, q0)
    quat = spatial.rot_to_quat(R_ee).cpu().numpy()
    p_ee = p_ee.cpu().numpy()
    ee_state = np.concatenate([p_ee, quat])

    goal = p_ee + np.array([0.08, 0.05, 0.05])
    targets = ee_goal_to_target_trajectories(
        goal, quat, x0, ee_state, 0.0, cfg, feet_height=0.0, dtype=dtype, device=dev)

    runner = ClosedLoopRunner(model, cfg)
    log = runner.run(targets, duration=duration)
    ee = np.stack(log.ee_pos)
    err = np.linalg.norm(ee[-1] - goal)
    print(f"safe: {log.safe}; EE goal error after {duration:g} s: {err*100:.1f} cm")
    print(f"EE path: start {np.round(ee[0],3)} -> end {np.round(ee[-1],3)} "
          f"(goal {np.round(goal,3)})")
    if not args.no_figures:
        path = flight_report(log, os.path.join(args.out, "ee_tracking_report.png"),
                             f"EE goal tracking ({duration:g}s)")
        print(f"wrote {path}")
    return log


if __name__ == "__main__":
    main()
