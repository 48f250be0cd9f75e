#!/usr/bin/env python
"""Closed-loop door-opening demo of the torch port (examples/door_demo.py on
qm_door_torch; the reference's force-tracking branch running the qm_gazebo
push_door world).

Runs the full force-tracking stack — sim(1 kHz) + force-aware WBC(500 Hz) +
36-input NMPC(100 Hz) + articulated door — until the robot has pressed the
lever, released the latch, and swung the panel past the open target.

    python examples/door_demo_torch.py [duration_s] [--device cpu] [--out DIR]
        [--no-figures]

On the CUDA device in float32 by default; ``--device cpu`` runs on the CPU
in float64. Writes door_demo.png into DIR (default: the working directory),
unless --no-figures.
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np  # noqa: E402

from trot_demo_torch import last_violation, parse  # noqa: E402


def main(argv=None):
    args = parse(argv, 6.5, __doc__)
    from qm_door_torch.config import default_config
    from qm_door_torch.device import resolve_precision
    from qm_door_torch.models.model import aliengo_z1
    from qm_door_torch.sim.door_loop import DoorOpeningRunner

    dev, dtype = resolve_precision(args.device)
    model = aliengo_z1(dtype=dtype, device=dev)
    cfg = default_config()
    cfg.controller.leg_pd_start_time = -1.0
    cfg.wbc.arm_init_time = -1.0

    runner = DoorOpeningRunner(model, cfg)
    log = runner.run(duration=args.duration)

    panel = np.asarray(log.panel)
    print(f"safe: {log.safe}")
    print(f"panel angle: final {panel[-1]:.3f} rad, min {panel.min():.3f} rad")
    print(f"lever: min {min(log.lever):.3f} rad")
    print(f"EE-handle err: max {max(log.ee_err)*1000:.1f} mm, "
          f"final {log.ee_err[-1]*1000:.1f} mm")
    print(f"MPC violation (last): {last_violation(log)}")
    opened = panel.min() <= runner.scenario.open_target
    print(f"door opened past {runner.scenario.open_target} rad: {opened}")
    if args.no_figures:
        return log

    # door-opening dashboard: panel/lever trajectories + base pose
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    t = np.asarray(log.t)
    base = np.stack(log.base_pose)
    fig, axes = plt.subplots(1, 3, figsize=(15, 4))
    axes[0].plot(t, panel, label="panel")
    axes[0].plot(t, np.asarray(log.lever), label="lever")
    axes[0].axhline(runner.scenario.open_target, ls="--", c="gray", lw=0.8)
    axes[0].set_title("door joints (rad)")
    axes[0].legend()
    axes[1].plot(t, base[:, 0:3])
    axes[1].set_title("base position")
    axes[1].legend(["x", "y", "z"], fontsize=8)
    axes[2].semilogy(np.asarray(log.mpc_t), np.maximum(log.mpc_viol, 1e-12))
    axes[2].set_title("MPC constraint violation")
    fig.tight_layout()
    path = os.path.join(args.out, "door_demo.png")
    fig.savefig(path, dpi=110)
    plt.close(fig)
    print(f"wrote {path}")
    return log


if __name__ == "__main__":
    main()
