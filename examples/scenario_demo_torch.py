#!/usr/bin/env python
"""Run any registry scenario closed-loop on the torch port
(examples/scenario_demo.py on qm_door_torch; the `roslaunch <world>` role).

    python examples/scenario_demo_torch.py [name] [duration_s] [--separated]
        [--device cpu] [--out DIR] [--no-figures]

Names: empty, mobile, stairs, sar, pallets, tunnel, vchimney, maze,
push_door (see qm_door_torch/scenarios.py). On the CUDA device in float32 by
default; ``--device cpu`` runs on the CPU in float64. Writes
<name>_report.png into DIR (default: the working directory) unless
--no-figures; a door scenario prints its panel angle and writes no figure.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np  # noqa: E402

from trot_demo_torch import last_violation  # noqa: E402


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("name", nargs="?", default="empty", help="scenario (default empty)")
    parser.add_argument("duration", nargs="?", type=float, default=3.0,
                        help="seconds of simulated time (default 3)")
    parser.add_argument("--separated", action="store_true",
                        help="the separated-system controller (the reference's ss/ set)")
    parser.add_argument("--device", default=None,
                        help="cpu to run on the CPU in float64 (default: the CUDA device, "
                             "float32)")
    parser.add_argument("--out", default=".",
                        help="directory for the figure (default: the working directory)")
    parser.add_argument("--no-figures", action="store_true",
                        help="run and print without drawing (drawing needs matplotlib)")
    args = parser.parse_args(argv)
    name, duration = args.name, args.duration

    from qm_door_torch.device import resolve_precision
    from qm_door_torch.models.model import aliengo_z1
    from qm_door_torch.scenarios import DOOR_SCENARIOS, make_scenario

    dev, dtype = resolve_precision(args.device)
    runner, targets = make_scenario(name, model=aliengo_z1(dtype=dtype, device=dev),
                                    duration=duration, separated=args.separated)
    if name in DOOR_SCENARIOS:
        log = runner.run(duration=duration)
        panel = np.asarray(log.panel)
        print(f"safe: {log.safe}  panel min {panel.min():.3f} rad")
        return log

    log = runner.run(targets, duration=duration)
    base = np.stack(log.base_pose)
    print(f"safe: {log.safe}")
    print(f"final base pose {np.array2string(base[-1], precision=3)}")
    print(f"MPC violation last {last_violation(log)}")
    if args.no_figures:
        return log

    from qm_door_torch.utils.dashboard import flight_report

    os.makedirs(args.out, exist_ok=True)
    path = flight_report(log, os.path.join(args.out, f"{name}_report.png"),
                         f"{name} scenario ({duration:.1f}s)")
    print(f"wrote {path}")
    return log


if __name__ == "__main__":
    main()
