#!/usr/bin/env python3
"""The readings the limits of ``correct`` are set from, for one cell.

    python3 perfbench/readings.py --workload <name> --seconds <s> --seeds <n> [<n> ...]

For each seed, one run of the cell (a short window at its own load) gives
the program's numbers, the lower readings; the control (``control.py``)
on the same sampled inputs gives the upper readings. Prints one JSON line
a seed and the largest of each over the seeds.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=6.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args()

    from perfbench import control, correct, harness

    lower, upper = {}, {}
    for seed in args.seeds:
        res = harness.run(args.workload, seed, args.seconds, False)
        ctl = control.outputs(res["cfg"], res["samples"], "cuda")
        ctl_checks, ctl_ok = correct.judge(res["cfg"], res["cfg"]["limits"], ctl, "cuda")
        row = {"seed": seed, "steps": res["steps"], "program": res["checks"],
               "program_correct": res["correct"], "control": ctl_checks,
               "control_correct": ctl_ok,
               "alphas": sorted({float(a) for g in res["samples"] for a in g["alpha"]})}
        print(json.dumps(row), flush=True)
        for k, v in res["checks"].items():
            lower[k] = max(lower.get(k, 0.0), v)
        for k, v in ctl_checks.items():
            upper[k] = min(upper.get(k, float("inf")), v)
    print(json.dumps({"lower": lower, "upper": upper}), flush=True)


if __name__ == "__main__":
    main()
