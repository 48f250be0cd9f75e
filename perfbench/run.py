#!/usr/bin/env python3
"""The benchmark of qm_door_torch: one run of one cell.

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Sets the cell up from BENCHMARK.json and the files it names, measures
for ``--seconds`` seconds, holds a sample of the window's solves to the
plain reference, and prints one JSON line last on standard output:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's end-to-end
metrics with ``--trace 0``, its per-layer metrics with ``--trace 1``),
``device`` (with ``--trace 1`` also ``busy_s`` and ``window_s``), with
``--trace 1`` a ``breakdown``, and last ``checks``: each number compared
beside its limit, also printed as the last lines of standard error.

Exits non-zero with no result line without enough CUDA devices, when
the program cannot be imported, or when jax, jaxlib, flax or qm_door_tpu
was loaded in this process.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "qm_door_tpu")
# every kernel cache of the run at a fixed place inside the checkout
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(ROOT, "build", "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, "build", "triton")
sys.path.insert(0, ROOT)


def forbidden_modules():
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def card_line():
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "not read"
    except (OSError, subprocess.TimeoutExpired, IndexError):
        return "not read"


def result_line(res, metrics, trace, on_cuda=True):
    import torch

    checks = {k: {"value": v, "limit": res["cfg"]["limits"][k]} for k, v in res["checks"].items()}
    device = {"platform": "gpu" if on_cuda else "cpu",
              "kind": torch.cuda.get_device_name(0) if on_cuda else "cpu",
              "count": res["cell"]["chips"], "memory_peak_bytes": res["memory_peak_bytes"]}
    line = {"correct": res["correct"], "attempted": res["attempted"], "failed": res["failed"],
            "metrics": metrics, "device": device}
    if trace:
        t = res["trace"]
        device.update(busy_s=t.busy_s, window_s=t.window_s)
        line["breakdown"] = {"device_ops": t.device_ops, "idle_gaps": t.idle_gaps}
    line["checks"] = checks
    return line


def main(argv=None, device="cuda", batch=None, step_hook=None):
    """The run; the tests pass ``device="cpu"`` (no look for a card), a
    smaller ``batch`` and a planted fault (``step_hook``)."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from perfbench import harness

    _, cell, _, _ = harness.cell_spec(args.workload)
    on_cuda = device == "cuda"
    if on_cuda and (not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]):
        print(f"perfbench: the cell needs {cell['chips']} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    if on_cuda:
        print(f"perfbench: card {card_line()}", file=sys.stderr, flush=True)
    res = harness.run(args.workload, args.seed, args.seconds, bool(args.trace), device=device,
                      step_hook=step_hook, batch=batch)
    metrics = harness.read_metrics(res["bench"], res["cell"], res, bool(args.trace))
    found = forbidden_modules()
    if found:
        print(f"perfbench: the run loaded {', '.join(found)}", file=sys.stderr)
        return 3
    line = result_line(res, metrics, bool(args.trace), on_cuda)
    print(f"perfbench: {res['steps']} steps in {res['window_s']:.3f} s, set-up "
          f"{res['setup_s']:.3f} s, check {res['check_s']:.1f} s", file=sys.stderr)
    print(f"perfbench: host {json.dumps(res['host'])}", file=sys.stderr)
    if "device_window" in res:
        # the window traced whole: the card's time, and each profile's steps
        # and readings (operations alike a step in every profile of a
        # lock-step stream, and busy time alike work time on one stream, so a
        # profile that lost events or timestamps shows)
        print(f"perfbench: device {json.dumps(res['device_window'])}", file=sys.stderr)
    for name, c in line["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
