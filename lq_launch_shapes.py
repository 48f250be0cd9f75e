#!/usr/bin/env python3
"""Measure the block shapes of the projection kernels K3a (project_geom) and
K3b (project_cost) on one NVIDIA GPU.

    python3 lq_launch_shapes.py

qm_door_torch/csrc/lq_project.cu fixes at build time the blocks an SM that
each kernel's __launch_bounds__ asks for (-DQM_LQ_GEOM_BLOCKS,
-DQM_LQ_COST_BLOCKS, 5 each by default), which set the registers a thread
and the grid its entry point launches. This script builds the source with
each alternative of SHAPES (one nvcc each, all at once), reads each
build's registers and spill stores from ptxas, holds each build's kernel to
PROJECTION_REL_TOL of the f64 plain version, and times it against the
normal build in chained calls between CUDA events, in turns (normal,
others, others reversed, normal), at the solver's shape: 384 x 67 = 25,728
nodes, f32, on the JAX tests' random recipe with a random mix of contacts
(the kernels have no data-dependent branch or loop bound). The normal
build against the scalar-product kernels it replaced is chip_smoke.py's
phase (d). Prints one JSON line per measurement, the card's name and power
limit, and a last line with every result. Exits non-zero without a CUDA
device.
"""
import json
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from chip_smoke import (PROJECTION_REL_TOL, card_line, cuda_ms, kernel_registers,
                        kernel_spills, log, lq_instance, lq_project_call, projection_data,
                        rel_err)

PATH = (384, 67)
SHIFT = 1e-5
NORMAL = ()  # 5 blocks an SM for each kernel
SHAPES = {"K3a": {"geom_blocks4": ("QM_LQ_GEOM_BLOCKS=4",),
                  "geom_blocks6": ("QM_LQ_GEOM_BLOCKS=6",)},
          "K3b": {"cost_blocks4": ("QM_LQ_COST_BLOCKS=4",)}}


def inputs(dev):
    """f32 CUDA inputs of K3a and K3b at PATH and their f64 plain outputs;
    K3b's p, P, Px_v are K3a's f64 plain outputs rounded to f32."""
    import torch

    from qm_door_torch.ops import lq as tl

    geom, cost = projection_data(*PATH, "mix", 0)
    g64 = [torch.tensor(t, device=dev) for t in geom]
    ref_geom = tl.project_geom_plain(*g64)
    c64 = [torch.tensor(t, device=dev) for t in cost] + list(ref_geom[3:]) + [g64[-1]]
    f32 = lambda ts: [t.float().contiguous() for t in ts]  # noqa: E731
    return {"K3a": (f32(g64), ref_geom),
            "K3b": (f32(c64), tl.project_cost_plain(*c64, shift=SHIFT))}


def main():
    import torch

    if not torch.cuda.is_available():
        print("lq_launch_shapes: no CUDA device available", file=sys.stderr)
        return 2
    import qm_door_torch  # noqa: F401
    from qm_door_torch.ops import cuda_build

    dev = torch.device("cuda", 0)
    every = [NORMAL] + [d for shapes in SHAPES.values() for d in shapes.values()]
    with ThreadPoolExecutor(len(every)) as pool:
        reports = dict(zip(every, pool.map(lambda d: cuda_build.build("lq_project", d), every)))
    ptxas = {}
    for defines, report in reports.items():
        spills = kernel_spills(report, "project_")
        ptxas[" ".join(("lq_project",) + defines)] = {
            lq_instance(f): {"registers": r, "spill_stores": spills[f]}
            for f, r in kernel_registers(report, "project_").items()}
    log(json.dumps({"ptxas": ptxas}))
    result = {"ptxas": ptxas}

    for kid, (args, ref) in inputs(dev).items():
        builds = {"normal": NORMAL, **SHAPES[kid]}
        calls = {b: lq_project_call(kid, d, args, SHIFT) for b, d in builds.items()}
        row = {}
        for build, call in calls.items():
            rel, err = rel_err(call(), ref)
            if not rel <= PROJECTION_REL_TOL:
                raise RuntimeError(f"{kid} {build}: relative error {rel:.3e}")
            row[build] = {"rel_err": rel, "max_abs_err": err, "ms_turns": []}
        for build in list(calls) + list(calls)[::-1]:
            row[build]["ms_turns"].append(cuda_ms(calls[build], reps=50))
        for build in row:
            row[build]["ms"] = float(np.mean(row[build]["ms_turns"]))
        log(json.dumps({kid: row}))
        result[kid] = row
    log(card_line())
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
