#!/usr/bin/env python3
"""Measure the launch shapes of the LQ kernels K3a (project_geom), K3b
(project_cost) and K3d (riccati_forward_ll) on one NVIDIA GPU.

    python3 lq_launch_shapes.py [K3a] [K3b] [K3d]   (no argument: all three)

K3a, K3b: qm_door_torch/csrc/lq_project.cu fixes at build time the blocks
an SM that each kernel's __launch_bounds__ asks for (-DQM_LQ_GEOM_BLOCKS,
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
phase (d).

K3d: csrc/lq_forward.cu runs one block a scenario, so the batch decides
how many waves its grid takes. The wave table times the normal build and
the PR 2 kernel's measuring build (-DQM_FWD_ROW_WARPS) in turns (row_warps,
new, new, row_warps) at B = 132, 264, 384, 396 and 768 scenarios of 67
nodes (chip_smoke.forward_data, contacts mixed), each held to
SWEEP_REL_TOL of the f64 plain version, beside its bound; then both
builds' registers and spills (ptxas), blocks an SM
(cudaOccupancyMaxActiveBlocksPerMultiprocessor) and phase clocks a node at
B = 384.

Prints one JSON line per measurement, the card's name and power limit, and
a last line with every result. Exits non-zero without a CUDA device.
"""
import json
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from chip_smoke import (FORWARD_BUILDS, PROJECTION_REL_TOL, SWEEP_REL_TOL, HBM_BYTES_PER_S,
                        card_line, chained, forward_blocks_per_sm, forward_bytes, forward_data,
                        forward_ptxas, in_turns, kernel_registers, kernel_spills, log, lq_call,
                        lq_instance, lq_phases, projection_data, rel_err)

PATH = (384, 67)
SHIFT = 1e-5
NORMAL = ()  # 5 blocks an SM for each projection kernel
SHAPES = {"K3a": {"geom_blocks4": ("QM_LQ_GEOM_BLOCKS=4",),
                  "geom_blocks6": ("QM_LQ_GEOM_BLOCKS=6",)},
          "K3b": {"cost_blocks4": ("QM_LQ_COST_BLOCKS=4",)}}
FORWARD_BATCHES = (132, 264, 384, 396, 768)


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


def checked(kid, name, out, ref, tol):
    rel, err = rel_err(out, ref)
    if not (rel <= tol and np.isfinite(rel)):
        raise RuntimeError(f"{kid} {name}: relative error {rel:.3e}")
    return {"rel_err": rel, "max_abs_err": err}


def timed(row, calls):
    """Time `calls` ({build: call}) in turns (their order, then reversed) into
    `row`: each build's mean as row[build]["ms"], every turn as row["ms_turns"]."""
    row["ms_turns"], means = in_turns(calls, list(calls) + list(calls)[::-1], chained(50))
    for build, ms in means.items():
        row[build]["ms"] = ms


def projection_shapes(dev, kids):
    """K3a, K3b (those of `kids`): each build of SHAPES against the normal
    build in turns."""
    result = {}
    if not {"K3a", "K3b"} & set(kids):
        return result
    for kid, (args, ref) in inputs(dev).items():
        if kid not in kids:
            continue
        builds = {"normal": NORMAL, **SHAPES[kid]}
        calls = {b: lq_call(kid, d, args, SHIFT) for b, d in builds.items()}
        row = {b: checked(kid, b, call(), ref, PROJECTION_REL_TOL) for b, call in calls.items()}
        timed(row, calls)
        log(json.dumps({kid: row}))
        result[kid] = row
    return result


def forward_waves(dev, reports):
    """K3d: the wave table of the normal and PR 2 builds, and both builds'
    registers, occupancy and phase clocks at PATH."""
    from qm_door_torch.ops import lq as tl

    Bmax, N = max(FORWARD_BATCHES), PATH[1]
    data = forward_data(Bmax, N, "mix", 0, dev)
    ref = tl.riccati_forward_ll_plain(*data)
    f32 = [t.float() for t in data]
    at = lambda Bb: [t[:Bb].contiguous() for t in f32]  # noqa: E731
    waves = {}
    for Bb in FORWARD_BATCHES:
        args, want = at(Bb), [r[:Bb] for r in ref]
        calls = {b: lq_call("K3d", FORWARD_BUILDS[b], args) for b in ("row_warps", "new")}
        row = {b: checked("K3d", f"{b} B={Bb}", call(), want, SWEEP_REL_TOL)
               for b, call in calls.items()}
        timed(row, calls)
        row["bound_ms"] = forward_bytes(Bb, N) / HBM_BYTES_PER_S * 1e3
        log(json.dumps({"K3d waves": {Bb: row}}))
        waves[Bb] = row
    args = at(PATH[0])
    builds = {b: {"ptxas": forward_ptxas(reports["lq_forward", d]),
                  "blocks_per_sm": forward_blocks_per_sm(d),
                  "phase_cycles_per_node": lq_phases("K3d", b, args)}
              for b, d in FORWARD_BUILDS.items()}
    log(json.dumps({"K3d builds": builds}))
    return {"waves": waves, "builds": builds}


def main():
    import torch

    if not torch.cuda.is_available():
        print("lq_launch_shapes: no CUDA device available", file=sys.stderr)
        return 2
    kids = sys.argv[1:] or ["K3a", "K3b", "K3d"]
    if not set(kids) <= {"K3a", "K3b", "K3d"}:
        print(f"lq_launch_shapes: unknown kernel in {kids}", file=sys.stderr)
        return 2
    import qm_door_torch  # noqa: F401
    from qm_door_torch.ops import cuda_build
    from qm_door_torch.ops.lq import FWD_PHASE_CLOCKS

    dev = torch.device("cuda", 0)
    libs = []
    if {"K3a", "K3b"} & set(kids):
        libs += [("lq_project", NORMAL)] + [("lq_project", d) for k in kids if k in SHAPES
                                            for d in SHAPES[k].values()]
    if "K3d" in kids:
        libs += [("lq_forward", d) for d in FORWARD_BUILDS.values()]
        libs += [("lq_forward", d + (FWD_PHASE_CLOCKS,)) for d in FORWARD_BUILDS.values()]
    with ThreadPoolExecutor(len(libs)) as pool:
        reports = dict(zip(libs, pool.map(lambda lib: cuda_build.build(*lib), libs)))
    ptxas = {}
    for (name, defines), report in reports.items():
        if name == "lq_project":
            spills = kernel_spills(report, "project_")
            ptxas[" ".join((name,) + defines)] = {
                lq_instance(f): {"registers": r, "spill_stores": spills[f]}
                for f, r in kernel_registers(report, "project_").items()}
        else:
            ptxas[" ".join((name,) + defines)] = forward_ptxas(report)
    log(json.dumps({"ptxas": ptxas}))
    result = {"ptxas": ptxas, **projection_shapes(dev, kids)}
    if "K3d" in kids:
        result["K3d"] = forward_waves(dev, reports)
    log(card_line())
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
