#!/usr/bin/env python3
"""Measure the launch shapes and the node loads of the backward sweep's reg
variant (K2, K3c) on one NVIDIA GPU.

    python3 sweep_launch_shapes.py

The reg variant of qm_door_torch/csrc/riccati_bwd.cu fixes two choices at
build time: its block (-DQM_SWEEP_REG_THREADS, -DQM_SWEEP_REG_BLOCKS:
threads a block and the blocks an SM that __launch_bounds__ asks for, which
set the registers a thread) and its node loads (cp.async a node ahead into
a second buffer set, or, with -DQM_SWEEP_SYNC_LOADS, each node's data
loaded at its start). This script builds the source with each alternative
(one nvcc each, all at once), reads each build's registers and spill stores from
ptxas, holds each build's K2 and K3c to SWEEP_REL_TOL of the f64 plain
sweep, and times them with the smem variant (the block-parallel kernel) in
chained calls between CUDA events, in turns (A B C ... C B A), at the
solver's shape: 384 scenarios x 67 nodes, nx = nu = 30, f32, on random data of the
JAX tests' recipe with A = 0.95 I + noise (so the 67-node carry stays
bounded). Prints one JSON line per measurement, the card's name and power
limit, and a last line with every result. Exits non-zero without a CUDA
device.
"""
import json
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from chip_smoke import (SWEEP_REL_TOL, card_line, chained, in_turns, kernel_registers,
                        kernel_spills, log, rel_err, sweep_data, sweep_instance)

NORMAL = ()  # 128 threads, 3 blocks an SM, loads a node ahead
SHAPES = {"128x3": NORMAL, "128x3_sync_loads": ("QM_SWEEP_SYNC_LOADS",),
          "128x4": ("QM_SWEEP_REG_THREADS=128", "QM_SWEEP_REG_BLOCKS=4"),
          "192x3": ("QM_SWEEP_REG_THREADS=192", "QM_SWEEP_REG_BLOCKS=3"),
          "224x3": ("QM_SWEEP_REG_THREADS=224", "QM_SWEEP_REG_BLOCKS=3"),
          "256x3": ("QM_SWEEP_REG_THREADS=256", "QM_SWEEP_REG_BLOCKS=3")}
PATH_SHAPE = (384, 67, 30, 30)


def sweep(defines, variant, args, symmetrize):
    """One call of a sweep variant from the build with `defines`."""
    import torch

    from qm_door_torch.ops import riccati_fused as rf
    from qm_door_torch.ops.cuda_build import check_launch

    Bb, N, nx, nu = args[1].shape
    K = torch.empty(Bb, N, nu, nx, device=args[0].device)
    kff = torch.empty(Bb, N, nu, device=args[0].device)
    fn = rf.kernel_fn(variant, defines)

    def call():
        check_launch("sweep_launch_shapes", fn(
            *(t.data_ptr() for t in args), K.data_ptr(), kff.data_ptr(), Bb, N, nx, nu, 0.0,
            int(symmetrize), torch.cuda.current_stream(args[0].device).cuda_stream, None))
        return K, kff

    return call


def main():
    import torch

    if not torch.cuda.is_available():
        print("sweep_launch_shapes: no CUDA device available", file=sys.stderr)
        return 2
    import qm_door_torch  # noqa: F401
    from qm_door_torch.ops import cuda_build
    from qm_door_torch.ops.riccati_fused import sweep_plain

    dev = torch.device("cuda", 0)
    with ThreadPoolExecutor(len(SHAPES)) as pool:
        reports = dict(zip(SHAPES, pool.map(lambda d: cuda_build.build("riccati_bwd", d),
                                            SHAPES.values())))
    ptxas = {}
    for shape, report in reports.items():
        spills = kernel_spills(report, "riccati_bwd_kernel")
        regs = kernel_registers(report, "riccati_bwd_kernel")
        ptxas[shape] = {sweep_instance(k): {"registers": regs[k], "spill_stores": spills[k]}
                        for k in regs}
    log(json.dumps({"ptxas": ptxas}))

    data = sweep_data(PATH_SHAPE)
    data[0] = (0.95 * np.eye(PATH_SHAPE[2])
               + np.random.default_rng(7).normal(size=data[0].shape) * 0.01)
    args = [torch.tensor(t, dtype=torch.float32, device=dev) for t in data]
    f64 = [torch.tensor(t, device=dev) for t in data]
    result = {"ptxas": ptxas}
    for kid, symmetrize in (("K2", True), ("K3c", False)):
        ref = sweep_plain(*f64, 0.0, symmetrize)
        calls = {"smem": sweep(NORMAL, "smem", args, symmetrize)}
        calls.update({f"reg_{shape}": sweep(d, "reg", args, symmetrize)
                      for shape, d in SHAPES.items()})
        row = {}
        for key, call in calls.items():
            rel, _ = rel_err(call(), ref)
            if not rel <= SWEEP_REL_TOL:
                raise RuntimeError(f"{kid} {key}: relative error {rel:.3e} > {SWEEP_REL_TOL}")
            row[key] = {"rel_err": rel}
        row["ms_turns"], means = in_turns(calls, list(calls) + list(calls)[::-1], chained(20))
        for key, ms in means.items():
            row[key]["ms"] = ms
        log(json.dumps({kid: row}))
        result[kid] = row
    log(card_line())
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
