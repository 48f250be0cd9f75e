#!/usr/bin/env python3
"""Measure the launch shapes of K1's register variants on one NVIDIA GPU.

    python3 k1_launch_shapes.py

The reg16/reg32 variants of qm_door_torch/csrc/spd_solve.cu fix two launch
choices at build time; this script builds the source with each alternative
(-D, one nvcc each, all at once) and times them on the same inputs:

  1. launch form: 4-warp blocks that walk the batch with the next system
     staged (the normal build) against one-warp blocks, one system each
     (-DQM_K1_ONE_WARP_BLOCKS), for both variants at batches from 384 to
     25728, and for K1-ll (lanes-last strides) at 384 x 30 x 31: whether
     either form is faster at some batch;
  2. __launch_bounds__ minimum blocks an SM for NP = 16
     (-DQM_K1_REG16_BLOCKS=3, 4, 5, 6): each build's registers and spills
     from ptxas, and its time at the projection shape.

Every build's result is held to 1e-4 relative against the f64 plain solve.
Times are device ms a call in a CUDA graph of 50 calls (graph) and over 50
chained calls between CUDA events (events), in turns (ABBA, or ABCDDCBA).
Prints one JSON line per measurement, the card's name and power limit, and
a last line with every result. Exits non-zero without a CUDA device.
"""
import json
import re
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from chip_smoke import K1_REL_TOL, card_line, chained, graph_ms, in_turns, log, spd_batch

ONE_WARP = ("QM_K1_ONE_WARP_BLOCKS",)
GRID_STRIDE = ()  # the normal build
MIN_BLOCKS = {k: () if k == 4 else (f"QM_K1_REG16_BLOCKS={k}",) for k in (3, 4, 5, 6)}
BATCHES = (384, 1056, 2112, 4224, 8448, 25728)
SHAPES = {"reg16": (12, 49), "reg32": (30, 31)}  # the projection's and the gain's (n, m)


def ptxas_kernels(report):
    """{"NP<np>_CPL<cpl>": {registers, spill_stores}} of each spd_reg_kernel
    instantiation in a ptxas -v report."""
    out, current = {}, None
    for line in report.splitlines():
        name = re.search(r"Compiling entry function '(\S+)'", line)
        if name:
            inst = re.search(r"spd_reg_kernelILi(\d+)ELi(\d+)E", name.group(1))
            current = f"NP{inst.group(1)}_CPL{inst.group(2)}" if inst else None
        elif current and "spill stores" in line:
            out.setdefault(current, {})["spill_stores"] = int(
                re.search(r"(\d+) bytes spill stores", line).group(1))
        elif current and "Used" in line and "registers" in line:
            out.setdefault(current, {})["registers"] = int(
                re.search(r"Used (\d+) registers", line).group(1))
    return out


def solver(defines, variant, A, Y, lanes_last=False):
    """One call of `variant` from the build with `defines`, X = A^-1 Y:
    A (B,n,n), Y (B,n,m), or A (n,n,B), Y (n,m,B) when `lanes_last`."""
    import torch

    from qm_door_torch.ops import spd_solve as k1
    from qm_door_torch.ops.cuda_build import check_launch

    (n, m, batch), strides = ((Y.shape, (1, 1, Y.shape[2])) if lanes_last else
                              ((Y.shape[1], Y.shape[2], Y.shape[0]),
                               (Y.shape[1] ** 2, Y.shape[1] * Y.shape[2], 1)))
    X = torch.empty_like(Y)
    fn = k1.kernel_fn(variant, defines)

    def call():
        check_launch("k1_launch_shapes", fn(
            A.data_ptr(), Y.data_ptr(), X.data_ptr(), batch, n, m, 0.0, *strides,
            torch.cuda.current_stream(A.device).cuda_stream))
        return X

    return call


def inputs(rng, dev, batch, n, m):
    """f32 SPD systems on the card and the f64 plain solve of them."""
    import torch

    from qm_door_torch.ops.spd_solve import spd_solve_plain

    A64, Y64 = spd_batch(rng, batch, n, m)
    X_ref = spd_solve_plain(torch.tensor(A64, device=dev), torch.tensor(Y64, device=dev))
    return (torch.tensor(A64, dtype=torch.float32, device=dev),
            torch.tensor(Y64, dtype=torch.float32, device=dev), X_ref)


FORM_TURNS = ("one_warp", "grid_stride", "grid_stride", "one_warp")


def checked_turns(calls, X_ref, order):
    """Check each call against X_ref, then time them in turns in `order`
    (keys of `calls`, each twice), in a CUDA graph and then in chained
    calls; mean graph and events ms a call for each."""
    import torch

    for key, call in calls.items():
        X = call()
        torch.cuda.synchronize()
        rel = (X.double() - X_ref).abs().max().item() / X_ref.abs().max().item()
        if not rel <= K1_REL_TOL:
            raise RuntimeError(f"{key}: relative error {rel:.3e} > {K1_REL_TOL}")
    graph_turns, graph = in_turns(calls, order, graph_ms)
    _, events = in_turns(calls, order, chained(50))
    return {key: {"graph_ms": graph[key], "events_ms": events[key],
                  "graph_turns": [ms for turn, ms in graph_turns.items()
                                  if turn.rsplit("_", 1)[0] == str(key)]} for key in calls}


def main():
    import torch

    if not torch.cuda.is_available():
        print("k1_launch_shapes: no CUDA device available", file=sys.stderr)
        return 2
    import qm_door_torch  # noqa: F401
    from qm_door_torch.ops import cuda_build

    dev = torch.device("cuda", 0)
    builds = [GRID_STRIDE, ONE_WARP] + [d for d in MIN_BLOCKS.values() if d]
    with ThreadPoolExecutor(len(builds)) as pool:
        reports = list(pool.map(lambda d: cuda_build.build("spd_solve", d), builds))
    ptxas = {" ".join(d) or "normal": ptxas_kernels(r) for d, r in zip(builds, reports)}
    log(json.dumps({"ptxas": ptxas}))
    rng = np.random.default_rng(0)
    result = {"ptxas": ptxas, "launch_form": {}, "reg16_min_blocks": {}}

    for variant, (n, m) in SHAPES.items():
        for batch in BATCHES:
            A, Y, X_ref = inputs(rng, dev, batch, n, m)
            calls = {"one_warp": solver(ONE_WARP, variant, A, Y),
                     "grid_stride": solver(GRID_STRIDE, variant, A, Y)}
            row = checked_turns(calls, X_ref, FORM_TURNS)
            row = {"variant": variant, "batch": batch, "n": n, "m": m, **row}
            log(json.dumps(row))
            result["launch_form"][f"{variant}_{batch}"] = row
    n, m = SHAPES["reg32"]
    A, Y, X_ref = (t.permute(1, 2, 0).contiguous() for t in inputs(rng, dev, BATCHES[0], n, m))
    calls = {form: solver(d, "reg32", A, Y, lanes_last=True)
             for form, d in (("one_warp", ONE_WARP), ("grid_stride", GRID_STRIDE))}
    row = checked_turns(calls, X_ref, FORM_TURNS)
    row = {"variant": "reg32", "lanes_last": True, "batch": BATCHES[0], "n": n, "m": m, **row}
    log(json.dumps(row))
    result["launch_form"][f"reg32_lanes_last_{BATCHES[0]}"] = row

    n, m = SHAPES["reg16"]
    A, Y, X_ref = inputs(rng, dev, BATCHES[-1], n, m)
    calls = {k: solver(d, "reg16", A, Y) for k, d in MIN_BLOCKS.items()}
    order = (4, 3, 5, 6, 6, 5, 3, 4)
    result["reg16_min_blocks"] = {str(k): v for k, v in checked_turns(calls, X_ref, order).items()}
    log(json.dumps({"reg16_min_blocks": result["reg16_min_blocks"]}))
    log(card_line())
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
