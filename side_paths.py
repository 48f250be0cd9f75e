#!/usr/bin/env python3
"""chip_smoke.py phase (j)'s separated and kalman paths alone on one NVIDIA
GPU: builds K1 (qm_door_torch/csrc/spd_solve.cu), then runs each path for
chip_smoke.SIDE_SECONDS in f32 on the card against the port's own f64 run
on the CPU (two spawned processes), as phase_trot does after the trot:
K1 exactly 68 a solve and 101 a tick, the base pose, the leg and the arm
joints within chip_smoke.SIDE_BARS.

    python3 side_paths.py

A minute or so of the card; exits non-zero on any failure.
"""
import multiprocessing
import os
import sys
import time
from concurrent.futures import ProcessPoolExecutor

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import chip_smoke  # noqa: E402


def main():
    import torch

    if not torch.cuda.is_available():
        print("side_paths: no CUDA device available", file=sys.stderr)
        return 2
    import qm_door_torch  # noqa: F401  (pins full-f32 matmuls)
    from qm_door_torch.ops import cuda_build

    t0 = time.time()
    cuda_build.build("spd_solve", ())
    dev = torch.device("cuda", 0)
    with ProcessPoolExecutor(2, mp_context=multiprocessing.get_context("spawn")) as pool:
        refs = {label: pool.submit(chip_smoke.side_reference, kw)
                for label, kw in chip_smoke.SIDE_PATHS.items()}
        for label, kw in chip_smoke.SIDE_PATHS.items():
            chip_smoke.side_run(dev, label, refs[label], **kw)
    chip_smoke.log(f"total {time.time() - t0:.1f} s")
    chip_smoke.log(chip_smoke.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
