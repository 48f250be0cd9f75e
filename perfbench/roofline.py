"""Peaks of the chip and the least time of a kernel's launch.

Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, at its full
700 W power limit): 3.35 TB/s of HBM3, 67 TFLOP/s in float32 outside the
tensor cores. A share of a roofline is stated against these, with the
card's power limit printed beside it.
"""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12


def spd_solve_bytes(batch: int, n: int, m: int) -> int:
    """Bytes a K1 launch must move: each system's lower triangle of A, its
    right-hand sides and its solution, float32, each once."""
    return 4 * batch * (n * (n + 1) // 2 + 2 * n * m)


def spd_solve_flops(batch: int, n: int, m: int) -> int:
    """Flops of a Cholesky solve: the factor (n^3 / 3) and two triangular
    solves a right-hand side (2 n^2 m)."""
    return batch * (n ** 3 // 3 + 2 * n * n * m)


def spd_solve_bound_s(batch: int, n: int, m: int) -> float:
    """The least time of a K1 launch on the chip."""
    return max(spd_solve_bytes(batch, n, m) / HBM_BYTES_PER_S,
               spd_solve_flops(batch, n, m) / F32_FLOPS_PER_S)
