"""K1: batched small SPD solve, X = (A + shift*I)^-1 Y.

Replaces the Pallas TPU kernel ``qm_door_tpu/ops/pallas_chol.py:spd_solve``
(``_spd_kernel``). The CUDA kernel is ``qm_door_torch/csrc/spd_solve.cu``:
one warp per system, the system staged in shared memory, a right-looking
Cholesky with the same guarded rsqrt pivots, then forward and back
substitution with one lane per right-hand-side column. It is bound by
memory on an H100 (each input byte read once, each output byte written
once, ~3 flops a byte); the source note has the arithmetic and the design.
It reads only the lower triangle of A: both solver call sites pass exactly
symmetric matrices.

:func:`spd_solve` launches the kernel for CUDA tensors (f32, n <= 64) and
raises for anything it cannot take; for CPU tensors it runs
:func:`spd_solve_plain`, the same algorithm as batched torch ops.
"""
from __future__ import annotations

import ctypes

import torch

MAX_N = 64
_CUDA_ERROR_INVALID_VALUE = 1  # cudaErrorInvalidValue


def spd_solve_plain(A, Y, shift: float = 0.0):
    """The kernel's algorithm as batched torch ops (mirrors ``_chol_t`` /
    ``_chol_solve_t``): A (B,n,n) symmetric positive definite, read through
    its lower triangle; Y (B,n,m) -> X (B,n,m)."""
    n = A.shape[-1]
    dtype = A.dtype
    eye = torch.eye(n, dtype=dtype, device=A.device)
    M = A + shift * eye
    rows = torch.arange(n, device=A.device)
    cols = []
    for k in range(n):
        inv_d = torch.rsqrt(torch.clamp(M[:, k, k], min=1e-30))
        col = M[:, :, k] * inv_d[:, None] * (rows >= k).to(dtype)
        cols.append(col)
        if k + 1 < n:
            M = M - col[:, :, None] * col[:, None, :]
    Lt = torch.stack(cols, dim=1)  # Lt[:, k, i] = L[i, k]

    r = rows[:, None]
    Z = Y
    for i in range(n):
        Li = Lt[:, i, :]
        zi = Z[:, i, :] / Li[:, i, None]
        upd = Li[:, :, None] * zi[:, None, :]
        Z = torch.where(r == i, zi[:, None, :], Z - upd * (r > i).to(dtype))
    X = Z
    for i in reversed(range(n)):
        Li = Lt[:, i, :]
        s = torch.sum(Li[:, :, None] * X * (r > i).to(dtype), dim=1)
        xi = (X[:, i, :] - s) / Li[:, i, None]
        X = torch.where(r == i, xi[:, None, :], X)
    return X


def shared_bytes_per_system(n: int, m: int) -> int:
    """Shared memory one system takes in the kernel (odd row stride for A)."""
    return (n * (n | 1) + n * m) * 4


_lib = None


def _kernel():
    global _lib
    if _lib is None:
        from .cuda_build import load

        lib = load("spd_solve")
        lib.qm_spd_solve_f32.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
        lib.qm_spd_solve_f32.restype = ctypes.c_int
        _lib = lib
    return _lib.qm_spd_solve_f32


def spd_solve(A, Y, shift: float = 0.0):
    """Solve (A + shift*I) X = Y for a batch of SPD matrices.

    A: (B, n, n); Y: (B, n, m), both contiguous, same device and dtype.
    CUDA tensors go to the K1 kernel (float32, n <= 64) and
    ``spd_solve.launches`` counts each launch; CPU tensors go to
    :func:`spd_solve_plain`.
    """
    if A.dim() != 3 or Y.dim() != 3 or A.shape[1] != A.shape[2] \
            or Y.shape[:2] != A.shape[:2]:
        raise ValueError(f"spd_solve: shapes {tuple(A.shape)} and {tuple(Y.shape)} "
                         "are not (B,n,n) and (B,n,m)")
    if A.device != Y.device or A.dtype != Y.dtype:
        raise ValueError("spd_solve: A and Y must share device and dtype")
    if not (A.is_contiguous() and Y.is_contiguous()):
        raise ValueError("spd_solve: A and Y must be contiguous")
    if A.device.type == "cpu":
        return spd_solve_plain(A, Y, shift)
    if A.device.type != "cuda":
        raise ValueError(f"spd_solve: no kernel for device {A.device}")
    if A.dtype != torch.float32:
        raise TypeError(f"spd_solve: the CUDA kernel takes float32, not {A.dtype}")
    batch, n, m = Y.shape
    if n > MAX_N:
        raise ValueError(f"spd_solve: n = {n} > {MAX_N}")
    if m < 1:
        raise ValueError("spd_solve: Y has no columns")
    X = torch.empty_like(Y)
    if batch == 0:
        return X
    fn = _kernel()
    with torch.cuda.device(A.device):
        err = fn(A.data_ptr(), Y.data_ptr(), X.data_ptr(), batch, n, m, float(shift),
                 torch.cuda.current_stream(A.device).cuda_stream)
    if err == _CUDA_ERROR_INVALID_VALUE:
        raise ValueError(f"spd_solve: the kernel refused n = {n}, m = {m}: one system "
                         f"needs {shared_bytes_per_system(n, m)} B of shared memory, "
                         "more than a block may hold on this card")
    if err != 0:
        raise RuntimeError(f"spd_solve: kernel launch failed with CUDA error {err}")
    spd_solve.launches += 1
    return X


spd_solve.launches = 0
