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
:func:`spd_solve_ll` (K1-ll) is the same kernel on lanes-last arrays,
entered with other strides.
"""
from __future__ import annotations

import ctypes

import torch

from .cuda_build import check_launch, load, on_cuda

MAX_N = 64


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


def _lib_fn(name):
    global _lib
    if _lib is None:
        lib = load("spd_solve")
        for fn in (lib.qm_spd_solve_f32, lib.qm_spd_solve_ll_f32):
            fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                           ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
                           ctypes.c_void_p]
            fn.restype = ctypes.c_int
        _lib = lib
    return getattr(_lib, name)


def _launch(name, fn, A, Y, X, batch, n, m, shift):
    with torch.cuda.device(A.device):
        err = _lib_fn(fn)(A.data_ptr(), Y.data_ptr(), X.data_ptr(), batch, n, m, float(shift),
                          torch.cuda.current_stream(A.device).cuda_stream)
    check_launch(name, err, f" of n = {n}, m = {m}: one system needs "
                 f"{shared_bytes_per_system(n, m)} B of shared memory, more than a "
                 "block may hold on this card")


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
    if not (A.is_contiguous() and Y.is_contiguous()):
        raise ValueError("spd_solve: A and Y must be contiguous")
    if not on_cuda("spd_solve", A, Y):
        return spd_solve_plain(A, Y, shift)
    batch, n, m = Y.shape
    if n > MAX_N:
        raise ValueError(f"spd_solve: n = {n} > {MAX_N}")
    if m < 1:
        raise ValueError("spd_solve: Y has no columns")
    X = torch.empty_like(Y)
    if batch == 0:
        return X
    _launch("spd_solve", "qm_spd_solve_f32", A, Y, X, batch, n, m, shift)
    spd_solve.launches += 1
    return X


spd_solve.launches = 0


def spd_solve_ll(At, Yt, shift: float = 0.0):
    """K1-ll: the same solve on lanes-last arrays (port of
    ``pallas_chol.py:spd_solve_ll``): At (n, n, B), Yt (n, m, B) -> (n, m, B).

    CUDA tensors (contiguous float32, n <= 64, any B) enter the K1 kernel
    with batch stride 1 and element stride B, counted by
    ``spd_solve_ll.launches``; CPU tensors take :func:`spd_solve_plain` on
    the batch-major views.
    """
    if At.dim() != 3 or Yt.dim() != 3 or At.shape[0] != At.shape[1] \
            or Yt.shape[0] != At.shape[0] or Yt.shape[2] != At.shape[2]:
        raise ValueError(f"spd_solve_ll: shapes {tuple(At.shape)} and {tuple(Yt.shape)} "
                         "are not (n,n,B) and (n,m,B)")
    if not on_cuda("spd_solve_ll", At, Yt):
        X = spd_solve_plain(At.permute(2, 0, 1), Yt.permute(2, 0, 1), shift)
        return X.permute(1, 2, 0).contiguous()
    n, m, batch = Yt.shape
    if n > MAX_N:
        raise ValueError(f"spd_solve_ll: n = {n} > {MAX_N}")
    if m < 1:
        raise ValueError("spd_solve_ll: Yt has no columns")
    Xt = torch.empty_like(Yt)
    if batch == 0:
        return Xt
    _launch("spd_solve_ll", "qm_spd_solve_ll_f32", At, Yt, Xt, batch, n, m, shift)
    spd_solve_ll.launches += 1
    return Xt


spd_solve_ll.launches = 0
