"""K1: batched small SPD solve, X = (A + shift*I)^-1 Y.

Replaces the Pallas TPU kernel ``qm_door_tpu/ops/pallas_chol.py:spd_solve``
(``_spd_kernel``). The CUDA source is ``qm_door_torch/csrc/spd_solve.cu``
with the warp routines of ``csrc/chol_warp.cuh``; :func:`k1_variant` picks
one of four variants from the shape alone:

- ``reg16`` (n <= 16) and ``reg32`` (n <= 32), both for m <= 64
  (:data:`REG_MAX_M`, two right-hand-side columns a lane): one warp a
  system, held in registers. Lane i factors row i with shuffles, lane c
  solves column c. The main path's two shapes take them: the projection
  (25728 x 12 x 49, bytes-bound; reg16 walks the batch and stages the
  next system while it solves this one) and the Riccati gain (384 x 30 x
  31, latency-bound; reg32 gives each system its own warp).
- ``reg64`` (every other n <= 64: 32 < n, or m > 64): one warp a system,
  two rows a lane in registers (padded to 48 or 64), the factor's columns
  moved by shuffles. At m = 1 (the WBC's Newton solves, 36 / 42 x 1) the
  right-hand side stays held by rows and each substitution step is one
  shuffle and two FMAs; at m > 1 (the nu = 36 gain, 36 x 31; the WBC's Gram
  solves, 52 x 36, 36 / 58 x 42) the columns go over lanes, 32 at a time.
  Latency-bound: one system's chain is the kernel's time.
- ``blk128`` (64 < n <= :data:`MAX_N` = 128): a block of 8 warps a system, a
  blocked Cholesky with 32-column panels in shared memory, the
  substitutions a right-hand side a warp. Only the stacked interior-point
  systems of ``wbc/qp.py:solve_qp_batched`` (n + nv up to 92, m = 1, a test
  reference) reach it.

A fifth, ``smem``, is PR 1's kernel: :func:`k1_variant` never names it, and
it runs only when ``_variant="smem"`` forces it, to be timed in turns
against the variants that replaced it (``chip_smoke.py`` (a)).

All read only the lower triangle of A (both solver call sites pass exactly
symmetric matrices) and use the pivots rsqrt(max(a_kk, 1e-30)); the source
note has the design and what bounds each shape.

:func:`spd_solve` launches the chosen variant for CUDA tensors (f32,
n <= 128) and raises for anything it cannot take (n > 128, or a system too
large for the variant's shared memory, which since reg64 and blk128 read
the right-hand sides past 64 columns from device memory only the forced
``smem`` variant can meet); nothing is chosen because a build or a launch
failed, and no system is ever run short. CPU tensors run
:func:`spd_solve_plain`, the same algorithm as batched torch ops.
:func:`spd_solve_ll` (K1-ll) is the same solve on lanes-last arrays,
through the same dispatch with other strides. Each wrapper counts its
launches in ``.launches``, by variant in ``.launches_by_variant`` and by
(batch, n, m) in ``.launches_by_shape``.
"""
from __future__ import annotations

import ctypes

import torch

from .cuda_build import check_launch, load, on_cuda

MAX_N = 128


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
    """Shared memory one system takes in the smem variant (odd row stride for A)."""
    return (n * (n | 1) + n * m) * 4


REG_MAX_M = 64  # reg16 / reg32 keep at most two columns a lane
REG64_MAX_N = 64  # reg64: two rows a lane
# the variants k1_variant names, then PR 1's kernel (only ever forced)
VARIANTS = ("reg16", "reg32", "reg64", "blk128", "smem")


def k1_variant(n: int, m: int) -> str:
    """The K1 variant for systems of n x n with m right-hand sides: "reg16"
    for n <= 16, "reg32" for 16 < n <= 32, both only for m <= 64; "reg64"
    for the rest of n <= 64; "blk128" for 64 < n (<= MAX_N = 128)."""
    if m <= REG_MAX_M:
        if n <= 16:
            return "reg16"
        if n <= 32:
            return "reg32"
    if n <= REG64_MAX_N:
        return "reg64"
    return "blk128"


# every variant's C entry point has this signature: A, Y, X, batch, n, m,
# shift, sys_a, sys_y, elem, stream
ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
            ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,
            ctypes.c_void_p]
_fns: dict = {}


def entry_point(variant: str) -> str:
    """The name of a variant's C entry point in ``csrc/spd_solve.cu``."""
    return f"qm_spd_solve_{variant}_f32"


def kernel_fn(variant: str, defines=()):
    """The C entry point of a K1 variant, from the library built with
    ``defines`` (another launch shape of the reg variants, to measure it:
    ``k1_launch_shapes.py`` at the repository root)."""
    key = (variant, tuple(defines))
    if key not in _fns:
        fn = getattr(load("spd_solve", tuple(defines)), entry_point(variant))
        fn.argtypes = ARGTYPES
        fn.restype = ctypes.c_int
        _fns[key] = fn
    return _fns[key]


def _launch(wrapper, variant, A, Y, X, batch, n, m, shift, strides):
    """Launch ``variant`` on CUDA tensors (checked by the caller) and count
    it on ``wrapper``."""
    name = wrapper.__name__
    with torch.cuda.device(A.device):
        err = kernel_fn(variant)(A.data_ptr(), Y.data_ptr(), X.data_ptr(), batch, n, m,
                                 float(shift), *strides,
                                 torch.cuda.current_stream(A.device).cuda_stream)
    if err:
        what = f" of n = {n}, m = {m} ({variant})"
        if variant == "smem":
            what += (f": one system needs {shared_bytes_per_system(n, m)} B of shared "
                     "memory, more than a block may hold on this card")
        else:
            what += ": a shape the variant does not take, or more shared memory than a block"
            what += " may hold on this card"
        check_launch(name, err, what)
    wrapper.launches += 1
    wrapper.launches_by_variant[variant] += 1
    shape = (batch, n, m)
    wrapper.launches_by_shape[shape] = wrapper.launches_by_shape.get(shape, 0) + 1


def _variant_for(name, n, m, forced):
    if n > MAX_N:
        raise ValueError(f"{name}: n = {n} > {MAX_N}")
    if m < 1:
        raise ValueError(f"{name}: no right-hand-side columns")
    if forced is None:
        return k1_variant(n, m)
    if forced not in VARIANTS:
        raise ValueError(f"{name}: no K1 variant {forced!r}")
    return forced  # the C entry point refuses a shape the variant does not take


def spd_solve(A, Y, shift: float = 0.0, _variant=None):
    """Solve (A + shift*I) X = Y for a batch of SPD matrices.

    A: (B, n, n); Y: (B, n, m), both contiguous, same device and dtype.
    CUDA tensors go to the K1 variant :func:`k1_variant` picks (float32,
    n <= 128), counted in ``spd_solve.launches``,
    ``spd_solve.launches_by_variant`` and ``spd_solve.launches_by_shape``;
    CPU tensors go to :func:`spd_solve_plain`. ``_variant`` forces a
    variant (to time one beside another on the card, PR 1's ``smem``
    kernel among them); the solver never passes it.
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
    variant = _variant_for("spd_solve", n, m, _variant)
    X = torch.empty_like(Y)
    if batch == 0:
        return X
    _launch(spd_solve, variant, A, Y, X, batch, n, m, shift, (n * n, n * m, 1))
    return X


spd_solve.launches = 0
spd_solve.launches_by_variant = dict.fromkeys(VARIANTS, 0)
spd_solve.launches_by_shape = {}


def spd_solve_ll(At, Yt, shift: float = 0.0):
    """K1-ll: the same solve on lanes-last arrays (port of
    ``pallas_chol.py:spd_solve_ll``): At (n, n, B), Yt (n, m, B) -> (n, m, B).

    CUDA tensors (contiguous float32, n <= 128, any B) enter the variant
    :func:`k1_variant` picks with batch stride 1 and element stride B,
    counted in ``spd_solve_ll.launches``, ``.launches_by_variant`` and
    ``.launches_by_shape``; CPU tensors take :func:`spd_solve_plain` on the
    batch-major views.
    """
    if At.dim() != 3 or Yt.dim() != 3 or At.shape[0] != At.shape[1] \
            or Yt.shape[0] != At.shape[0] or Yt.shape[2] != At.shape[2]:
        raise ValueError(f"spd_solve_ll: shapes {tuple(At.shape)} and {tuple(Yt.shape)} "
                         "are not (n,n,B) and (n,m,B)")
    if not on_cuda("spd_solve_ll", At, Yt):
        X = spd_solve_plain(At.permute(2, 0, 1), Yt.permute(2, 0, 1), shift)
        return X.permute(1, 2, 0).contiguous()
    n, m, batch = Yt.shape
    variant = _variant_for("spd_solve_ll", n, m, None)
    Xt = torch.empty_like(Yt)
    if batch == 0:
        return Xt
    _launch(spd_solve_ll, variant, At, Yt, Xt, batch, n, m, shift, (1, 1, batch))
    return Xt


spd_solve_ll.launches = 0
spd_solve_ll.launches_by_variant = dict.fromkeys(VARIANTS, 0)
spd_solve_ll.launches_by_shape = {}
