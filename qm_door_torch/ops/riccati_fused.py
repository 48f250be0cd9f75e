"""K2: the whole backward Riccati sweep in one launch (port of
``qm_door_tpu/ops/pallas_riccati.py:riccati_backward_fused``).

The CUDA kernel is ``qm_door_torch/csrc/riccati_bwd.cu``: one block per
scenario (128 threads on the ``reg`` and ``reg2`` variants the solver's
paths run, 256 on the ``smem`` variant) keeps the carry (S, s) in shared
memory over the N nodes and writes only K and kff back; the source note has
the bound and the design. The same kernel, compiled without the input symmetrization, is K3c
(``ops/lq.py:riccati_backward_ll``), so the sweep's launch and its plain
version live here and serve both.

The kernel has three variants, which differ only in the Cholesky and solve
of each node's gain (and the shared memory that follows from it), and
:func:`sweep_variant` picks ``reg`` or ``reg2`` from the shape alone:

- ``reg`` (nu <= 32, the solver's 30/30), 128-thread blocks at 3 an SM:
  one warp factors Quu in registers with shuffles (lane i row i, on
  ``csrc/chol_warp.cuh``'s register-lean routines), then solves the nx + 1
  right-hand sides with a column a lane (a second warp for nx + 1 > 32);
  the next node's data is copied (cp.async) into a second set of buffers
  while this node computes;
- ``reg2`` (32 < nu <= 36, the force-tracking width): ``reg``'s block,
  loads and phases; the factoring warp holds rows 0..31 a row a lane and
  rows 32..35 by columns (padded to 36), and the solve runs a column a lane
  at 36; Quu shares L's shared buffer, so 3 blocks an SM still fit at
  30/36;
- ``smem`` (nu <= 36; the first kernel), 256-thread blocks: the whole block
  factors Quu in shared memory with one barrier a pivot. Nothing picks it:
  only ``launch_sweep(..., variant="smem")`` reaches it, to time it beside
  ``reg2`` on the card.

:func:`riccati_backward_fused` launches the chosen variant for CUDA tensors
(contiguous float32, nx, nu <= 36) and raises for anything it cannot take;
nothing is chosen because a build or a launch failed. For CPU tensors it
runs :func:`riccati_backward_fused_plain`, the kernel's arithmetic
(``_ric_bwd_kernel``, inputs symmetrized up front) as torch ops. Each
wrapper counts its launches in ``.launches`` and, by variant, in
``.launches_by_variant``.
"""
from __future__ import annotations

import ctypes

import torch

from .cuda_build import check_launch, count_launch, load, on_cuda
from .spd_solve import spd_solve_plain

MAX_DIM = 36
REG_MAX_NU = 32  # the reg variant holds Quu in one warp, a row a lane
VARIANTS = ("reg", "reg2", "smem")
# the nu each variant takes (nx <= MAX_DIM for all); sweep_variant never picks smem
NU_RANGE = {"reg": (1, REG_MAX_NU), "reg2": (REG_MAX_NU + 1, MAX_DIM), "smem": (1, MAX_DIM)}


def _sym(M):
    return 0.5 * (M + M.transpose(-1, -2))


def _mmT_sym(X, Y):
    """0.5 (X^T Y + Y^T X) for (..., q, p) operands, exactly symmetric (the
    form of ``pallas_riccati._mmT_sym``)."""
    return _sym(X.transpose(-1, -2) @ Y)


def sweep_plain(A, B, d, lx, lu, lxx, luu, lux, lxx_f, lx_f, shift: float, symmetrize: bool):
    """The backward sweep of K2 (``symmetrize=True``) or K3c (``False``) as
    batched torch ops over (Bb, N, ...) tensors. Returns K (Bb,N,nu,nx),
    kff (Bb,N,nu).

    Both form Qxx and Quu in the exactly symmetric product form of
    ``pallas_riccati._mmT_sym``, so the carry S stays symmetric in floating
    point, and read S through S^T, as the TPU kernels do. K2 symmetrizes
    lxx, luu and lxx_f up front; K3c takes them as given and factors Quu
    through its upper triangle (the TPU's ``_chol_t`` reads rows).

    K3c departs from ``pallas_lq._backward_kernel`` in one place: the TPU
    kernel forms Qxx = lxx + A^T (S^T A) without symmetrizing, so the skew
    part of S is carried to the next node through A^T (.) A and grows by
    about |A|^2 a node. In f64 that stays near roundoff (the parity tests
    hold this form to the JAX kernel); in f32 it does not (with |A| ~ 1.1
    over 67 nodes the literal form's K turns NaN,
    ``tests/test_torch_lq_kernels.py``). The two forms are equal in exact
    arithmetic.
    """
    if symmetrize:
        lxx, luu, lxx_f = _sym(lxx), _sym(luu), _sym(lxx_f)
    nx, N = A.shape[-1], A.shape[1]
    S, s = lxx_f, lx_f
    Ks, kffs = [None] * N, [None] * N
    for k in reversed(range(N)):
        Ak, Bk = A[:, k], B[:, k]
        AT, BT, ST = Ak.transpose(-1, -2), Bk.transpose(-1, -2), S.transpose(-1, -2)
        Sd = (ST @ d[:, k, :, None])[..., 0] + s
        Qx = lx[:, k] + (AT @ Sd[..., None])[..., 0]
        Qu = lu[:, k] + (BT @ Sd[..., None])[..., 0]
        SA, SB = ST @ Ak, ST @ Bk
        Qxx = lxx[:, k] + _mmT_sym(Ak, SA)
        Quu = luu[:, k] + _mmT_sym(Bk, SB)
        gain = Quu if symmetrize else Quu.transpose(-1, -2)  # lower triangle = Quu's upper
        Qux = lux[:, k] + BT @ SA
        sol = -spd_solve_plain(gain, torch.cat([Qux, Qu[..., None]], dim=-1), shift)
        K, kff = sol[..., :nx], sol[..., nx]
        S = Qxx + _mmT_sym(Qux, K)
        s = Qx + (Qux.transpose(-1, -2) @ kff[..., None])[..., 0]
        Ks[k], kffs[k] = K, kff
    return torch.stack(Ks, dim=1), torch.stack(kffs, dim=1)


def riccati_backward_fused_plain(A, B, d, lx, lu, lxx, luu, lux, lxx_f, lx_f,
                                 shift: float = 0.0):
    """K2's arithmetic as torch ops (see :func:`sweep_plain`)."""
    return sweep_plain(A, B, d, lx, lu, lxx, luu, lux, lxx_f, lx_f, shift, symmetrize=True)


def check_sweep_shapes(name, A, B, d, lx, lu, lxx, luu, lux, lxx_f, lx_f):
    """Raise ValueError unless the inputs are batch-major sweep data."""
    if B.dim() != 4:
        raise ValueError(f"{name}: B must be (Bb, N, nx, nu), got {tuple(B.shape)}")
    Bb, N, nx, nu = B.shape
    want = {"A": (Bb, N, nx, nx), "d": (Bb, N, nx), "lx": (Bb, N, nx), "lu": (Bb, N, nu),
            "lxx": (Bb, N, nx, nx), "luu": (Bb, N, nu, nu), "lux": (Bb, N, nu, nx),
            "lxx_f": (Bb, nx, nx), "lx_f": (Bb, nx)}
    got = {"A": A, "d": d, "lx": lx, "lu": lu, "lxx": lxx, "luu": luu, "lux": lux,
           "lxx_f": lxx_f, "lx_f": lx_f}
    for key, shape in want.items():
        if tuple(got[key].shape) != shape:
            raise ValueError(f"{name}: {key} has shape {tuple(got[key].shape)}, "
                             f"expected {shape}")
    if N < 1:
        raise ValueError(f"{name}: no nodes")


def sweep_variant(nx: int, nu: int) -> str:
    """The sweep variant for nx states and nu inputs: "reg" for nu <= 32,
    "reg2" for 32 < nu <= 36; ValueError above 36."""
    if nx > MAX_DIM or nu > MAX_DIM:
        raise ValueError(f"sweep: nx = {nx}, nu = {nu}; the kernel takes at most {MAX_DIM}")
    return "reg" if nu <= REG_MAX_NU else "reg2"


PHASE_CLOCKS = "QM_SWEEP_PHASE_CLOCKS"  # the diagnostic build's define
_fns: dict = {}


def kernel_fn(variant: str, defines=()):
    """The C entry point of a sweep variant, from the library built with
    ``defines`` (``(PHASE_CLOCKS,)`` for the per-phase cycle counts)."""
    key = (variant, tuple(defines))
    if key not in _fns:
        fn = getattr(load("riccati_bwd", tuple(defines)), f"qm_riccati_bwd_{variant}_f32")
        fn.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 4 + [
            ctypes.c_float, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fns[key] = fn
    return _fns[key]


def variant_for(name: str, nx: int, nu: int, forced=None) -> str:
    """The variant a launch of (nx, nu) runs: :func:`sweep_variant`'s, or
    ``forced`` where it takes the shape; ValueError otherwise (the C entry
    points refuse the same shapes)."""
    chosen = sweep_variant(nx, nu)  # raises above MAX_DIM
    if forced is None:
        return chosen
    if forced not in VARIANTS:
        raise ValueError(f"{name}: no sweep variant {forced!r}")
    low, high = NU_RANGE[forced]
    if not low <= nu <= high:
        raise ValueError(f"{name}: the {forced} variant takes {low} <= nu <= {high}, "
                         f"not nu = {nu}")
    return forced


def blocks_per_sm(variant: str, nx: int, nu: int, symmetrize: bool = True) -> int:
    """Blocks an SM of a sweep variant's kernel at (nx, nu) on the current
    CUDA device, as cudaOccupancyMaxActiveBlocksPerMultiprocessor counts
    them for its block and shared memory (the normal build)."""
    fn = getattr(load("riccati_bwd"), f"qm_riccati_bwd_{variant}_blocks_per_sm")
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    blocks = ctypes.c_int(0)
    check_launch("sweep occupancy query", fn(nx, nu, int(symmetrize), ctypes.byref(blocks)),
                 f" of nx = {nx}, nu = {nu} ({variant})")
    return blocks.value


def launch_sweep(wrapper, args, shift: float, symmetrize: bool, variant=None):
    """Launch the sweep variant :func:`sweep_variant` names on CUDA tensors
    ``args`` (checked by the caller) and count the launch on
    ``wrapper.launches`` and ``wrapper.launches_by_variant``. ``variant``
    forces one (to time it beside another on the card, ``smem`` among
    them); the wrappers never pass it. A shape the variant does not take
    raises ValueError before anything reaches the card."""
    name = wrapper.__name__
    A, B = args[0], args[1]
    Bb, N, nx, nu = B.shape
    variant = variant_for(name, nx, nu, variant)
    K = torch.empty((Bb, N, nu, nx), dtype=A.dtype, device=A.device)
    kff = torch.empty((Bb, N, nu), dtype=A.dtype, device=A.device)
    if Bb == 0:
        return K, kff
    with torch.cuda.device(A.device):
        err = kernel_fn(variant)(*(t.data_ptr() for t in args), K.data_ptr(), kff.data_ptr(),
                                 Bb, N, nx, nu, float(shift), int(symmetrize),
                                 torch.cuda.current_stream(A.device).cuda_stream, None)
    check_launch(name, err, f" of nx = {nx}, nu = {nu} ({variant})")
    count_launch(wrapper, variant)
    return K, kff


def riccati_backward_fused(A, B, d, lx, lu, lxx, luu, lux, lxx_f, lx_f, shift: float = 0.0):
    """Full backward Riccati sweep in one kernel (K2).

    Batch-major inputs: A (Bb, N, nx, nx), B (Bb, N, nx, nu), d/lx (Bb, N, nx),
    lu (Bb, N, nu), lxx (Bb, N, nx, nx), luu (Bb, N, nu, nu),
    lux (Bb, N, nu, nx), lxx_f (Bb, nx, nx), lx_f (Bb, nx). Returns
    (K (Bb, N, nu, nx), kff (Bb, N, nu)). CUDA tensors launch the variant
    :func:`sweep_variant` picks (counted by ``riccati_backward_fused.launches``
    and ``.launches_by_variant``); CPU tensors run
    :func:`riccati_backward_fused_plain`.
    """
    args = (A, B, d, lx, lu, lxx, luu, lux, lxx_f, lx_f)
    check_sweep_shapes("riccati_backward_fused", *args)
    if not on_cuda("riccati_backward_fused", *args):
        return riccati_backward_fused_plain(*args, shift=shift)
    return launch_sweep(riccati_backward_fused, args, shift, symmetrize=True)


riccati_backward_fused.launches = 0
riccati_backward_fused.launches_by_variant = dict.fromkeys(VARIANTS, 0)


def riccati_backward_fused_lq(plq, shift: float = 0.0):
    """ProjectedLq adapter for :func:`riccati_backward_fused` (a terminal
    cost without a batch axis is broadcast over the scenarios)."""
    Bb = plq.A.shape[0]
    lxx_f = plq.lxx_f.expand(Bb, *plq.lxx_f.shape[-2:]) if plq.lxx_f.dim() == 2 \
        else plq.lxx_f
    lx_f = plq.lx_f.expand(Bb, plq.lx_f.shape[-1]) if plq.lx_f.dim() == 1 else plq.lx_f
    args = (plq.A, plq.B, plq.d, plq.lx, plq.lu, plq.lxx, plq.luu, plq.lux, lxx_f, lx_f)
    return riccati_backward_fused(*(t.contiguous() for t in args), shift=shift)
