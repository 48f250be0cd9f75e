"""K3a-d: the whole LQ stage in four launches (port of
``qm_door_tpu/ops/pallas_lq.py``, backend ``lq_fused``).

- :func:`project_lq` = :func:`project_geom` (K3a, ``_project_geom_kernel``)
  then :func:`project_cost` (K3b, ``_project_cost_kernel``): the Cholesky
  projector of the velocity equalities and its substitution into the
  dynamics and the cost, node by node (``csrc/lq_project.cu``);
- :func:`riccati_backward_ll` (K3c, ``_backward_kernel``): the backward
  sweep, K2's kernel without the input symmetrization
  (``csrc/riccati_bwd.cu``);
- :func:`riccati_forward_ll` (K3d, ``_forward_kernel``): the forward rollout
  with input recovery (``csrc/lq_forward.cu``);
- :func:`solve_lq_batched`: the three in order.

The widths are the TPU kernels' own: nx = nu = 30 (12 forces, 18 joint
velocities), 12 constraint rows. Every function takes and returns
batch-major (B, N, ...) tensors: the TPU's lanes-last layout and its
transposed copies of B and Gv are not carried over. Each wrapper launches
its kernel for CUDA tensors (contiguous float32) and raises for anything it
cannot take; for CPU tensors it runs its ``_plain`` twin, the TPU kernel's
arithmetic as torch ops.
"""
from __future__ import annotations

import ctypes

import torch

from .cuda_build import check_launch, load, on_cuda
from .riccati_fused import VARIANTS as SWEEP_VARIANTS
from .riccati_fused import check_sweep_shapes, launch_sweep, sweep_plain
from .spd_solve import spd_solve_plain

NX = 30
NU = 30  # reduced input dim of the Cholesky projector (12 forces + 18 joints)
NV = 18
NC = 12
# the wrappers' output tails: K3a (A_bar, B_bar, d_bar, p, P, Px_v) and
# K3b (lx, lu, lxx, luu, lux), projected
GEOM_OUT = ((NX, NX), (NX, NU), (NX,), (NU,), (NV, NV), (NV, NX))
COST_OUT = ((NX,), (NU,), (NX, NX), (NU, NU), (NU, NX))


def _tm(X, Y):
    """X^T Y over the last two dims: (..., q, a), (..., q, c) -> (..., a, c)."""
    return X.transpose(-1, -2) @ Y


def _tv(X, v):
    """X^T v: (..., q, a), (..., q) -> (..., a)."""
    return (X.transpose(-1, -2) @ v[..., None])[..., 0]


def _mv(X, v):
    """X v: (..., a, q), (..., q) -> (..., a)."""
    return (X @ v[..., None])[..., 0]


def _eye(n, like):
    return torch.eye(n, dtype=like.dtype, device=like.device)


def _expect(name, lead, pairs):
    for key, t, tail in pairs:
        if tuple(t.shape) != tuple(lead) + tail:
            raise ValueError(f"{name}: {key} has shape {tuple(t.shape)}, "
                             f"expected {tuple(lead) + tail}")


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _ptrs(tensors):
    return [t.data_ptr() for t in tensors]


# the parameters of this module's C entry points, as ctypes types
_ARGTYPES = {
    "qm_lq_project_geom_f32": [ctypes.c_void_p] * 15 + [ctypes.c_longlong]
                              + [ctypes.c_void_p] * 2,
    "qm_lq_project_cost_f32": [ctypes.c_void_p] * 9 + [ctypes.c_float] + [ctypes.c_void_p] * 5
                              + [ctypes.c_longlong] + [ctypes.c_void_p] * 2,
    "qm_lq_forward_f32": [ctypes.c_void_p] * 12 + [ctypes.c_int, ctypes.c_int]
                         + [ctypes.c_void_p] * 2,
    "qm_lq_forward_blocks_per_sm": [ctypes.c_void_p],
}
_fns: dict = {}


def c_entry(source: str, name: str, defines=()):
    """The C entry point ``name`` of ``csrc/<source>.cu`` built with
    ``defines``, bound with its ctypes parameters."""
    key = (name, tuple(defines))
    fn = _fns.get(key)
    if fn is None:
        fn = getattr(load(source, tuple(defines)), name)
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int
        _fns[key] = fn
    return fn


# --- K3a, K3b: the builds of csrc/lq_project.cu --------------------------------

PHASE_CLOCKS = "QM_LQ_PHASE_CLOCKS"        # diagnostic build: cycles a phase
SCALAR_PRODUCTS = "QM_LQ_SCALAR_PRODUCTS"  # measuring build: the scalar-product kernels


def project_fn(kernel: str, defines=()):
    """The C entry point of K3a (``kernel="geom"``) or K3b (``"cost"``) from
    the lq_project library built with ``defines``. The wrappers take the
    normal build; ``(PHASE_CLOCKS,)`` and ``(SCALAR_PRODUCTS,)`` are for
    measuring on the card. Its last arguments are the node count, the
    stream and ``clocks`` (7 int64 or None), written by the phase-clock
    build only; the entry point sizes its grid itself."""
    return c_entry("lq_project", f"qm_lq_project_{kernel}_f32", defines)


# --- K3a: projector geometry + dynamics substitution -------------------------

def project_geom_plain(A, B, d, g0, Gx, Gv, F_bar, act, fm):
    """``_project_geom_kernel`` as torch ops. Returns (A_bar, B_bar, d_bar,
    p, P, Px_v)."""
    lead = Gv.shape[:-2]
    M = Gv @ Gv.transpose(-1, -2) + _eye(NC, Gv) * (1.0 - act)[..., :, None]
    rhs = torch.cat([g0[..., None], Gx, Gv], dim=-1)
    W = spd_solve_plain(M.reshape(-1, NC, NC), rhs.reshape(-1, NC, 1 + NX + NV))
    W = W.reshape(*lead, NC, 1 + NX + NV)
    du_part = -_tv(Gv, W[..., 0])
    Px_v = -_tm(Gv, W[..., 1:1 + NX])
    P = _eye(NV, Gv) - _tm(Gv, W[..., 1 + NX:])
    p = torch.cat([-(1.0 - fm) * F_bar, du_part], dim=-1)
    B_v = B[..., :, NC:]
    A_bar = A + B_v @ Px_v
    B_bar = torch.cat([B[..., :, :NC] * fm[..., None, :], B_v @ P], dim=-1)
    d_bar = d + _mv(B, p)
    return A_bar, B_bar, d_bar, p, P, Px_v


def project_geom(A, B, d, g0, Gx, Gv, F_bar, act, fm):
    """K3a over (B, N) nodes: A, B (B,N,30,30), d (B,N,30), g0 (B,N,12),
    Gx (B,N,12,30), Gv (B,N,12,18), F_bar/act/fm (B,N,12) -> (A_bar, B_bar,
    d_bar, p (B,N,30), P (B,N,18,18), Px_v (B,N,18,30)). Counted by
    ``project_geom.launches``."""
    ins = (A, B, d, g0, Gx, Gv, F_bar, act, fm)
    lead = A.shape[:-2]
    _expect("project_geom", lead, [
        ("A", A, (NX, NX)), ("B", B, (NX, NU)), ("d", d, (NX,)), ("g0", g0, (NC,)),
        ("Gx", Gx, (NC, NX)), ("Gv", Gv, (NC, NV)), ("F_bar", F_bar, (NC,)),
        ("act", act, (NC,)), ("fm", fm, (NC,))])
    if not on_cuda("project_geom", *ins):
        return project_geom_plain(*ins)
    outs = tuple(torch.empty(*lead, *tail, dtype=A.dtype, device=A.device) for tail in GEOM_OUT)
    nodes = A[..., 0, 0].numel()
    if nodes == 0:
        return outs
    with torch.cuda.device(A.device):
        err = project_fn("geom")(*_ptrs(ins + outs), nodes, _stream(A), None)
    check_launch("project_geom", err)
    project_geom.launches += 1
    return outs


project_geom.launches = 0


# --- K3b: cost substitution ---------------------------------------------------

def project_cost_plain(lx, lu, lxx, luu, lux, p, P, Px_v, fm, shift: float = 1e-5):
    """``_project_cost_kernel`` as torch ops (luu read as symmetric, as the
    TPU kernel reads it). Returns (lx, lu, lxx, luu, lux) projected."""
    lu_p = lu + _tv(luu, p)
    lx_b = lx + _tv(Px_v, lu_p[..., NC:]) + _tv(lux, p)
    lu_b = torch.cat([fm * lu_p[..., :NC], _tv(P, lu_p[..., NC:])], dim=-1)
    lux_v = lux[..., NC:, :]
    luu_vF, luu_vv = luu[..., NC:, :NC], luu[..., NC:, NC:]
    lxx_b = lxx + _tm(Px_v, lux_v) + _tm(lux_v, Px_v) + _tm(Px_v, _tm(luu_vv, Px_v))
    fm_r, fm_c = fm[..., :, None], fm[..., None, :]
    top = torch.cat([
        luu[..., :NC, :NC] * fm_r * fm_c + _eye(NC, luu) * ((1.0 - fm)[..., :, None] + shift),
        _tm(luu_vF, P) * fm_r], dim=-1)
    bot = torch.cat([
        _tm(P, luu_vF) * fm_c,
        _tm(_tm(luu_vv, P), P) + (_eye(NV, luu) * (1.0 + shift) - P)], dim=-1)
    term = lux + _tm(luu[..., NC:, :], Px_v)
    lux_b = torch.cat([term[..., :NC, :] * fm_r, _tm(P, term[..., NC:, :])], dim=-2)
    return lx_b, lu_b, lxx_b, torch.cat([top, bot], dim=-2), lux_b


def project_cost(lx, lu, lxx, luu, lux, p, P, Px_v, fm, shift: float = 1e-5):
    """K3b over (B, N) nodes: lx, lu (B,N,30), lxx, luu, lux (B,N,30,30),
    p (B,N,30), P (B,N,18,18), Px_v (B,N,18,30), fm (B,N,12) -> the projected
    (lx, lu, lxx, luu + shift I, lux). Counted by ``project_cost.launches``."""
    ins = (lx, lu, lxx, luu, lux, p, P, Px_v, fm)
    lead = lxx.shape[:-2]
    _expect("project_cost", lead, [
        ("lx", lx, (NX,)), ("lu", lu, (NU,)), ("lxx", lxx, (NX, NX)), ("luu", luu, (NU, NU)),
        ("lux", lux, (NU, NX)), ("p", p, (NU,)), ("P", P, (NV, NV)), ("Px_v", Px_v, (NV, NX)),
        ("fm", fm, (NC,))])
    if not on_cuda("project_cost", *ins):
        return project_cost_plain(*ins, shift=shift)
    outs = tuple(torch.empty(*lead, *tail, dtype=lxx.dtype, device=lxx.device)
                 for tail in COST_OUT)
    nodes = lxx[..., 0, 0].numel()
    if nodes == 0:
        return outs
    with torch.cuda.device(lxx.device):
        err = project_fn("cost")(*_ptrs(ins), float(shift), *_ptrs(outs), nodes, _stream(lxx),
                                 None)
    check_launch("project_cost", err)
    project_cost.launches += 1
    return outs


project_cost.launches = 0


def project_lq_plain(A, B, d, lx, lu, lxx, luu, lux, g0, Gx, Gv, F_bar, act, fm,
                     shift: float = 1e-5):
    """K3a then K3b as torch ops; see :func:`project_lq`."""
    A_bar, B_bar, d_bar, p, P, Px_v = project_geom_plain(A, B, d, g0, Gx, Gv, F_bar, act, fm)
    cost = project_cost_plain(lx, lu, lxx, luu, lux, p, P, Px_v, fm, shift=shift)
    return (A_bar, B_bar, d_bar, *cost, p, P, Px_v)


def project_lq(A, B, d, lx, lu, lxx, luu, lux, g0, Gx, Gv, F_bar, act, fm,
               shift: float = 1e-5):
    """Fused projection + substitution (``pallas_lq.project_lq`` without the
    transposed copies BT, GvT), batch-major. Returns (A_bar, B_bar, d_bar,
    lx, lu, lxx, luu, lux, p, P, Px_v): K3a, then K3b."""
    A_bar, B_bar, d_bar, p, P, Px_v = project_geom(A, B, d, g0, Gx, Gv, F_bar, act, fm)
    cost = project_cost(lx, lu, lxx, luu, lux, p, P, Px_v, fm, shift=shift)
    return (A_bar, B_bar, d_bar, *cost, p, P, Px_v)


# --- K3c: backward sweep -------------------------------------------------------

def riccati_backward_ll_plain(A, B, d, lx, lu, lxx, luu, lux, lxx_f, lx_f):
    """``_backward_kernel`` as torch ops: K2's sweep without the input
    symmetrization (see ``riccati_fused.sweep_plain``)."""
    return sweep_plain(A, B, d, lx, lu, lxx, luu, lux, lxx_f, lx_f, 0.0, symmetrize=False)


def riccati_backward_ll(A, B, d, lx, lu, lxx, luu, lux, lxx_f, lx_f):
    """K3c: backward Riccati sweep over batch-major data (shapes as
    ``riccati_fused.riccati_backward_fused``). Returns (K, kff). CUDA
    tensors launch the variant ``riccati_fused.sweep_variant`` picks, counted
    by ``riccati_backward_ll.launches`` and ``.launches_by_variant``."""
    args = (A, B, d, lx, lu, lxx, luu, lux, lxx_f, lx_f)
    check_sweep_shapes("riccati_backward_ll", *args)
    if not on_cuda("riccati_backward_ll", *args):
        return riccati_backward_ll_plain(*args)
    return launch_sweep(riccati_backward_ll, args, 0.0, symmetrize=False)


riccati_backward_ll.launches = 0
riccati_backward_ll.launches_by_variant = dict.fromkeys(SWEEP_VARIANTS, 0)


# --- K3d: forward rollout + input recovery --------------------------------------

FWD_PHASE_CLOCKS = "QM_FWD_PHASE_CLOCKS"  # diagnostic build: cycles a phase


def forward_fn(defines=()):
    """The C entry point of K3d from the lq_forward library built with
    ``defines``. The wrapper takes the normal build; ``(FWD_PHASE_CLOCKS,)``
    and ``("QM_FWD_ROW_WARPS",)`` (the PR 2 kernel) are for measuring on
    the card. Its last arguments are the batch, N, the stream and
    ``clocks`` (6 int64 or None), written by the phase-clock build only."""
    return c_entry("lq_forward", "qm_lq_forward_f32", defines)

def riccati_forward_ll_plain(A, B, d, K, kff, p, P, Px_v, fm, dx0):
    """``_forward_kernel`` as torch ops. Returns (dX (B,N+1,30), dU (B,N,30))."""
    dx = dx0
    dXs, dUs = [], []
    for k in range(A.shape[1]):
        u_red = kff[:, k] + _mv(K[:, k], dx)
        du_F = p[:, k, :NC] + fm[:, k] * u_red[..., :NC]
        du_V = p[:, k, NC:] + _mv(P[:, k], u_red[..., NC:]) + _mv(Px_v[:, k], dx)
        dXs.append(dx)
        dUs.append(torch.cat([du_F, du_V], dim=-1))
        dx = _mv(A[:, k], dx) + _mv(B[:, k], u_red) + d[:, k]
    dXs.append(dx)
    return torch.stack(dXs, dim=1), torch.stack(dUs, dim=1)


def riccati_forward_ll(A, B, d, K, kff, p, P, Px_v, fm, dx0):
    """K3d: A, B, K (B,N,30,30), d, kff, p (B,N,30), P (B,N,18,18),
    Px_v (B,N,18,30), fm (B,N,12), dx0 (B,30) -> (dX (B,N+1,30),
    dU (B,N,30)). Counted by ``riccati_forward_ll.launches``."""
    ins = (A, B, d, K, kff, p, P, Px_v, fm, dx0)
    if A.dim() != 4:
        raise ValueError(f"riccati_forward_ll: A must be (B, N, 30, 30), got {tuple(A.shape)}")
    Bb, N = A.shape[:2]
    _expect("riccati_forward_ll", (Bb, N), [
        ("A", A, (NX, NX)), ("B", B, (NX, NU)), ("d", d, (NX,)), ("K", K, (NU, NX)),
        ("kff", kff, (NU,)), ("p", p, (NU,)), ("P", P, (NV, NV)), ("Px_v", Px_v, (NV, NX)),
        ("fm", fm, (NC,))])
    _expect("riccati_forward_ll", (Bb,), [("dx0", dx0, (NX,))])
    if N < 1:
        raise ValueError("riccati_forward_ll: no nodes")
    if not on_cuda("riccati_forward_ll", *ins):
        return riccati_forward_ll_plain(*ins)
    dX = torch.empty(Bb, N + 1, NX, dtype=A.dtype, device=A.device)
    dU = torch.empty(Bb, N, NU, dtype=A.dtype, device=A.device)
    if Bb == 0:
        return dX, dU
    with torch.cuda.device(A.device):
        err = forward_fn()(*_ptrs(ins + (dX, dU)), Bb, N, _stream(A), None)
    check_launch("riccati_forward_ll", err)
    riccati_forward_ll.launches += 1
    return dX, dU


riccati_forward_ll.launches = 0


# --- the whole LQ stage ----------------------------------------------------------

def _solve(lq, act, fm, F_bar, dx0, shift, project, backward, forward):
    c = lambda t: t.contiguous()  # noqa: E731
    A_bar, B_bar, d_bar, lxb, lub, lxxb, luub, luxb, p, P, Px_v = project(
        *map(c, (lq.A, lq.B, lq.d, lq.lx, lq.lu, lq.lxx, lq.luu, lq.lux, lq.g0, lq.Gx,
                 lq.Gv, F_bar, act, fm)), shift=shift)
    K, kff = backward(A_bar, B_bar, d_bar, lxb, lub, lxxb, luub, luxb, c(lq.lxx_f),
                      c(lq.lx_f))
    return forward(A_bar, B_bar, d_bar, K, kff, p, P, Px_v, c(fm), c(dx0))


def solve_lq_batched(lq, act, fm, F_bar, dx0, shift: float = 1e-5):
    """Full projected-LQ solve for a batch of scenarios (K3a, K3b, K3c, K3d).

    lq: LqProblem with leading (B, N, ...) axes (``linearize_ocp``'s output).
    act/fm: (B, N, 12) row/force masks; F_bar (B, N, 12); dx0 (B, 30).
    Returns (dX (B, N+1, 30), dU (B, N, 30)).
    """
    return _solve(lq, act, fm, F_bar, dx0, shift, project_lq, riccati_backward_ll,
                  riccati_forward_ll)


def solve_lq_batched_plain(lq, act, fm, F_bar, dx0, shift: float = 1e-5):
    """:func:`solve_lq_batched` through the plain twins on any device."""
    return _solve(lq, act, fm, F_bar, dx0, shift, project_lq_plain,
                  riccati_backward_ll_plain, riccati_forward_ll_plain)
