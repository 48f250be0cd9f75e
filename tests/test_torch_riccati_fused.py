"""K2 (qm_door_torch/ops/riccati_fused.py): the plain version and the
``fused`` Riccati backend against the JAX kernel
(``pallas_riccati.riccati_backward_fused_lq``) in interpret mode at
(5, 9, 7, 4), the smallest shape (it runs the kernel's every path: the
node loop, the symmetrized loads, the shift), and against the kernel's XLA
reference (``riccati.riccati_backward_batched(backend="xla")``, which JAX's
tests/test_pallas_ops.py holds the kernel to) at the production widths,
float64 on the CPU, on the data recipe of tests/test_pallas_ops.py. Bars:
1e-10 at (5, 9, 7, 4), 1e-8 at the production widths (the JAX test's own).
The CUDA kernel is held against the plain version on the card by
chip_smoke.py."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qm_door_torch import convert
from qm_door_torch.ops import riccati_fused as rf
from qm_door_torch.solver.riccati import lqr_solve_batched
from qm_door_tpu.ops.pallas_riccati import riccati_backward_fused_lq as j_fused
from qm_door_tpu.solver.riccati import riccati_backward_batched as j_backward
from qm_door_tpu.solver.riccati import riccati_forward_batched as j_forward
from qm_door_tpu.solver.transcription import ProjectedLq as JProjectedLq
from torch_parity import as_numpy_fields, to_np
from torch_parity import release_jax_executables  # noqa: F401 (autouse, module scope)

# (Bb, N, nx, nu) -> tolerance
SHAPES = {(5, 9, 7, 4): 1e-10, (3, 11, 30, 30): 1e-8, (2, 5, 30, 36): 1e-8}


def _random_plq(shape, structured=False):
    """test_pallas_ops._random_lq's recipe; with ``structured`` (nu = 30)
    also a projector recovery (p, P, Px_v, force_mask) for the forward
    sweep."""
    Bb, N, nx, nu = shape
    rng = np.random.default_rng(sum(shape))

    def spd(*s):
        M = rng.normal(size=s + (s[-1],)) * 0.3
        return M @ np.swapaxes(M, -1, -2) + 2.0 * np.eye(s[-1])

    f = dict(
        A=rng.normal(size=(Bb, N, nx, nx)) * 0.2 + np.eye(nx),
        B=rng.normal(size=(Bb, N, nx, nu)) * 0.3,
        d=rng.normal(size=(Bb, N, nx)) * 0.1,
        lx=rng.normal(size=(Bb, N, nx)),
        lu=rng.normal(size=(Bb, N, nu)),
        lxx=spd(Bb, N, nx), luu=spd(Bb, N, nu),
        lux=rng.normal(size=(Bb, N, nu, nx)) * 0.2,
        lxx_f=spd(Bb, nx), lx_f=rng.normal(size=(Bb, nx)),
        p=np.zeros((Bb, N, nu)), Pu=None, Px=None)
    if structured:
        Q, _ = np.linalg.qr(rng.normal(size=(Bb, N, 18, 18)))
        f.update(p=rng.normal(size=(Bb, N, nu)) * 0.1,
                 P=Q[..., :12] @ np.swapaxes(Q[..., :12], -1, -2),
                 Px_v=rng.normal(size=(Bb, N, 18, nx)) * 0.1,
                 force_mask=rng.integers(0, 2, size=(Bb, N, 12)).astype(float))
    return JProjectedLq(**{k: None if v is None else jnp.asarray(v) for k, v in f.items()})


def _port(jlq):
    return convert.projected_lq_from_numpy(as_numpy_fields(jlq), device="cpu")


def _args(plq):
    return (plq.A, plq.B, plq.d, plq.lx, plq.lu, plq.lxx, plq.luu, plq.lux, plq.lxx_f,
            plq.lx_f)


INTERPRET_SHAPE = (5, 9, 7, 4)


@functools.lru_cache(maxsize=None)
def _case(shape):
    """(JAX data, its torch copy, JAX's K and kff): K2 in interpret mode at
    INTERPRET_SHAPE, its XLA reference at the production widths; one run a
    shape, shared by the tests of this module."""
    jlq = _random_plq(shape, structured=shape[-1] == 30)
    if shape == INTERPRET_SHAPE:
        K, kff = j_fused(jlq, interpret=True)
    else:
        K, kff = jax.jit(lambda lq: j_backward(lq, backend="xla"))(jlq)
    return jlq, _port(jlq), np.asarray(K), np.asarray(kff)


@pytest.mark.parametrize("shape", list(SHAPES), ids=lambda s: "x".join(map(str, s)))
def test_plain_matches_jax_kernel(shape):
    _, plq, K, kff = _case(shape)
    tol = SHAPES[shape]
    Kt, kfft = rf.riccati_backward_fused_plain(*_args(plq))
    np.testing.assert_allclose(to_np(Kt), K, rtol=tol, atol=tol)
    np.testing.assert_allclose(to_np(kfft), kff, rtol=tol, atol=tol)


@pytest.mark.parametrize("shape", list(SHAPES), ids=lambda s: "x".join(map(str, s)))
def test_cpu_wrapper_is_the_plain_version_without_a_launch(shape):
    _, plq, _, _ = _case(shape)
    before = rf.riccati_backward_fused.launches
    for a, b in zip(rf.riccati_backward_fused_lq(plq),
                    rf.riccati_backward_fused_plain(*_args(plq))):
        assert torch.equal(a, b)
    assert rf.riccati_backward_fused.launches == before


def test_fused_backend_matches_jax():
    """lqr_solve_batched(backend="fused") against JAX's fused backend at
    nu = 30: JAX's backward gains (the shared run: K2's XLA reference), then
    JAX's batch-major forward sweep, which is what its
    ``lqr_solve_batched(backend="fused")`` runs after K2. The port's K1 scan
    solves the same problem."""
    shape = (3, 11, 30, 30)
    jlq, plq, K, kff = _case(shape)
    dx0 = np.random.default_rng(1).normal(size=(shape[0], shape[2])) * 0.1
    dXj, dUj = j_forward(jlq, jnp.asarray(K), jnp.asarray(kff), jnp.asarray(dx0))
    out = lqr_solve_batched(plq, torch.as_tensor(dx0), backend="fused")
    for name, a, b in zip(("dX", "dU", "K", "kff"), out, (dXj, dUj, K, kff)):
        np.testing.assert_allclose(to_np(a), np.asarray(b), rtol=1e-8, atol=1e-8, err_msg=name)
    for name, a, b in zip(("dX", "dU"), out, lqr_solve_batched(plq, torch.as_tensor(dx0))):
        np.testing.assert_allclose(to_np(a), to_np(b), rtol=1e-8, atol=1e-8, err_msg=name)


def test_shift_matches_jax():
    jlq = _random_plq((5, 9, 7, 4))
    K, kff = j_fused(jlq, shift=1e-3, interpret=True)
    Kt, kfft = rf.riccati_backward_fused_plain(*_args(_port(jlq)), shift=1e-3)
    np.testing.assert_allclose(to_np(Kt), np.asarray(K), rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(to_np(kfft), np.asarray(kff), rtol=1e-10, atol=1e-10)


def test_unbatched_terminal_cost_is_broadcast():
    plq = _port(_random_plq((3, 4, 6, 5)))
    one = type(plq)(**{**vars(plq), "lxx_f": plq.lxx_f[0], "lx_f": plq.lx_f[0]})
    K, kff = rf.riccati_backward_fused_lq(one)
    Kr, kffr = rf.riccati_backward_fused_plain(
        *_args(plq)[:8], plq.lxx_f[:1].expand(3, 6, 6), plq.lx_f[:1].expand(3, 6))
    assert torch.equal(K, Kr) and torch.equal(kff, kffr)


@pytest.mark.parametrize("bad", ["A", "lux", "lxx_f", "rank", "no_nodes"])
def test_wrapper_rejects_bad_shapes(bad):
    args = list(_args(_port(_random_plq((2, 3, 4, 3)))))
    if bad == "A":
        args[0] = args[0][..., :3]
    elif bad == "lux":
        args[7] = args[7].transpose(-1, -2)
    elif bad == "lxx_f":
        args[8] = args[8][0]
    elif bad == "rank":
        args[1] = args[1][0]
    else:
        args = [a[:, :0] for a in args[:8]] + args[8:]
    with pytest.raises(ValueError):
        rf.riccati_backward_fused(*args)


def test_unknown_riccati_backend_raises():
    plq = _port(_random_plq((2, 3, 30, 30), structured=True))
    with pytest.raises(ValueError, match="backend"):
        lqr_solve_batched(plq, torch.zeros(2, 30, dtype=torch.float64), backend="scan")


@pytest.mark.parametrize("field", ["Pu", "Px", "grasp_gate"])
def test_converter_carries_either_recovery_form(field):
    """The dense recovery maps of the per-scenario path and the force-tracking
    gate come across as given."""
    d = as_numpy_fields(_random_plq((2, 3, 4, 3)))
    d[field] = np.random.default_rng(len(field)).normal(size=(2, 3, 4, 3))
    plq = convert.projected_lq_from_numpy(d, device="cpu")
    np.testing.assert_array_equal(getattr(plq, field).numpy(), d[field])
    assert getattr(plq, field).dtype == torch.float64
