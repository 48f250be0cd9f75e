"""K3a-d (qm_door_torch/ops/lq.py): each plain function and the whole LQ
stage against the JAX kernels of ``qm_door_tpu/ops/pallas_lq.py`` in
interpret mode, float64 on the CPU, on tests/test_pallas_lq.py's data
recipe and at that file's tolerances. JAX works lanes-last (N, r, c, B);
its outputs are transposed to the port's batch-major (B, N, r, c) here. The
CUDA kernels are held against the plain versions on the card by
chip_smoke.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qm_door_torch import convert
from qm_door_torch.ops import lq as tl
from qm_door_tpu.ocp import constraints as cons
from qm_door_tpu.ops import pallas_lq as pk
from test_pallas_lq import BT, SHIFT, B, N, _random_lq
from torch_parity import as_numpy_fields, to_np
from torch_parity import release_jax_executables  # noqa: F401 (autouse, module scope)

PROJ = ("A_bar", "B_bar", "d_bar", "lx", "lu", "lxx", "luu", "lux", "p", "P", "Px_v")
# test_pallas_lq.py's bars: geometry at atol 1e-10, cost terms at 1e-8
PROJ_ATOL = dict(A_bar=1e-10, B_bar=1e-10, d_bar=1e-10, p=1e-10, P=1e-10, Px_v=1e-10)


def _bm(x):
    """Lanes-last (N, r[, c], B) -> batch-major (B, N, r[, c]) numpy."""
    x = np.asarray(x)
    return np.moveaxis(x, -1, 0)


def _ll(x):
    """Batch-major (B, N, r[, c]) -> lanes-last (N, r[, c], B)."""
    return jnp.moveaxis(jnp.asarray(x), 0, -1)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(7)
    lqs, flags, Us, dx0s = [], [], [], []
    for _ in range(B):
        lq, f = _random_lq(rng, N)
        lqs.append(lq)
        flags.append(f)
        Us.append(rng.normal(size=(N, 30)))
        dx0s.append(0.1 * rng.normal(size=30))
    lq_b = jax.tree.map(lambda *xs: jnp.stack(xs), *lqs)
    flags = jnp.stack(flags)
    U, dx0 = np.stack(Us), np.stack(dx0s)
    act = np.asarray(cons.velocity_row_mask(flags))
    fm = np.asarray(jnp.repeat(flags, 3, axis=-1))
    t = lambda a: torch.as_tensor(np.array(a))  # noqa: E731
    return dict(j_lq=lq_b, t_lq=convert.lq_from_numpy(as_numpy_fields(lq_b), device="cpu"),
                act=act, fm=fm, F_bar=U[:, :, :12], dx0=dx0,
                t_act=t(act), t_fm=t(fm), t_F_bar=t(U[:, :, :12]), t_dx0=t(dx0))


@pytest.fixture(scope="module")
def j_proj(data):
    """JAX project_lq (K3a + K3b), lanes-last outputs."""
    lq = data["j_lq"]
    T = lambda x: jnp.transpose(x, (1, 3, 2, 0))  # noqa: E731  transposed operand
    return pk.project_lq(
        _ll(lq.A), _ll(lq.B), T(lq.B), _ll(lq.d), _ll(lq.lx), _ll(lq.lu), _ll(lq.lxx),
        _ll(lq.luu), _ll(lq.lux), _ll(lq.g0), _ll(lq.Gx), _ll(lq.Gv), T(lq.Gv),
        _ll(data["F_bar"]), _ll(data["act"]), _ll(data["fm"]), shift=SHIFT, interpret=True,
        batch_tile=BT)


@pytest.fixture(scope="module")
def j_sweeps(data, j_proj):
    """JAX riccati_backward_ll then riccati_forward_ll on JAX's projection
    (the chain of solve_lq_batched), lanes-last."""
    A, Bb, d, lx, lu, lxx, luu, lux, p, P, Px_v = j_proj
    lq = data["j_lq"]
    K, kff = pk.riccati_backward_ll(A, Bb, d, lx, lu, lxx, luu, lux, _ll(lq.lxx_f),
                                    _ll(lq.lx_f), interpret=True, batch_tile=BT)
    dX, dU = pk.riccati_forward_ll(A, Bb, d, K, kff, p, P, Px_v, _ll(data["fm"]),
                                   _ll(data["dx0"]), interpret=True, batch_tile=BT)
    return K, kff, dX, dU


@pytest.fixture(scope="module")
def t_proj(data):
    lq = data["t_lq"]
    return tl.project_lq_plain(lq.A, lq.B, lq.d, lq.lx, lq.lu, lq.lxx, lq.luu, lq.lux, lq.g0,
                               lq.Gx, lq.Gv, data["t_F_bar"], data["t_act"], data["t_fm"],
                               shift=SHIFT)


@pytest.mark.parametrize("field", PROJ)
def test_project_lq_matches_jax(j_proj, t_proj, field):
    i = PROJ.index(field)
    np.testing.assert_allclose(to_np(t_proj[i]), _bm(j_proj[i]), rtol=1e-8,
                               atol=PROJ_ATOL.get(field, 1e-8), err_msg=field)


def test_project_lq_on_cpu_is_the_plain_version(data, t_proj):
    lq = data["t_lq"]
    before = (tl.project_geom.launches, tl.project_cost.launches)
    out = tl.project_lq(lq.A, lq.B, lq.d, lq.lx, lq.lu, lq.lxx, lq.luu, lq.lux, lq.g0, lq.Gx,
                        lq.Gv, data["t_F_bar"], data["t_act"], data["t_fm"], shift=SHIFT)
    assert all(torch.equal(a, b) for a, b in zip(out, t_proj))
    assert (tl.project_geom.launches, tl.project_cost.launches) == before


def _t_proj_from_jax(j_proj):
    return [torch.as_tensor(_bm(x)) for x in j_proj]


def test_backward_ll_matches_jax(data, j_proj, j_sweeps):
    A, Bb, d, lx, lu, lxx, luu, lux, _, _, _ = _t_proj_from_jax(j_proj)
    lq = data["t_lq"]
    K, kff = tl.riccati_backward_ll_plain(A, Bb, d, lx, lu, lxx, luu, lux, lq.lxx_f, lq.lx_f)
    np.testing.assert_allclose(to_np(K), _bm(j_sweeps[0]), rtol=1e-7, atol=1e-8)
    np.testing.assert_allclose(to_np(kff), _bm(j_sweeps[1]), rtol=1e-7, atol=1e-8)
    before = tl.riccati_backward_ll.launches
    Kw, kffw = tl.riccati_backward_ll(A, Bb, d, lx, lu, lxx, luu, lux, lq.lxx_f, lq.lx_f)
    assert torch.equal(Kw, K) and torch.equal(kffw, kff)
    assert tl.riccati_backward_ll.launches == before


def test_forward_ll_matches_jax(data, j_proj, j_sweeps):
    A, Bb, d, _, _, _, _, _, p, P, Px_v = _t_proj_from_jax(j_proj)
    K, kff = (torch.as_tensor(_bm(x)) for x in j_sweeps[:2])
    args = (A, Bb, d, K, kff, p, P, Px_v, data["t_fm"], data["t_dx0"])
    dX, dU = tl.riccati_forward_ll_plain(*args)
    np.testing.assert_allclose(to_np(dX), _bm(j_sweeps[2]), rtol=1e-8, atol=1e-9)
    np.testing.assert_allclose(to_np(dU), _bm(j_sweeps[3]), rtol=1e-8, atol=1e-9)
    before = tl.riccati_forward_ll.launches
    dXw, dUw = tl.riccati_forward_ll(*args)
    assert torch.equal(dXw, dX) and torch.equal(dUw, dU)
    assert tl.riccati_forward_ll.launches == before


def test_solve_lq_batched_matches_jax(data):
    dXj, dUj = pk.solve_lq_batched(
        data["j_lq"], jnp.asarray(data["act"]), jnp.asarray(data["fm"]),
        jnp.asarray(data["F_bar"]), jnp.asarray(data["dx0"]), shift=SHIFT, interpret=True,
        batch_tile=BT)
    dX, dU = tl.solve_lq_batched(data["t_lq"], data["t_act"], data["t_fm"], data["t_F_bar"],
                                 data["t_dx0"], shift=SHIFT)
    np.testing.assert_allclose(to_np(dX), np.asarray(dXj), rtol=1e-8, atol=1e-9)
    np.testing.assert_allclose(to_np(dU), np.asarray(dUj), rtol=1e-8, atol=1e-9)
    dXp, dUp = tl.solve_lq_batched_plain(data["t_lq"], data["t_act"], data["t_fm"],
                                         data["t_F_bar"], data["t_dx0"], shift=SHIFT)
    assert torch.equal(dX, dXp) and torch.equal(dU, dUp)


def _wrapper_args(name, data, t_proj):
    lq = data["t_lq"]
    A_bar, B_bar, d_bar, lx, lu, lxx, luu, lux, p, P, Px_v = t_proj
    K = torch.zeros_like(A_bar)
    return {
        "project_geom": [lq.A, lq.B, lq.d, lq.g0, lq.Gx, lq.Gv, data["t_F_bar"],
                         data["t_act"], data["t_fm"]],
        "project_cost": [lq.lx, lq.lu, lq.lxx, lq.luu, lq.lux, p, P, Px_v, data["t_fm"]],
        "riccati_backward_ll": [A_bar, B_bar, d_bar, lx, lu, lxx, luu, lux, lq.lxx_f,
                                lq.lx_f],
        "riccati_forward_ll": [A_bar, B_bar, d_bar, K, K[..., 0], p, P, Px_v, data["t_fm"],
                               data["t_dx0"]],
    }[name]


WRAPPERS = ("project_geom", "project_cost", "riccati_backward_ll", "riccati_forward_ll")


@pytest.mark.parametrize("name", WRAPPERS)
def test_wrapper_rejects_a_wrong_shape(data, t_proj, name):
    args = _wrapper_args(name, data, t_proj)
    args[2] = args[2][..., :-1]
    with pytest.raises(ValueError):
        getattr(tl, name)(*args)


@pytest.mark.parametrize("name", WRAPPERS)
def test_wrapper_rejects_another_device_or_mixed_dtypes(data, t_proj, name):
    args = _wrapper_args(name, data, t_proj)
    with pytest.raises(ValueError, match="device"):
        getattr(tl, name)(*(a.to("meta") for a in args))
    args[0] = args[0].float()
    with pytest.raises(ValueError, match="dtype"):
        getattr(tl, name)(*args)


def _literal_backward_ll(A, B, d, lx, lu, lxx, luu, lux, lxx_f, lx_f):
    """``pallas_lq._backward_kernel``'s arithmetic as written: Qxx = lxx +
    A^T (S^T A) and Quu = luu + B^T (S^T B), neither symmetrized."""
    from qm_door_torch.ops.spd_solve import spd_solve_plain

    S, s = lxx_f, lx_f
    Ks = []
    for k in reversed(range(A.shape[1])):
        AT, BT, ST = A[:, k].transpose(-1, -2), B[:, k].transpose(-1, -2), S.transpose(-1, -2)
        Sd = (ST @ d[:, k, :, None])[..., 0] + s
        SA, SB = ST @ A[:, k], ST @ B[:, k]
        Qux = lux[:, k] + BT @ SA
        Quu = luu[:, k] + BT @ SB
        rhs = torch.cat([Qux, (lu[:, k] + (BT @ Sd[..., None])[..., 0])[..., None]], dim=-1)
        sol = -spd_solve_plain(Quu.transpose(-1, -2), rhs)
        K, kff = sol[..., :-1], sol[..., -1]
        QK = Qux.transpose(-1, -2) @ K
        S = lxx[:, k] + AT @ SA + 0.5 * (QK + QK.transpose(-1, -2))
        s = lx[:, k] + (AT @ Sd[..., None])[..., 0] + (Qux.transpose(-1, -2) @ kff[..., None])[..., 0]
        Ks.append(K)
    return torch.stack(Ks[::-1], dim=1)


def test_backward_ll_keeps_S_symmetric_in_float32():
    """With |A| > 1 over a 67-node horizon, the TPU kernel's literal form
    lets the skew part of S grow by ~|A|^2 a node in float32; the port's
    K3c (Qxx, Quu as sym(.) of one product, as K2) stays at f32 roundoff.
    Both agree in float64."""
    rng = np.random.default_rng(11)
    Bb, N, n = 4, 67, 30

    def spd(*shape):
        M = rng.normal(size=shape + (n, n)) * 0.3
        return M @ np.swapaxes(M, -1, -2) + 2.0 * np.eye(n)

    data = [1.1 * np.eye(n) + 0.05 * rng.normal(size=(Bb, N, n, n)),
            0.3 * rng.normal(size=(Bb, N, n, n)), 0.1 * rng.normal(size=(Bb, N, n)),
            rng.normal(size=(Bb, N, n)), rng.normal(size=(Bb, N, n)), spd(Bb, N), spd(Bb, N),
            0.2 * rng.normal(size=(Bb, N, n, n)), spd(Bb), rng.normal(size=(Bb, n))]
    f64 = [torch.as_tensor(a) for a in data]
    f32 = [t.float() for t in f64]
    K_ref, _ = tl.riccati_backward_ll_plain(*f64)
    np.testing.assert_allclose(to_np(_literal_backward_ll(*f64)), to_np(K_ref), rtol=1e-8,
                               atol=1e-8 * float(K_ref.abs().max()))
    scale = float(K_ref.abs().max())
    port = float((tl.riccati_backward_ll_plain(*f32)[0].double() - K_ref).abs().max()) / scale
    literal = float((_literal_backward_ll(*f32).double() - K_ref).abs().max()) / scale
    assert port <= 1e-3, port
    assert not literal <= 100 * port, (literal, port)  # NaN is blown up too
