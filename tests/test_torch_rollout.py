"""The port's rollout integrators (qm_door_torch/solver/rollout.py) against
the JAX package's, float64 on the CPU at 1e-12: one RK4 step, one
Dormand-Prince RK45 step and its error estimate, and rollout over a short
input sequence (RK4 with 2 substeps a node, RK45 with 3) against JAX's steps
chained as its rollout chains them under lax.scan (JAX's run eagerly: its
jitted rollout would cost a compile a case); states with a leading batch
axis; an unknown method refused."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qm_door_torch.config import default_config
from qm_door_torch.models.centroidal import weight_compensating_input
from qm_door_torch.models.model import aliengo_z1 as t_aliengo_z1
from qm_door_torch.solver import rollout as t_ro
from qm_door_tpu.models import aliengo_z1 as j_aliengo_z1
from qm_door_tpu.solver import rollout as j_ro
from torch_parity import to_np
from torch_parity import release_jax_executables  # noqa: F401 (autouse, module scope)

TOL = dict(rtol=1e-12, atol=1e-12)
DT = 0.015
STEPS = {"rk4": j_ro.rk4_step, "rk45": lambda m, x, u, h: j_ro.rk45_step(m, x, u, h)[0]}


@pytest.fixture(scope="module")
def case():
    """Both models, two perturbed initial states and five inputs around the
    trot's weight-compensating input."""
    rng = np.random.default_rng(21)
    x0 = default_config().initial_state()
    xb = x0[None] + rng.normal(size=(2, 30)) * 0.02
    flags = torch.tensor([[1.0, 0.0, 0.0, 1.0]] * 5, dtype=torch.float64)
    U = to_np(weight_compensating_input(t_aliengo_z1(torch.float64, "cpu"), flags))
    U = U + rng.normal(size=(5, 30)) * 2.0
    return (j_aliengo_z1(dtype=jnp.float64), t_aliengo_z1(dtype=torch.float64, device="cpu"),
            xb, U)


@pytest.mark.parametrize("method", ["rk4", "rk45"])
def test_step_matches_jax(case, method):
    jm, tm, xb, U = case
    t_x, j_x = (torch.as_tensor(xb[0]), torch.as_tensor(U[0])), (jnp.asarray(xb[0]),
                                                                jnp.asarray(U[0]))
    if method == "rk4":
        np.testing.assert_allclose(to_np(t_ro.rk4_step(tm, *t_x, DT)),
                                   np.asarray(j_ro.rk4_step(jm, *j_x, DT)), **TOL)
    else:
        x5, err = t_ro.rk45_step(tm, *t_x, DT)
        j5, j_err = j_ro.rk45_step(jm, *j_x, DT)
        np.testing.assert_allclose(to_np(x5), np.asarray(j5), **TOL)
        np.testing.assert_allclose(float(err), float(j_err), rtol=1e-9, atol=1e-15)
        assert 0.0 < float(err) < 1e-3


@pytest.mark.parametrize("method,substeps", [("rk4", 2), ("rk45", 3)])
def test_rollout_matches_jax(case, method, substeps):
    jm, tm, xb, U = case
    X = t_ro.rollout(tm, torch.as_tensor(xb[0]), torch.as_tensor(U), DT, substeps=substeps,
                     method=method)
    assert X.shape == (6, 30)
    np.testing.assert_array_equal(to_np(X[0]), xb[0])
    x = jnp.asarray(xb[0])
    for k in range(U.shape[0]):
        for _ in range(substeps):
            x = STEPS[method](jm, x, jnp.asarray(U[k]), DT / substeps)
        np.testing.assert_allclose(to_np(X[k + 1]), np.asarray(x), **TOL)


def test_rollout_batched_and_refusals(case):
    _, tm, xb, U = case
    Ub = torch.as_tensor(np.stack([U, U[::-1]]))
    Xb = t_ro.rollout(tm, torch.as_tensor(xb), Ub, DT, substeps=2)
    assert Xb.shape == (2, 6, 30)
    for i in range(2):
        np.testing.assert_allclose(to_np(Xb[i]), to_np(t_ro.rollout(
            tm, torch.as_tensor(xb[i]), Ub[i], DT, substeps=2)), **TOL)
    with pytest.raises(ValueError, match="method"):
        t_ro.rollout(tm, torch.as_tensor(xb[0]), Ub[0], DT, method="euler")
