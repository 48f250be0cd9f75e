"""K1 (qm_door_torch/ops/spd_solve.py): the plain version against the JAX
kernel in interpret mode and its XLA reference, in float64 at 1e-10; the
wrapper's dispatch and input checks on the CPU. The CUDA kernel itself is
held against the plain version on the card by chip_smoke.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qm_door_torch.ops import cuda_build
from qm_door_torch.ops.spd_solve import spd_solve, spd_solve_plain
from qm_door_tpu.ops.pallas_chol import spd_solve as j_spd_solve
from qm_door_tpu.ops.pallas_chol import spd_solve_reference as j_spd_reference
from torch_parity import to_np

TOL = dict(rtol=1e-10, atol=1e-10)
SHAPES = [(7, 12, 49), (5, 30, 31), (3, 58, 8)]


def _spd(rng, B, n, m):
    A = rng.normal(size=(B, n, n))
    A = A @ np.swapaxes(A, -1, -2) + n * np.eye(n)
    return A, rng.normal(size=(B, n, m))


@pytest.mark.parametrize("shift", [0.0, 1e-3])
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_matches_jax_kernel_and_reference(shape, shift):
    A, Y = _spd(np.random.default_rng(sum(shape)), *shape)
    out = to_np(spd_solve_plain(torch.as_tensor(A), torch.as_tensor(Y), shift=shift))
    jA, jY = jnp.asarray(A), jnp.asarray(Y)
    np.testing.assert_allclose(out, np.asarray(j_spd_solve(jA, jY, shift=shift, interpret=True)),
                               **TOL)
    np.testing.assert_allclose(out, np.asarray(j_spd_reference(jA, jY, shift=shift)), **TOL)


def test_plain_reads_the_lower_triangle_only():
    A, Y = _spd(np.random.default_rng(1), 4, 12, 3)
    A_up = A + np.triu(np.random.default_rng(2).normal(size=A.shape), k=1)
    np.testing.assert_array_equal(
        to_np(spd_solve_plain(torch.as_tensor(A_up), torch.as_tensor(Y))),
        to_np(spd_solve_plain(torch.as_tensor(A), torch.as_tensor(Y))))


def test_cpu_tensors_take_the_plain_version_without_a_launch():
    A, Y = (torch.as_tensor(a) for a in _spd(np.random.default_rng(3), 6, 30, 31))
    before = spd_solve.launches
    np.testing.assert_array_equal(to_np(spd_solve(A, Y, 1e-5)),
                                  to_np(spd_solve_plain(A, Y, 1e-5)))
    assert spd_solve.launches == before


@pytest.mark.parametrize("bad", ["rank", "batch", "square", "dtype", "contiguous", "device"])
def test_wrapper_rejects_bad_inputs(bad):
    A = torch.eye(4, dtype=torch.float64).repeat(3, 1, 1)
    Y = torch.ones(3, 4, 2, dtype=torch.float64)
    args = {
        "rank": (A[0], Y[0]),
        "batch": (A, Y[:2]),
        "square": (A[:, :, :3], Y),
        "dtype": (A, Y.float()),
        "contiguous": (A.transpose(0, 1), Y.transpose(0, 1)),
        "device": (A.to("meta"), Y.to("meta")),
    }[bad]
    with pytest.raises(ValueError):
        spd_solve(*args)


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(cuda_build, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setattr(cuda_build.shutil, "which", lambda name: None)
    import torch.utils.cpp_extension as cpp_ext

    monkeypatch.setattr(cpp_ext, "CUDA_HOME", None)
    with pytest.raises(RuntimeError, match="nvcc"):
        cuda_build.build("spd_solve")
    assert not (tmp_path / "build").exists()


def test_library_name_follows_the_source():
    path = cuda_build._library_path("spd_solve")
    assert path.startswith(cuda_build.BUILD_DIR) and path.endswith(".so")
    assert path == cuda_build._library_path("spd_solve")
