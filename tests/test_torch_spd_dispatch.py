"""K1's variant dispatch (qm_door_torch/ops/spd_solve.py:k1_variant): the
register variants take the main path's shapes, the shared-memory kernel the
WBC shapes and the stacked interior-point systems (n <= MAX_N = 128), and
the boundaries fall where the kernel source's note puts them (reg16 for
n <= 16, reg32 for n <= 32, both for m <= REG_MAX_M = 64).
On the CPU nothing launches: no variant is counted. The variants
themselves run only on the card, where chip_smoke.py holds each against
the f64 plain solve."""
import numpy as np
import pytest
import torch

from qm_door_torch.ops import spd_solve as k1


@pytest.mark.parametrize("n, m, variant", [(30, 31, "reg32"), (12, 49, "reg16")])
def test_main_path_shapes_take_the_register_variants(n, m, variant):
    assert k1.k1_variant(n, m) == variant


@pytest.mark.parametrize("n, m", [(36, 1), (42, 1), (58, 58)])
def test_wbc_shapes_take_the_shared_memory_kernel(n, m):
    assert k1.k1_variant(n, m) == "smem"


@pytest.mark.parametrize("n, m, variant", [
    (1, 1, "reg16"), (16, 1, "reg16"), (17, 1, "reg32"), (32, 1, "reg32"), (33, 1, "smem"),
    (64, 1, "smem"), (12, 64, "reg16"), (12, 65, "smem"), (30, 64, "reg32"),
    (30, 65, "smem"), (17, 33, "reg32"), (16, 64, "reg16"), (32, 64, "reg32"),
    # past the old n <= 64 bound: the stacked interior-point systems of
    # wbc/qp.py:solve_qp_batched reach n + nv = 92
    (65, 1, "smem"), (92, 1, "smem"), (128, 1, "smem")])
def test_boundaries(n, m, variant):
    assert k1.REG_MAX_M == 64
    assert k1.MAX_N == 128
    assert k1.k1_variant(n, m) == variant


def _spd(rng, B, n, m):
    A = rng.normal(size=(B, n, n))
    return A @ np.swapaxes(A, -1, -2) + n * np.eye(n), rng.normal(size=(B, n, m))


def test_cpu_tensors_count_no_variant():
    rng = np.random.default_rng(5)
    total = (k1.spd_solve.launches, k1.spd_solve_ll.launches)
    by_variant = (dict(k1.spd_solve.launches_by_variant),
                  dict(k1.spd_solve_ll.launches_by_variant))
    by_shape = (dict(k1.spd_solve.launches_by_shape), dict(k1.spd_solve_ll.launches_by_shape))
    for B, n, m in ((7, 12, 49), (3, 30, 31), (2, 58, 58)):
        A, Y = (torch.as_tensor(t) for t in _spd(rng, B, n, m))
        k1.spd_solve(A, Y)
        k1.spd_solve(A, Y, _variant="smem")
        k1.spd_solve_ll(A.permute(1, 2, 0).contiguous(), Y.permute(1, 2, 0).contiguous())
    assert (k1.spd_solve.launches, k1.spd_solve_ll.launches) == total
    assert (k1.spd_solve.launches_by_variant, k1.spd_solve_ll.launches_by_variant) == by_variant
    assert (k1.spd_solve.launches_by_shape, k1.spd_solve_ll.launches_by_shape) == by_shape
    for counts in by_variant:
        assert set(counts) == set(k1.VARIANTS)
        assert all(type(v) is int and v == 0 for v in counts.values())


def test_plain_solve_at_the_stacked_shape_matches_float64():
    """The plain version (what CPU tensors run) at the stacked interior-point
    system's 92 x 92 x 1, in float32 against numpy's float64 solve of the
    same system: n > 64 needs no other code path."""
    rng = np.random.default_rng(92)
    A, Y = _spd(rng, 2, 92, 1)
    X = k1.spd_solve(torch.as_tensor(A, dtype=torch.float32),
                     torch.as_tensor(Y, dtype=torch.float32), 1e-6)
    ref = np.linalg.solve(A + 1e-6 * np.eye(92), Y)
    assert X.dtype == torch.float32 and X.shape == (2, 92, 1)
    np.testing.assert_allclose(X.double().numpy(), ref, rtol=0, atol=1e-4 * np.abs(ref).max())
    X64 = k1.spd_solve(torch.as_tensor(A), torch.as_tensor(Y), 1e-6)
    np.testing.assert_allclose(X64.numpy(), ref, rtol=1e-10, atol=1e-12)
