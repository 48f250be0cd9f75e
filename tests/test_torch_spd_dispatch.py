"""K1's variant dispatch (qm_door_torch/ops/spd_solve.py:k1_variant): the
one-row-a-lane register variants take the main path's shapes, reg64 (two
rows a lane) the WBC shapes, blk128 the stacked interior-point systems
(n <= MAX_N = 128), and the boundaries fall where the kernel source's note
puts them (reg16 for n <= 16, reg32 for n <= 32, both for m <= REG_MAX_M =
64; reg64 for the rest of n <= 64; blk128 past it). PR 1's kernel (smem) is
never chosen, only forced. On the CPU nothing launches: no variant is
counted, and spd_solve_plain (what CPU tensors run) is held to numpy's
float64 solve at the new variants' path shapes, a clamped pivot included.
The variants themselves run only on the card, where chip_smoke.py holds
each against the f64 plain solve."""
import numpy as np
import pytest
import torch

from qm_door_torch.ops import spd_solve as k1


@pytest.mark.parametrize("n, m, variant", [(30, 31, "reg32"), (12, 49, "reg16")])
def test_main_path_shapes_take_the_register_variants(n, m, variant):
    assert k1.k1_variant(n, m) == variant


@pytest.mark.parametrize("n, m", [(36, 1), (42, 1), (58, 58)])
def test_wbc_shapes_take_the_two_row_register_kernel(n, m):
    assert k1.k1_variant(n, m) == "reg64"


@pytest.mark.parametrize("n, m, variant", [
    (1, 1, "reg16"), (16, 1, "reg16"), (17, 1, "reg32"), (32, 1, "reg32"), (33, 1, "reg64"),
    (64, 1, "reg64"), (12, 64, "reg16"), (12, 65, "reg64"), (30, 64, "reg32"),
    (30, 65, "reg64"), (17, 33, "reg32"), (16, 64, "reg16"), (32, 64, "reg32"),
    # past the old n <= 64 bound: the stacked interior-point systems of
    # wbc/qp.py:solve_qp_batched reach n + nv = 92
    (65, 1, "blk128"), (92, 1, "blk128"), (128, 1, "blk128"),
    # reg64's rows pad to 48 or 64 inside the one variant; m = 1 solves by
    # rows, m > 1 by columns, m > 64 from device memory
    (48, 1, "reg64"), (49, 1, "reg64"), (36, 2, "reg64"), (40, 64, "reg64"),
    (40, 65, "reg64"), (50, 100, "reg64"), (32, 65, "reg64"), (33, 64, "reg64"),
    (65, 100, "blk128"), (128, 65, "blk128")])
def test_boundaries(n, m, variant):
    assert k1.REG_MAX_M == 64
    assert k1.REG64_MAX_N == 64
    assert k1.MAX_N == 128
    assert k1.k1_variant(n, m) == variant


def test_pr1_kernel_is_never_chosen():
    """k1_variant names one of the four redesigned variants for every shape
    it takes; PR 1's smem kernel stays in VARIANTS only to be forced."""
    chosen = {k1.k1_variant(n, m) for n in range(1, k1.MAX_N + 1)
              for m in (*range(1, 70), 100, 4000)}
    assert chosen == {"reg16", "reg32", "reg64", "blk128"}
    assert set(k1.VARIANTS) == chosen | {"smem"}


@pytest.mark.parametrize("n, m", [(129, 1), (4, 0)])
def test_dispatch_refuses_what_no_variant_takes(n, m):
    with pytest.raises(ValueError):
        k1._variant_for("spd_solve", n, m, None)
    with pytest.raises(ValueError):
        k1._variant_for("spd_solve", 4, 1, "reg128")


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


# the new variants' shapes on the paths: the WBC's Newton solves, one
# robot's Gram solve, the door's Gram solve, and blk128's two
NEW_VARIANT_SHAPES = [(3, 36, 1), (3, 42, 1), (1, 52, 36), (2, 58, 42), (2, 92, 1), (2, 128, 1)]


@pytest.mark.parametrize("clamped", [False, True])
@pytest.mark.parametrize("B, n, m", NEW_VARIANT_SHAPES)
def test_plain_solve_at_the_new_variants_shapes_matches_float64(B, n, m, clamped):
    """spd_solve_plain in float64 against numpy's float64 solve. With
    `clamped`, row and column 7 of every system are cut loose and A_77 =
    1e-32 < 1e-30: the pivot is clamped, so L_77 = 1e-32 * rsqrt(1e-30) =
    1e-17, and the solve is that of A with A_77 = L_77^2 = 1e-34 (each K1
    variant divides by L_77, or multiplies by its reciprocal, the same
    way). In float32, without the clamp, within 1e-4 of max|x|."""
    rng = np.random.default_rng(n * 10 + m)
    A, Y = _spd(rng, B, n, m)
    ref_A = A.copy()
    if clamped:
        A[:, 7, :] = A[:, :, 7] = 0.0
        A[:, 7, 7] = 1e-32
        ref_A = A.copy()
        ref_A[:, 7, 7] = (1e-32 * (1e-30) ** -0.5) ** 2
    X = k1.spd_solve(torch.as_tensor(A), torch.as_tensor(Y)).numpy()
    ref = np.linalg.solve(ref_A, Y)
    rest = np.arange(n) != 7
    np.testing.assert_allclose(X[:, rest], ref[:, rest], rtol=1e-9,
                               atol=1e-12 * np.abs(ref[:, rest]).max())
    np.testing.assert_allclose(X[:, 7], ref[:, 7], rtol=1e-9, atol=0)
    if clamped:  # y_7 / 1e-34, where the unclamped pivot would give y_7 / 1e-32
        np.testing.assert_allclose(X[:, 7], Y[:, 7] * 1e34, rtol=1e-9, atol=0)
        return
    X32 = k1.spd_solve(torch.as_tensor(A, dtype=torch.float32),
                       torch.as_tensor(Y, dtype=torch.float32))
    np.testing.assert_allclose(X32.double().numpy(), ref, rtol=0, atol=1e-4 * np.abs(ref).max())
