"""The backward sweep's variant dispatch
(qm_door_torch/ops/riccati_fused.py:sweep_variant), shared by K2
(riccati_backward_fused) and K3c (lq.riccati_backward_ll): the register
variant takes the main path's 30/30 and every nu <= 32 (nx up to 36, where
nx + 1 = 37 right-hand sides take a second solving warp), the two-rows-a-
lane register variant (reg2) 32 < nu <= 36, and nothing above 36 is taken.
The block-parallel kernel (smem) is never chosen, only forced. On the CPU nothing
launches: no variant is counted. The variants themselves run only on the
card, where chip_smoke.py holds each against the f64 plain sweep."""
import numpy as np
import pytest
import torch

from qm_door_torch.ops import lq as tl
from qm_door_torch.ops import riccati_fused as rf


def test_main_path_shape_takes_the_register_variant():
    assert rf.sweep_variant(30, 30) == "reg"


@pytest.mark.parametrize("nx, nu, variant", [
    (30, 1, "reg"), (30, 32, "reg"), (30, 33, "reg2"), (30, 36, "reg2"), (1, 1, "reg"),
    (7, 4, "reg"), (36, 36, "reg2")])
def test_boundaries(nx, nu, variant):
    assert rf.REG_MAX_NU == 32 and rf.MAX_DIM == 36
    assert rf.sweep_variant(nx, nu) == variant


def test_the_smem_variant_is_only_forced():
    """sweep_variant names reg or reg2 for every shape the kernel takes; smem
    stays in VARIANTS only to be forced, and takes every nu <= 36 then."""
    chosen = {rf.sweep_variant(nx, nu) for nx in range(1, 37) for nu in range(1, 37)}
    assert chosen == {"reg", "reg2"}
    assert set(rf.VARIANTS) == chosen | {"smem"}
    for nu in (1, 30, 33, 36):
        assert rf.variant_for("sweep", 30, nu) == rf.sweep_variant(30, nu)
        assert rf.variant_for("sweep", 30, nu, "smem") == "smem"


@pytest.mark.parametrize("nx, nu", [(30, 37), (37, 30), (37, 4)])
def test_above_the_kernel_range_raises(nx, nu):
    with pytest.raises(ValueError, match="at most 36"):
        rf.sweep_variant(nx, nu)


def _data(Bb, N, nx, nu, seed=3):
    """Sweep inputs on the JAX tests' recipe (A near I, SPD Hessians)."""
    rng = np.random.default_rng(seed)

    def spd(*s):
        M = rng.normal(size=s + (s[-1],)) * 0.3
        return M @ np.swapaxes(M, -1, -2) + 2.0 * np.eye(s[-1])

    arrays = [rng.normal(size=(Bb, N, nx, nx)) * 0.2 + np.eye(nx),
              rng.normal(size=(Bb, N, nx, nu)) * 0.3, rng.normal(size=(Bb, N, nx)) * 0.1,
              rng.normal(size=(Bb, N, nx)), rng.normal(size=(Bb, N, nu)), spd(Bb, N, nx),
              spd(Bb, N, nu), rng.normal(size=(Bb, N, nu, nx)) * 0.2, spd(Bb, nx),
              rng.normal(size=(Bb, nx))]
    return [torch.as_tensor(a) for a in arrays]


def test_nx_36_with_nu_32_is_the_register_path():
    """The widest reg shape: 37 right-hand sides, over two warps on the card.
    On the CPU both wrappers are the plain sweep."""
    assert rf.sweep_variant(36, 32) == "reg"
    args = _data(2, 3, 36, 32)
    for got, want in zip(rf.riccati_backward_fused(*args, shift=1e-3),
                         rf.sweep_plain(*args, 1e-3, symmetrize=True)):
        assert got.shape in ((2, 3, 32, 36), (2, 3, 32)) and torch.equal(got, want)
    for got, want in zip(tl.riccati_backward_ll(*args), rf.sweep_plain(*args, 0.0, False)):
        assert torch.equal(got, want)


def test_cpu_tensors_count_no_launch_and_no_variant():
    wrappers = (rf.riccati_backward_fused, tl.riccati_backward_ll)
    total = [w.launches for w in wrappers]
    by_variant = [dict(w.launches_by_variant) for w in wrappers]
    for shape in ((2, 3, 7, 4), (2, 2, 30, 36), (1, 1, 30, 30)):
        args = _data(*shape)
        rf.riccati_backward_fused(*args)
        tl.riccati_backward_ll(*args)
    assert [w.launches for w in wrappers] == total
    assert [w.launches_by_variant for w in wrappers] == by_variant
    for counts in by_variant:
        assert set(counts) == set(rf.VARIANTS)
        assert all(type(v) is int and v == 0 for v in counts.values())


@pytest.mark.parametrize("nu", [33, 36])
def test_reg2_shapes_on_the_cpu_run_the_plain_sweep_and_count_nothing(nu):
    """At reg2's widths (30/36 is the force-tracking path's) both wrappers
    are the plain sweep on the CPU and count no launch of any variant."""
    wrappers = (rf.riccati_backward_fused, tl.riccati_backward_ll)
    before = [(w.launches, dict(w.launches_by_variant)) for w in wrappers]
    args = _data(2, 3, 30, nu)
    for got, want in zip(rf.riccati_backward_fused(*args, shift=1e-3),
                         rf.sweep_plain(*args, 1e-3, symmetrize=True)):
        assert got.shape in ((2, 3, nu, 30), (2, 3, nu)) and torch.equal(got, want)
    for got, want in zip(tl.riccati_backward_ll(*args), rf.sweep_plain(*args, 0.0, False)):
        assert torch.equal(got, want)
    assert [(w.launches, w.launches_by_variant) for w in wrappers] == before


@pytest.mark.parametrize("shape, variant", [
    ((2, 3, 7, 4), "warp"), ((1, 2, 30, 37), None), ((1, 2, 30, 30), "reg2"),
    ((1, 2, 30, 32), "reg2"), ((1, 2, 30, 37), "reg2"), ((1, 2, 30, 33), "reg")])
def test_the_launch_refuses_before_touching_the_card(shape, variant):
    """An unknown forced variant, nu = 37, a forced reg2 at nu <= 32 or
    nu > 36 and a forced reg at nu > 32 raise ValueError before any CUDA
    call (so here, on CPU tensors) and count nothing."""
    before = (rf.riccati_backward_fused.launches,
              dict(rf.riccati_backward_fused.launches_by_variant))
    with pytest.raises(ValueError):
        rf.launch_sweep(rf.riccati_backward_fused, _data(*shape), 0.0, symmetrize=True,
                        variant=variant)
    assert (rf.riccati_backward_fused.launches,
            rf.riccati_backward_fused.launches_by_variant) == before
