"""K3a and K3b (qm_door_torch/ops/lq.py: project_geom, project_cost) around
their kernels: the bound chip_smoke.py computes (NODE_COST) counts exactly
what the wrappers read and write, the ctypes signatures match the C entry
points, the plain versions on every fm/act pattern of the projection's
branches (in f64 against the JAX kernels in interpret mode, and in f32
against f64, at the path's shift and at a unit shift), where the shift
lands and that a wrong one fails chip_smoke.py's unit-shift check, and
that CPU tensors launch nothing. The kernels themselves run only on the card, where
chip_smoke.py holds each against the f64 plain version."""
import ctypes
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import NODE_COST, PROJECTION_PATTERNS, PROJECTION_REL_TOL, projection_data
from qm_door_torch.ops import lq as tl
from qm_door_tpu.ops import pallas_lq as pk
from torch_parity import to_np
from torch_parity import release_jax_executables  # noqa: F401 (autouse, module scope)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHIFT = 1e-5
UNIT_SHIFT = 1.0
PROJ = ("A_bar", "B_bar", "d_bar", "lx", "lu", "lxx", "luu", "lux", "p", "P", "Px_v")


def _inputs(pattern, Bb=2, N=5, seed=0):
    """float64 torch inputs of K3a and K3b (K3b's p, P, Px_v from K3a)."""
    geom, cost = projection_data(Bb, N, pattern, seed)
    g = [torch.as_tensor(t) for t in geom]
    p, P, Px_v = tl.project_geom_plain(*g)[3:]
    return g, [torch.as_tensor(t) for t in cost] + [p, P, Px_v, g[-1]]


@pytest.mark.parametrize("kid", ["K3a", "K3b"])
def test_node_cost_counts_each_input_and_output_once(kid):
    g, c = _inputs("mix", 1, 1)
    if kid == "K3a":
        ins, outs = g, tl.project_geom(*g)
    else:
        ins, outs = c, tl.project_cost(*c, shift=SHIFT)
    floats, _ = NODE_COST[kid]
    assert floats == sum(t.numel() for t in ins) + sum(t.numel() for t in outs)
    tails = tl.GEOM_OUT if kid == "K3a" else tl.COST_OUT
    assert [tuple(t.shape[2:]) for t in outs] == list(tails)


def _c_params(src, name):
    """ctypes types of the parameters of `extern "C" int name(...)` in src."""
    params = re.search(rf"{name}\(([^)]*)\)", src).group(1).split(",")
    kinds = []
    for p in params:
        p = " ".join(p.split())
        if "*" in p:
            kinds.append(ctypes.c_void_p)
        elif p.startswith("long long"):
            kinds.append(ctypes.c_longlong)
        elif p.startswith("float"):
            kinds.append(ctypes.c_float)
        else:
            kinds.append(ctypes.c_int)
    return kinds


@pytest.mark.parametrize("source, name", [("lq_project", "qm_lq_project_geom_f32"),
                                          ("lq_project", "qm_lq_project_cost_f32"),
                                          ("lq_forward", "qm_lq_forward_f32")])
def test_ctypes_signature_matches_the_entry_point(source, name):
    """The argtypes ops/lq.py binds are the C entry point's parameters, one
    for one (ctypes cannot check a call against the library)."""
    with open(os.path.join(ROOT, "qm_door_torch", "csrc", f"{source}.cu")) as f:
        src = f.read()
    assert _c_params(src, name) == tl._ARGTYPES[name]


@pytest.mark.parametrize("pattern", PROJECTION_PATTERNS)
def test_pattern_data_follows_the_masks(pattern):
    geom, _ = projection_data(3, 4, pattern, 1)
    g0, Gx, Gv, act, fm = geom[3], geom[4], geom[5], geom[7], geom[8]
    flags = fm[..., ::3]
    assert np.array_equal(fm, np.repeat(flags, 3, axis=-1))
    z_rows = act.reshape(3, 4, 4, 3)
    if pattern == "act_off":
        assert (act == 0).any() and ((act == 1) & (np.repeat(flags, 3, -1) == 0)).any()
    else:
        assert np.array_equal(z_rows[..., 0], flags) and (z_rows[..., 2] == 1).all()
    if pattern == "stance":
        assert (fm == 1).all()
    if pattern == "swing":
        assert (fm == 0).all()
    off = act == 0
    assert (g0[off] == 0).all() and (Gx[off] == 0).all() and (Gv[off] == 0).all()


def _jax_project(g, c):
    """pallas_lq.project_lq in interpret mode on batch-major f64 inputs;
    returns batch-major numpy outputs in the port's order."""
    A, B, d, g0, Gx, Gv, F_bar, act, fm = [jnp.moveaxis(jnp.asarray(to_np(t)), 0, -1) for t in g]
    lx, lu, lxx, luu, lux = [jnp.moveaxis(jnp.asarray(to_np(t)), 0, -1) for t in c[:5]]
    T = lambda x: jnp.transpose(jnp.asarray(to_np(x)), (1, 3, 2, 0))  # noqa: E731
    out = pk.project_lq(A, B, T(g[1]), d, lx, lu, lxx, luu, lux, g0, Gx, Gv, T(g[5]), F_bar,
                        act, fm, shift=SHIFT, interpret=True, batch_tile=4)
    return [np.moveaxis(np.asarray(x), -1, 0) for x in out]


@pytest.mark.parametrize("pattern", PROJECTION_PATTERNS)
def test_plain_versions_match_jax_on_every_pattern(pattern):
    g, c = _inputs(pattern, 3, 5, seed=PROJECTION_PATTERNS.index(pattern))
    ours = tl.project_lq_plain(*g[:3], *c[:5], *g[3:], shift=SHIFT)
    for name, got, want in zip(PROJ, ours, _jax_project(g, c)):
        np.testing.assert_allclose(to_np(got), want, rtol=1e-8, atol=1e-8, err_msg=name)


@pytest.mark.parametrize("pattern", PROJECTION_PATTERNS)
def test_cost_shift_lands_once_on_the_diagonal(pattern):
    """The shift adds s to each of luu_bar's 30 diagonal entries, the force
    block's and the joint block's alike, and changes nothing else."""
    _, c = _inputs(pattern, 2, 3, seed=5)
    base = tl.project_cost_plain(*c, shift=0.0)
    shifted = tl.project_cost_plain(*c, shift=UNIT_SHIFT)
    for i, (b, s) in enumerate(zip(base, shifted)):
        want = b + UNIT_SHIFT * torch.eye(30, dtype=b.dtype) if i == 3 else b
        torch.testing.assert_close(s, want, rtol=0, atol=1e-12)


def test_a_wrong_shift_fails_the_unit_shift_check():
    """chip_smoke.py's K3b check at UNIT_SHIFT sees a kernel that drops or
    doubles the shift on either diagonal block: the luu_bar it would return
    misses PROJECTION_REL_TOL."""
    _, c = _inputs("mix", 7, 67, seed=3)
    luu_bar = tl.project_cost_plain(*c, shift=UNIT_SHIFT)[3]
    eye = torch.eye(30, dtype=luu_bar.dtype)
    for rows in (slice(0, 12), slice(12, 30)):  # the force block, the joint block
        for fault in (-1.0, 1.0):  # the shift dropped, doubled
            wrong = luu_bar.clone()
            wrong[..., rows, rows] += fault * UNIT_SHIFT * eye[rows, rows]
            rel = float((wrong - luu_bar).abs().max() / luu_bar.abs().max())
            assert rel > 10 * PROJECTION_REL_TOL, (rows, fault, rel)


@pytest.mark.parametrize("pattern", PROJECTION_PATTERNS)
def test_float32_plain_cost_stays_within_the_bar_at_a_unit_shift(pattern):
    """chip_smoke.py holds K3b to PROJECTION_REL_TOL at a unit shift too;
    the f32 arithmetic of the TPU kernel meets that bar there."""
    _, c = _inputs(pattern, 4, 67, seed=12)
    ref = tl.project_cost_plain(*c, shift=UNIT_SHIFT)
    got = tl.project_cost_plain(*[t.float() for t in c], shift=UNIT_SHIFT)
    for r, o in zip(ref, got):
        rel = float((o.double() - r).abs().max() / r.abs().max().clamp_min(1e-30))
        assert rel <= PROJECTION_REL_TOL, rel


@pytest.mark.parametrize("kid", ["K3a", "K3b"])
@pytest.mark.parametrize("pattern", PROJECTION_PATTERNS)
def test_float32_plain_versions_stay_within_the_kernels_bar(kid, pattern):
    """The bar chip_smoke.py holds the kernels to (PROJECTION_REL_TOL,
    relative to max|f64|) is one the f32 arithmetic of the TPU kernel meets
    on every pattern."""
    g, c = _inputs(pattern, 4, 67, seed=11)
    if kid == "K3a":
        fn = tl.project_geom_plain
        ref, got = fn(*g), fn(*[t.float() for t in g])
    else:
        fn = tl.project_cost_plain
        ref, got = fn(*c, shift=SHIFT), fn(*[t.float() for t in c], shift=SHIFT)
    for r, o in zip(ref, got):
        rel = float((o.double() - r).abs().max() / r.abs().max().clamp_min(1e-30))
        assert rel <= PROJECTION_REL_TOL, rel


def test_swing_projection_keeps_the_force_block_regularized():
    """All feet in swing: fm = 0, so the force inputs drop out of the
    dynamics and their cost block is the identity plus the shift."""
    g, c = _inputs("swing", 1, 2)
    B_bar = tl.project_geom_plain(*g)[1]
    luu_bar = tl.project_cost_plain(*c, shift=SHIFT)[3]
    assert (B_bar[..., :12] == 0).all()
    eye = torch.eye(12, dtype=luu_bar.dtype) * (1.0 + SHIFT)
    assert torch.equal(luu_bar[..., :12, :12], eye.expand_as(luu_bar[..., :12, :12]))
    assert (luu_bar[..., :12, 12:] == 0).all() and (luu_bar[..., 12:, :12] == 0).all()


def test_cpu_tensors_count_no_launch():
    before = (tl.project_geom.launches, tl.project_cost.launches)
    for pattern in PROJECTION_PATTERNS:
        g, c = _inputs(pattern, 1, 3)
        for got, want in zip(tl.project_geom(*g), tl.project_geom_plain(*g)):
            assert torch.equal(got, want)
        for got, want in zip(tl.project_cost(*c, shift=SHIFT),
                             tl.project_cost_plain(*c, shift=SHIFT)):
            assert torch.equal(got, want)
    assert (tl.project_geom.launches, tl.project_cost.launches) == before
    assert all(type(n) is int for n in before)
