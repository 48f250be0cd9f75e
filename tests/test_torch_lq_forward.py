"""K3d (qm_door_torch/ops/lq.py: riccati_forward_ll) around its kernel: the
bound chip_smoke.py computes (NODE_COST, forward_bytes) counts exactly what
the wrapper reads and writes, the ctypes signature of the occupancy query
matches its C entry point, the plain version on the outputs of a
projection of every fm/act pattern (in f64 against the JAX kernel in
interpret mode, and in f32 against f64), and that CPU tensors launch
nothing. The kernel itself runs only on the card, where chip_smoke.py
holds it against the f64 plain version."""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import (NODE_COST, PROJECTION_PATTERNS, SWEEP_REL_TOL, forward_bytes,
                        forward_data)
from qm_door_torch.ops import lq as tl
from qm_door_tpu.ops import pallas_lq as pk
from test_torch_lq_dispatch import _c_params
from torch_parity import to_np
from torch_parity import release_jax_executables  # noqa: F401 (autouse, module scope)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# (Bb, N) of the JAX parity cases: a few nodes of every pattern, and one node
CASES = [(pattern, 3, 6) for pattern in PROJECTION_PATTERNS] + [("mix", 3, 1)]


def _jax_forward(args):
    """pallas_lq.riccati_forward_ll in interpret mode on batch-major f64
    inputs; returns batch-major numpy (dX, dU)."""
    ll = [jnp.moveaxis(jnp.asarray(to_np(t)), 0, -1) for t in args]
    dX, dU = pk.riccati_forward_ll(*ll, interpret=True, batch_tile=4)
    return [np.moveaxis(np.asarray(x), -1, 0) for x in (dX, dU)]


def test_node_cost_counts_each_input_and_output_once():
    Bb, N = 2, 3
    ins = forward_data(Bb, N, "mix", 0)
    outs = tl.riccati_forward_ll(*ins)
    floats, _ = NODE_COST["K3d"]
    moved = sum(t.numel() for t in ins) + sum(t.numel() for t in outs)
    assert moved == Bb * N * floats + 2 * Bb * 30
    assert forward_bytes(Bb, N) == 4 * moved
    assert [tuple(t.shape) for t in outs] == [(Bb, N + 1, 30), (Bb, N, 30)]


def test_occupancy_query_signature_matches_the_entry_point():
    """The argtypes ops/lq.py binds to K3d's occupancy query are its C
    parameters, one for one (ctypes cannot check a call against the
    library); the launch's own entry point is held in
    test_torch_lq_dispatch.py."""
    with open(os.path.join(ROOT, "qm_door_torch", "csrc", "lq_forward.cu")) as f:
        src = f.read()
    name = "qm_lq_forward_blocks_per_sm"
    assert _c_params(src, name) == tl._ARGTYPES[name]


@pytest.mark.parametrize("pattern, Bb, N", CASES)
def test_plain_version_matches_jax(pattern, Bb, N):
    args = forward_data(Bb, N, pattern, seed=PROJECTION_PATTERNS.index(pattern) + N)
    ours = tl.riccati_forward_ll_plain(*args)
    for name, got, want in zip(("dX", "dU"), ours, _jax_forward(args)):
        np.testing.assert_allclose(to_np(got), want, rtol=1e-8, atol=1e-9, err_msg=name)


@pytest.mark.parametrize("pattern, Bb, N", [(p, 4, 67) for p in PROJECTION_PATTERNS]
                         + [("mix", 4, 1)])
def test_float32_plain_version_stays_within_the_kernels_bar(pattern, Bb, N):
    """The bar chip_smoke.py holds K3d to (SWEEP_REL_TOL, relative to
    max|f64|) is one the f32 arithmetic of the TPU kernel meets on every
    pattern, over the path's 67 nodes and at one node."""
    args = forward_data(Bb, N, pattern, seed=21)
    ref = tl.riccati_forward_ll_plain(*args)
    got = tl.riccati_forward_ll_plain(*[t.float() for t in args])
    for r, o in zip(ref, got):
        rel = float((o.double() - r).abs().max() / r.abs().max().clamp_min(1e-30))
        assert rel <= SWEEP_REL_TOL, rel


def test_cpu_tensors_count_no_launch():
    before = tl.riccati_forward_ll.launches
    for pattern in PROJECTION_PATTERNS:
        args = forward_data(2, 3, pattern, 4)
        for got, want in zip(tl.riccati_forward_ll(*args), tl.riccati_forward_ll_plain(*args)):
            assert torch.equal(got, want)
    assert tl.riccati_forward_ll.launches == before
    assert type(before) is int
