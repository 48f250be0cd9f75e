"""K1 (qm_door_torch/ops/spd_solve.py): the plain version against the JAX
kernel's XLA reference at every shape and against the kernel itself in
interpret mode at the smallest (SHAPES[0]: a ragged lane batch through the
same unrolled factor and substitutions as every shape), in float64 at
1e-10; K1-ll (``spd_solve_ll``, lanes-last) the same way against JAX's
``spd_solve_ll``; the
wrappers' dispatch and input checks on the CPU; each variant's ctypes
signature against its C entry point; the build's library names, flags and
the ptxas report it keeps. The CUDA kernel itself is held against the
plain version on the card by chip_smoke.py."""
import ctypes
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qm_door_torch.ops import cuda_build
from qm_door_torch.ops import spd_solve as k1
from qm_door_torch.ops.spd_solve import spd_solve, spd_solve_ll, spd_solve_plain
from qm_door_torch.utils import compile_cache
from qm_door_tpu.ops.pallas_chol import spd_solve as j_spd_solve
from qm_door_tpu.ops.pallas_chol import spd_solve_ll as j_spd_solve_ll
from qm_door_tpu.ops.pallas_chol import spd_solve_reference as j_spd_reference
from torch_parity import to_np
from torch_parity import release_jax_executables  # noqa: F401 (autouse, module scope)

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
    if shape == SHAPES[0]:  # interpret mode costs minutes at the larger shapes
        np.testing.assert_allclose(
            out, np.asarray(j_spd_solve(jA, jY, shift=shift, interpret=True)), **TOL)
    np.testing.assert_allclose(out, np.asarray(j_spd_reference(jA, jY, shift=shift)), **TOL)


@pytest.mark.parametrize("shape", SHAPES)
def test_lanes_last_matches_jax(shape):
    A, Y = _spd(np.random.default_rng(sum(shape) + 1), *shape)
    At, Yt = np.transpose(A, (1, 2, 0)), np.transpose(Y, (1, 2, 0))
    before = spd_solve_ll.launches
    out = spd_solve_ll(torch.as_tensor(At), torch.as_tensor(Yt), shift=1e-3)
    assert spd_solve_ll.launches == before
    assert out.shape == Yt.shape and out.is_contiguous()
    if shape == SHAPES[0]:
        ref = j_spd_solve_ll(jnp.asarray(At), jnp.asarray(Yt), shift=1e-3, interpret=True)
    else:
        ref = np.transpose(j_spd_reference(jnp.asarray(A), jnp.asarray(Y), shift=1e-3), (1, 2, 0))
    np.testing.assert_allclose(to_np(out), np.asarray(ref), **TOL)
    np.testing.assert_allclose(
        to_np(out), np.transpose(to_np(spd_solve_plain(torch.as_tensor(A),
                                                       torch.as_tensor(Y), 1e-3)), (1, 2, 0)),
        **TOL)


@pytest.mark.parametrize("bad", ["rank", "square", "batch", "rows", "dtype"])
def test_lanes_last_wrapper_rejects_bad_inputs(bad):
    At = torch.eye(4, dtype=torch.float64)[:, :, None].repeat(1, 1, 3)
    Yt = torch.ones(4, 2, 3, dtype=torch.float64)
    args = {"rank": (At[..., 0], Yt), "square": (At[:3], Yt), "batch": (At, Yt[..., :2]),
            "rows": (At, Yt[:3]), "dtype": (At, Yt.float())}[bad]
    with pytest.raises(ValueError):
        spd_solve_ll(*args)


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


@pytest.mark.parametrize("variant", k1.VARIANTS)
def test_ctypes_signature_matches_the_entry_point(variant):
    """The argtypes kernel_fn binds are each variant's C entry point's
    parameters, one for one (ctypes cannot check a call against the
    library)."""
    with open(os.path.join(cuda_build.CSRC, "spd_solve.cu")) as f:
        src = f.read()
    assert f'extern "C" int {k1.entry_point(variant)}(' in src
    assert _c_params(src, k1.entry_point(variant)) == k1.ARGTYPES


def test_defines_follow_the_common_flags():
    flags = cuda_build._flags(("QM_X", "QM_Y=3"))
    assert flags[:len(cuda_build.NVCC_FLAGS)] == cuda_build.NVCC_FLAGS
    assert flags[len(cuda_build.NVCC_FLAGS):] == ("-DQM_X", "-DQM_Y=3")


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(compile_cache, "_dir", str(tmp_path / "build"))
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
    assert path.startswith(compile_cache.build_dir()) and path.endswith(".so")
    assert path == cuda_build._library_path("spd_solve")


def test_a_diagnostic_build_gets_its_own_library():
    plain = cuda_build._library_path("riccati_bwd")
    diag = cuda_build._library_path("riccati_bwd", ("QM_SWEEP_PHASE_CLOCKS",))
    assert plain != diag and diag.startswith(compile_cache.build_dir())
    assert "-DQM_SWEEP_PHASE_CLOCKS" in cuda_build._flags(("QM_SWEEP_PHASE_CLOCKS",))


def test_editing_a_header_changes_the_library_path(monkeypatch, tmp_path):
    (tmp_path / "kern.cu").write_text('#include "warp.cuh"\n')
    (tmp_path / "warp.cuh").write_text("// v1\n")
    monkeypatch.setattr(cuda_build, "CSRC", str(tmp_path))
    before = cuda_build._library_path("kern")
    assert before == cuda_build._library_path("kern")
    (tmp_path / "warp.cuh").write_text("// v2\n")
    after = cuda_build._library_path("kern")
    assert after != before and after.startswith(compile_cache.build_dir())
    (tmp_path / "kern.cu").write_text('#include "warp.cuh"\n// edited\n')
    assert cuda_build._library_path("kern") not in (before, after)


def _fake_csrc(monkeypatch, tmp_path):
    """A csrc/ with one source and a build directory, both under tmp_path."""
    (tmp_path / "csrc").mkdir()
    (tmp_path / "csrc" / "kern.cu").write_text("// kernel\n")
    monkeypatch.setattr(cuda_build, "CSRC", str(tmp_path / "csrc"))
    monkeypatch.setattr(compile_cache, "_dir", str(tmp_path / "build"))
    return cuda_build._library_path("kern")


def test_a_reused_library_returns_its_kept_ptxas_report(monkeypatch, tmp_path):
    lib = _fake_csrc(monkeypatch, tmp_path)
    (tmp_path / "build").mkdir()
    open(lib, "w").close()
    with open(cuda_build.report_path(lib), "w") as f:
        f.write("ptxas info    : Used 128 registers\n")
    monkeypatch.setattr(cuda_build, "_nvcc", lambda: pytest.fail("rebuilt a complete library"))
    assert cuda_build.build("kern") == "ptxas info    : Used 128 registers\n"


def test_a_library_without_its_report_is_rebuilt_and_keeps_the_report(monkeypatch, tmp_path):
    import subprocess

    lib = _fake_csrc(monkeypatch, tmp_path)
    (tmp_path / "build").mkdir()
    open(lib, "w").close()  # built before reports were kept
    calls = []

    def fake_nvcc(cmd, **kwargs):
        calls.append(cmd)
        open(cmd[cmd.index("-o") + 1], "w").close()
        return subprocess.CompletedProcess(cmd, 0, stdout="0 bytes spill stores\n")

    monkeypatch.setattr(cuda_build, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(cuda_build.subprocess, "run", fake_nvcc)
    assert cuda_build.build("kern") == "0 bytes spill stores\n"
    assert len(calls) == 1 and cuda_build.report_path(lib).endswith(".ptxas.txt")
    with open(cuda_build.report_path(lib)) as f:
        assert f.read() == "0 bytes spill stores\n"
    assert cuda_build.build("kern") == "0 bytes spill stores\n" and len(calls) == 1
    assert sorted(p.name for p in (tmp_path / "build").iterdir()) == sorted(
        [os.path.basename(lib), os.path.basename(cuda_build.report_path(lib))])
