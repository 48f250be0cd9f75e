"""Build and load the port's CUDA kernels, and the checks their wrappers
make around a launch.

Each ``qm_door_torch/csrc/<name>.cu`` exposes a plain C interface. At first
use it is compiled with ``nvcc`` for ``sm_90a`` into ``lib<name>-<hash>.so``
in the build cache (``utils/compile_cache.py:build_dir``: by default
``build/qm_door_torch`` at the repository root, listed in .gitignore) and
loaded with ctypes; nvcc's ptxas report is kept
beside it (``.ptxas.txt``). The hash covers the source, every header of
``csrc/`` (``*.cuh``, which a source may include) and the flags, so a
library is reused only while none of them has changed.

A wrapper asks :func:`on_cuda` whether to launch (CUDA tensors) or to run
its plain version (CPU tensors), hands the C function's return code to
:func:`check_launch`, and counts the launch with :func:`count_launch`.
Nothing falls back: a CUDA tensor the kernel cannot take raises before the
launch, a refused launch raises after it.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

import torch

from ..utils import compile_cache

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
# --split-compile=0: nvcc optimizes a source's kernels in parallel (K1's
# long straight-line reg64 kernels build in about half the time)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "--split-compile=0")

_lock = threading.Lock()  # guards the two dicts below
_build_locks: dict = {}    # one per library: different sources build in parallel
_libs: dict = {}


def _nvcc() -> str:
    for home in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH")):
        if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
            return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")


def _flags(defines) -> tuple:
    return NVCC_FLAGS + tuple(f"-D{d}" for d in defines)


def _library_path(name: str, defines=()) -> str:
    digest = hashlib.sha256(" ".join(_flags(defines)).encode())
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))
    for fname in [f"{name}.cu"] + headers:
        with open(os.path.join(CSRC, fname), "rb") as f:
            digest.update(fname.encode() + b"\0" + f.read())
    return os.path.join(compile_cache.build_dir(), f"lib{name}-{digest.hexdigest()[:12]}.so")


def report_path(library: str) -> str:
    """Where the ptxas report of ``library`` is kept, beside it."""
    return library[:-len(".so")] + ".ptxas.txt"


def build(name: str, defines=()) -> str:
    """Compile ``csrc/<name>.cu`` (with ``-D`` for each of ``defines``, a
    diagnostic variant) unless its library and the library's ptxas report
    are both there. Returns nvcc's output (the ptxas register, spill and
    shared-memory report), kept beside the library and read back when the
    library is reused. Calls for different sources may run in parallel
    threads."""
    key = (name, tuple(defines))
    with _lock:
        lock = _build_locks.setdefault(key, threading.Lock())
    with lock:
        path = _library_path(name, defines)
        report = report_path(path)
        if os.path.exists(path) and os.path.exists(report):
            compile_cache.note_build(path, False)
            with open(report) as f:
                return f.read()
        nvcc = _nvcc()
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = f"{path}.{os.getpid()}.tmp"
        proc = subprocess.run([nvcc, *_flags(defines), "-o", tmp,
                               os.path.join(CSRC, f"{name}.cu")],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"CUDA kernel build failed: {name}: nvcc exited "
                               f"{proc.returncode}\n{proc.stdout}")
        with open(f"{report}.{os.getpid()}.tmp", "w") as f:
            f.write(proc.stdout)
        os.replace(f"{report}.{os.getpid()}.tmp", report)
        os.replace(tmp, path)
        compile_cache.note_build(path, True)
        return proc.stdout


def load(name: str, defines=()) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` (built with ``defines``),
    built first if needed."""
    key = (name, tuple(defines))
    lib = _libs.get(key)
    if lib is None:
        build(name, defines)
        with _lock:
            lib = _libs.setdefault(key, ctypes.CDLL(_library_path(name, defines)))
    return lib


CUDA_ERROR_INVALID_VALUE = 1  # cudaErrorInvalidValue: a launch the kernel refuses


def on_cuda(name: str, *tensors) -> bool:
    """True for CUDA tensors (launch the kernel), False for CPU tensors (run
    the plain version). Raises ValueError for mixed devices or dtypes,
    another device, or a non-contiguous CUDA tensor, and TypeError for a
    CUDA dtype other than float32."""
    first = tensors[0]
    if any(t.device != first.device or t.dtype != first.dtype for t in tensors):
        raise ValueError(f"{name}: all inputs must share device and dtype")
    if first.device.type == "cpu":
        return False
    if first.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {first.device}")
    if first.dtype != torch.float32:
        raise TypeError(f"{name}: the CUDA kernel takes float32, not {first.dtype}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: the CUDA kernel takes contiguous tensors")
    return True


_count_lock = threading.Lock()  # guards every wrapper's launch counters


def count_launch(wrapper, variant=None, shape=None) -> None:
    """Add one launch to ``wrapper.launches`` and, where given, to
    ``wrapper.launches_by_variant[variant]`` and
    ``wrapper.launches_by_shape[shape]``, under one lock for every
    wrapper: threads that launch at once (the MPC thread beside the
    control loop) lose no count. The launch itself is made outside it."""
    with _count_lock:
        wrapper.launches += 1
        if variant is not None:
            wrapper.launches_by_variant[variant] += 1
        if shape is not None:
            wrapper.launches_by_shape[shape] = wrapper.launches_by_shape.get(shape, 0) + 1


def check_launch(name: str, err: int, what: str = "") -> None:
    """Raise for a non-zero return code of a kernel's C function."""
    if err == CUDA_ERROR_INVALID_VALUE:
        raise ValueError(f"{name}: the kernel refused the launch{what}")
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error {err}")
