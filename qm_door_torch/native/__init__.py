"""ctypes bindings of the host-runtime library (port of
qm_door_tpu/native/__init__.py), built from this package's own copy of
``src/qm_native.cpp``.

``Mailbox``: a wait-free seqlock single-producer / single-consumer blob
handoff (MPC policy -> control loop; the RealtimeBuffer / MRT policy-mutex
role of the reference). ``PeriodicTimer``: an absolute-deadline periodic
sleeper (ocs2 executeAndSleep): a deadline missed by more than a period is
skipped and counted as an overrun.

At first use the source is compiled with ``g++ -O2 -std=c++17 -shared
-fPIC ... -lpthread`` into ``libqm_native-<hash>.so`` in the build cache
(``utils/compile_cache.py:build_dir``: by default ``build/qm_door_torch`` at
the repository root, listed in .gitignore), the hash covering the source
and the flags, and loaded with ctypes. Nothing falls back: a failed build
or load raises. ``MailboxPlain`` and ``PeriodicTimerPlain`` are the same
contracts in pure Python, reached only by name (the tests hold the library
to them).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import time

from ..utils import compile_cache

_HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(_HERE, "src", "qm_native.cpp")
# portable baseline ISA: a library copied to another host must not need the
# build host's extensions
GXX_FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC")

_lock = threading.Lock()
_lib = None


def library_path() -> str:
    """Where the library built from the current source and flags lies."""
    digest = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    with open(SRC, "rb") as f:
        digest.update(f.read())
    return os.path.join(compile_cache.build_dir(), f"libqm_native-{digest.hexdigest()[:12]}.so")


def build() -> str:
    """Compile the source unless its library is there; returns its path.
    Raises RuntimeError when g++ fails."""
    path = library_path()
    if os.path.exists(path):
        compile_cache.note_build(path, False)
        return path
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
    proc = subprocess.run(["g++", *GXX_FLAGS, SRC, "-o", tmp, "-lpthread"],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"native library build failed: g++ exited {proc.returncode}\n"
                           f"{proc.stdout}")
    os.replace(tmp, path)
    compile_cache.note_build(path, True)
    return path


def load() -> ctypes.CDLL:
    """The loaded library (built first if needed), its signatures set."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(build())
        u64, i64, vp = ctypes.c_uint64, ctypes.c_int64, ctypes.c_void_p
        for name, restype, argtypes in (
                ("qm_mailbox_create", vp, [u64]),
                ("qm_mailbox_destroy", None, [vp]),
                ("qm_mailbox_write", u64, [vp, ctypes.c_char_p, u64]),
                ("qm_mailbox_read", u64, [vp, ctypes.c_char_p, u64, ctypes.POINTER(u64)]),
                ("qm_timer_create", vp, [i64]),
                ("qm_timer_destroy", None, [vp]),
                ("qm_timer_wait", i64, [vp]),
                ("qm_timer_ticks", u64, [vp]),
                ("qm_timer_overruns", u64, [vp])):
            fn = getattr(lib, name)
            fn.restype, fn.argtypes = restype, argtypes
        _lib = lib
        return lib


class Mailbox:
    """Latest-value mailbox for byte blobs of at most ``capacity`` bytes,
    one writer and one reader (the C++ seqlock)."""

    def __init__(self, capacity: int):
        self.capacity = capacity
        self._lib = load()
        self._h = self._lib.qm_mailbox_create(capacity)
        if not self._h:
            raise MemoryError(f"Mailbox: no memory for {capacity} bytes")
        self._buf = ctypes.create_string_buffer(capacity)

    def write(self, blob: bytes) -> int:
        """Publish ``blob``; returns its sequence number (even, rising)."""
        if len(blob) > self.capacity:
            raise ValueError(f"Mailbox: {len(blob)} bytes > capacity {self.capacity}")
        return int(self._lib.qm_mailbox_write(self._h, blob, len(blob)))

    def read(self):
        """(seq, blob) of the latest publication; (0, b'') if none yet."""
        out_len = ctypes.c_uint64(0)
        seq = int(self._lib.qm_mailbox_read(self._h, self._buf, self.capacity,
                                            ctypes.byref(out_len)))
        if seq == 0:
            return 0, b""
        return seq, self._buf.raw[:out_len.value]

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.qm_mailbox_destroy(self._h)
            self._h = None


class PeriodicTimer:
    """Absolute-deadline periodic sleeper with overrun counts (the C++
    timer)."""

    def __init__(self, period_s: float):
        self.period_s = period_s
        self._lib = load()
        self._h = self._lib.qm_timer_create(int(period_s * 1e9))
        if not self._h:
            raise MemoryError("PeriodicTimer: no memory")

    def wait(self) -> float:
        """Sleep until the next deadline; returns the lag in seconds."""
        return self._lib.qm_timer_wait(self._h) * 1e-9

    @property
    def ticks(self) -> int:
        return int(self._lib.qm_timer_ticks(self._h))

    @property
    def overruns(self) -> int:
        return int(self._lib.qm_timer_overruns(self._h))

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.qm_timer_destroy(self._h)
            self._h = None


class MailboxPlain:
    """:class:`Mailbox`'s contract in pure Python (a lock and a cell)."""

    def __init__(self, capacity: int):
        self.capacity = capacity
        self._lock = threading.Lock()
        self._seq, self._blob = 0, b""

    def write(self, blob: bytes) -> int:
        if len(blob) > self.capacity:
            raise ValueError(f"MailboxPlain: {len(blob)} bytes > capacity {self.capacity}")
        with self._lock:
            self._seq += 2
            self._blob = bytes(blob)
            return self._seq

    def read(self):
        with self._lock:
            return self._seq, self._blob


class PeriodicTimerPlain:
    """:class:`PeriodicTimer`'s contract in pure Python: a deadline missed
    by more than a period is skipped (the clock resynchronizes) and counted."""

    def __init__(self, period_s: float):
        self.period_s = period_s
        self._next = time.monotonic()
        self.ticks = 0
        self.overruns = 0

    def wait(self) -> float:
        self._next += self.period_s
        lag = time.monotonic() - self._next
        if lag > self.period_s:
            self.overruns += 1
            self._next += lag
        else:
            time.sleep(max(self._next - time.monotonic(), 0.0))
            lag = max(time.monotonic() - self._next, 0.0)
        self.ticks += 1
        return lag
