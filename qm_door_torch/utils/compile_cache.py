"""Where the port's compiled libraries live: the persistent build cache and
its switch (port of qm_door_tpu/utils/compile_cache.py).

The port compiles no XLA graphs. What it builds are shared libraries: every
CUDA kernel source with nvcc (``ops/cuda_build.py``) and the host runtime
with g++ (``native/``), each named by a hash of its sources and flags and
reused while that hash holds. This module holds the one directory both
build steps read (:func:`build_dir`), and :func:`enable_persistent_cache`
sets it:

- on (the default): ``cache_dir`` if given, else ``QM_COMPILE_CACHE_DIR``
  if set, else ``build/qm_door_torch`` at the repository root; the
  libraries persist there and a later process reuses them;
- ``QM_NO_COMPILE_CACHE=1``: a directory private to the process, deleted at
  its exit, so every library is built anew.

If nothing calls the switch, the first build calls it with the
environment. The JAX package's single-writer flock is not needed here: a
library is compiled to a temporary name of its own and moved into place
with ``os.replace``, so concurrent builds of one library each leave a
complete file, and a reader never sees a partial one.

Usage (chip_smoke.py, as bench.py uses the JAX module): call
``enable_persistent_cache()`` before the first build. Returns True if the
cache is on.
"""
from __future__ import annotations

import atexit
import os
import shutil
import tempfile
import threading

DEFAULT_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "build", "qm_door_torch")

_lock = threading.Lock()
_dir = None        # the directory every build reads and writes; None: not switched yet
_seen = {}         # library path -> whether this process built it


def enable_persistent_cache(cache_dir: str | None = None) -> bool:
    """Point every build of the process at the cache directory (True) or,
    with ``QM_NO_COMPILE_CACHE=1``, at a private directory deleted at exit
    (False)."""
    global _dir
    with _lock:
        if os.environ.get("QM_NO_COMPILE_CACHE") == "1":
            private = tempfile.mkdtemp(prefix="qm_door_torch_build-")
            owner = os.getpid()
            # a forked child inherits the hook; only the process that made
            # the directory removes it
            atexit.register(lambda: os.getpid() == owner and shutil.rmtree(private, True))
            _dir = private
            return False
        _dir = os.path.abspath(cache_dir or os.environ.get("QM_COMPILE_CACHE_DIR") or DEFAULT_DIR)
        os.makedirs(_dir, exist_ok=True)
        return True


def build_dir() -> str:
    """The directory every library of the port is built into and loaded
    from (the switch is set from the environment at the first call if no
    one set it)."""
    if _dir is None:
        enable_persistent_cache()
    return _dir


def note_build(path: str, built: bool) -> None:
    """Note that the library at ``path`` was built anew (True) or found in
    the cache (False); the first note of a path counts."""
    with _lock:
        _seen.setdefault(path, built)


def build_counts() -> dict:
    """{"built": n, "reused": m}: the libraries this process built and those
    it found already built."""
    with _lock:
        built = sum(_seen.values())
        return {"built": built, "reused": len(_seen) - built}
