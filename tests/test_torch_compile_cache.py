"""The port's build-cache switch (qm_door_torch/utils/compile_cache.py):
QM_COMPILE_CACHE_DIR moves every library of the port (the g++ host runtime
builds here; the CUDA kernels' paths follow the same directory) and a second
process reuses what the first built; QM_NO_COMPILE_CACHE=1 builds into a
directory of the process's own that is gone after it exits."""
import json
import os
import subprocess
import sys
import tempfile

import pytest

from qm_door_torch import native
from qm_door_torch.ops import cuda_build
from qm_door_torch.utils import compile_cache

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD_NATIVE = (
    "import json\n"
    "from qm_door_torch.utils import compile_cache\n"
    "on = compile_cache.enable_persistent_cache()\n"
    "from qm_door_torch import native\n"
    "path = native.build()\n"
    "mb = native.Mailbox(16)\n"
    "assert mb.write(b'ok') == 2 and mb.read() == (2, b'ok')\n"
    "print(json.dumps({'on': on, 'path': path, 'dir': compile_cache.build_dir(),\n"
    "                  'counts': compile_cache.build_counts()}))\n"
)


def _run(env_update):
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONSTARTUP", "QM_NO_COMPILE_CACHE", "QM_COMPILE_CACHE_DIR")}
    env.update(env_update)
    out = subprocess.run([sys.executable, "-c", BUILD_NATIVE], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_the_cache_directory_holds_and_serves_the_libraries(tmp_path):
    cache = tmp_path / "cache"
    first = _run({"QM_COMPILE_CACHE_DIR": str(cache)})
    assert first["on"] is True and first["dir"] == str(cache)
    assert os.path.dirname(first["path"]) == str(cache) and os.path.exists(first["path"])
    assert first["counts"] == {"built": 1, "reused": 0}
    mtime = os.stat(first["path"]).st_mtime_ns
    second = _run({"QM_COMPILE_CACHE_DIR": str(cache)})
    assert second["path"] == first["path"] and second["counts"] == {"built": 0, "reused": 1}
    assert os.stat(second["path"]).st_mtime_ns == mtime
    assert sorted(os.listdir(cache)) == [os.path.basename(first["path"])]


def test_no_cache_builds_into_a_private_directory_gone_at_exit(tmp_path):
    cache = tmp_path / "cache"
    out = _run({"QM_NO_COMPILE_CACHE": "1", "QM_COMPILE_CACHE_DIR": str(cache),
                "TMPDIR": str(tmp_path)})
    assert out["on"] is False and out["counts"] == {"built": 1, "reused": 0}
    private = out["dir"]
    assert os.path.dirname(out["path"]) == private
    assert private.startswith(str(tmp_path)) and private != str(cache)
    assert not os.path.exists(private) and not cache.exists()
    assert os.listdir(tmp_path) == []


def test_every_build_follows_the_switch(monkeypatch, tmp_path):
    monkeypatch.setattr(compile_cache, "_dir", None)  # not switched yet
    monkeypatch.delenv("QM_NO_COMPILE_CACHE", raising=False)
    monkeypatch.delenv("QM_COMPILE_CACHE_DIR", raising=False)
    assert compile_cache.build_dir() == os.path.join(ROOT, "build", "qm_door_torch")
    monkeypatch.setenv("QM_COMPILE_CACHE_DIR", str(tmp_path / "env"))
    assert compile_cache.enable_persistent_cache() is True
    for path in (cuda_build._library_path("spd_solve"), native.library_path()):
        assert os.path.dirname(path) == str(tmp_path / "env")
    assert compile_cache.enable_persistent_cache(str(tmp_path / "arg")) is True
    assert os.path.dirname(cuda_build._library_path("lq_forward")) == str(tmp_path / "arg")
    monkeypatch.setenv("QM_NO_COMPILE_CACHE", "1")
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path / "tmp"))
    (tmp_path / "tmp").mkdir()
    assert compile_cache.enable_persistent_cache() is False
    private = compile_cache.build_dir()
    assert private.startswith(str(tmp_path / "tmp"))
    for path in (cuda_build._library_path("riccati_bwd"), native.library_path()):
        assert os.path.dirname(path) == private


@pytest.mark.parametrize("built", [True, False])
def test_a_library_counts_once(monkeypatch, built):
    monkeypatch.setattr(compile_cache, "_seen", {})
    compile_cache.note_build("/x/liba.so", built)
    compile_cache.note_build("/x/liba.so", not built)  # a later load of the same library
    compile_cache.note_build("/x/libb.so", False)
    assert compile_cache.build_counts() == {"built": int(built), "reused": 2 - int(built)}
