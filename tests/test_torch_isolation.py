"""The torch port stands alone: qm_door_torch and chip_smoke.py import
neither JAX, flax nor the JAX package (qm_door_tpu)."""
import ast
import os
import pkgutil
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "qm_door_tpu")


def _port_modules():
    import qm_door_torch

    names = ["qm_door_torch"]
    for info in pkgutil.walk_packages(qm_door_torch.__path__, "qm_door_torch."):
        names.append(info.name)
    return sorted(names)


def _forbidden(name):
    return name.split(".")[0] in FORBIDDEN


def test_importing_every_port_module_loads_no_jax():
    mods = _port_modules()
    assert len(mods) > 15
    # only what the port's imports load counts: a site hook may preload
    # modules of its own (the AST scan below covers the port's sources)
    code = (
        "import importlib, json, sys\n"
        "before = set(sys.modules)\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "print(json.dumps(sorted(set(sys.modules) - before)))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    import json

    loaded = json.loads(out.stdout.strip().splitlines()[-1])
    assert "qm_door_torch.solver.batched_sqp" in loaded
    assert [m for m in loaded if _forbidden(m)] == []


def _sources():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, names in os.walk(os.path.join(ROOT, "qm_door_torch")):
        files += [os.path.join(dirpath, n) for n in names if n.endswith(".py")]
    return sorted(files)


@pytest.mark.parametrize("path", _sources(), ids=lambda p: os.path.relpath(p, ROOT))
def test_source_has_no_jax_import(path):
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            if _forbidden(node.module):
                bad.append(node.module)
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", getattr(
                node.func, "id", None)) in ("import_module", "__import__"):
            args = [a.value for a in node.args if isinstance(a, ast.Constant)]
            bad += [a for a in args if isinstance(a, str) and _forbidden(a)]
    assert bad == []
