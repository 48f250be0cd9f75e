"""The torch port stands alone: qm_door_torch, chip_smoke.py and the port's
other root scripts (PORT_SCRIPTS) import neither JAX, flax nor the JAX
package (qm_door_tpu), and the port reads its
own copies of the assets (the robot and the collision worlds). And no kernel wrapper
gives way: nothing in ``qm_door_torch/ops`` catches an exception, so a
launch error can only raise."""
import ast
import os
import pkgutil
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "qm_door_tpu")
# the port's scripts at the repository's root, each run on the card
PORT_SCRIPTS = ("chip_smoke.py", "trot_2s.py", "side_paths.py", "k1_launch_shapes.py",
                "lq_launch_shapes.py", "sweep_launch_shapes.py", "door_run.py")


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
    for name in ("qm_door_torch.solver.batched_sqp", "qm_door_torch.wbc.wbc",
                 "qm_door_torch.wbc.force", "qm_door_torch.sim.terrain",
                 "qm_door_torch.sim.world", "qm_door_torch.sim.sim",
                 "qm_door_torch.sim.batched_rollout", "qm_door_torch.runtime.mrt",
                 "qm_door_torch.runtime.safety", "qm_door_torch.runtime.controller",
                 "qm_door_torch.estimation.base", "qm_door_torch.estimation.kalman",
                 "qm_door_torch.sim.closed_loop", "qm_door_torch.sim.door",
                 "qm_door_torch.sim.door_loop", "qm_door_torch.scenarios",
                 "qm_door_torch.runtime.gait_command", "qm_door_torch.runtime.planner"):
        assert name in loaded
    assert [m for m in loaded if _forbidden(m)] == []


def _sources():
    files = [os.path.join(ROOT, name) for name in PORT_SCRIPTS]
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


def _ops_sources():
    ops = os.path.join(ROOT, "qm_door_torch", "ops")
    return sorted(os.path.join(ops, n) for n in os.listdir(ops) if n.endswith(".py"))


@pytest.mark.parametrize("path", _ops_sources(), ids=lambda p: os.path.relpath(p, ROOT))
def test_no_wrapper_catches_a_launch_error(path):
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    handlers = [node.lineno for node in ast.walk(tree)
                if isinstance(node, (ast.Try, getattr(ast, "TryStar", ast.Try)))]
    assert handlers == [], f"try/except at lines {handlers}"


@pytest.mark.parametrize("asset,module,attr", [
    ("aliengo_z1.json", "qm_door_torch.models.model", "_ASSET"),
    ("worlds.json", "qm_door_torch.sim.world", "_ASSET"),
])
def test_assets_are_the_ports_own_copies(asset, module, attr):
    """Each asset the port reads lies in qm_door_torch/assets, and holds what
    the JAX package's copy holds."""
    import importlib

    path = os.path.realpath(getattr(importlib.import_module(module), attr))
    assert path == os.path.join(ROOT, "qm_door_torch", "assets", asset)
    with open(path, "rb") as ours, open(os.path.join(ROOT, "qm_door_tpu", "assets", asset),
                                        "rb") as theirs:
        assert ours.read() == theirs.read()
