"""What the benchmark's processes load: the port and never JAX or the JAX
package; the reference nothing of the port."""
import ast
import json
import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
FORBIDDEN = {"jax", "jaxlib", "flax", "qm_door_tpu"}
CPU_RUN = """
import json, sys
sys.path.insert(0, {root!r})
from perfbench import run
rc = run.main(["--workload", "trot-farm-b1024", "--seed", "3", "--seconds", "0.5",
               "--trace", "0"], device="cpu", batch=2)
print(json.dumps({{"rc": rc, "top": sorted({{n.split(".")[0] for n in sys.modules}})}}))
"""


def _last_json(stdout):
    return json.loads(stdout.strip().splitlines()[-1])


def test_a_run_loads_the_port_and_no_jax():
    out = subprocess.run([sys.executable, "-c", CPU_RUN.format(root=ROOT)], cwd=ROOT,
                         capture_output=True, text=True, timeout=600,
                         env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode == 0, out.stderr[-3000:]
    got = _last_json(out.stdout)
    assert got["rc"] == 0
    assert "qm_door_torch" in got["top"]
    assert not FORBIDDEN & set(got["top"])


def test_the_command_without_a_card_prints_no_result():
    out = subprocess.run([sys.executable, "perfbench/run.py", "--workload", "trot-farm-b1024",
                          "--seed", str(2 ** 31 + 5), "--seconds", "1", "--trace", "0"],
                         cwd=ROOT, capture_output=True, text=True, timeout=300,
                         env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_without_the_program_a_run_fails(tmp_path):
    """In a directory with only BENCHMARK.json and the benchmark's files."""
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "perfbench"), tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = CPU_RUN.format(root=str(tmp_path))
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                         text=True, timeout=300, env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0
    assert "qm_door_torch" in out.stderr


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_the_reference_imports_nothing_of_the_port():
    ref = os.path.join(ROOT, "perfbench", "reference")
    names = {n.split(".")[0] for f in os.listdir(ref) if f.endswith(".py")
             for n in _imports(os.path.join(ref, f))}
    assert not names & (FORBIDDEN | {"qm_door_torch"})
    code = ("import sys; sys.path.insert(0, %r); import perfbench.correct, perfbench.control;"
            "print(sorted({n.split('.')[0] for n in sys.modules}))" % ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    loaded = set(eval(out.stdout.strip().splitlines()[-1]))
    assert not loaded & (FORBIDDEN | {"qm_door_torch"})
