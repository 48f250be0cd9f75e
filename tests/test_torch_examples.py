"""The port's four example scripts (examples/*_torch.py), each run in-process
through its main(argv) on the CPU in float64 at the shortest window that
holds a solve and a tick (0.002 s: the two solves at t = 0 and one tick;
the trot 0.01 s, five ticks, for the golden): safe, every row finite, each
figure written. trot_demo_torch is the golden trot's set-up, so its rows are
held to the golden trace's first rows (chip_smoke.TROT_BARS). Without
--device cpu and without CUDA each raises."""
import importlib
import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "examples"))
sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402

# one intra-op thread, as every port test file (tests/torch_parity.py)
torch.set_num_threads(1)

# name -> (arguments before the window, window, figures written)
EXAMPLES = {
    "trot_demo_torch": ([], "0.01", ("trot_demo.png", "trot_report.png")),
    "door_demo_torch": ([], "0.002", ("door_demo.png",)),
    "ee_tracking_demo_torch": ([], "0.002", ("ee_tracking_report.png",)),
    "scenario_demo_torch": (["stairs"], "0.002", ("stairs_report.png",)),
}
ROW_FIELDS = {"door_demo_torch": ("t", "panel", "lever", "base_pose", "feet_z", "ee_pos")}


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_runs_on_the_cpu(name, tmp_path):
    before, _, _ = EXAMPLES[name]
    out = tmp_path
    log = importlib.import_module(name).main(
        before + [EXAMPLES[name][1], "--device", "cpu", "--out", str(out)])
    window = float(EXAMPLES[name][1])
    assert log.safe
    assert len(log.t) == int(round(window / 0.002)) and log.t[0] == 0.0
    for field in ROW_FIELDS.get(name, ("t", "base_pose", "x_obs", "tau", "ee_pos")):
        rows = np.asarray(getattr(log, field), dtype=float)
        assert np.isfinite(rows).all(), field
    assert np.asarray(log.base_pose).dtype == np.float64
    for fig in EXAMPLES[name][2]:
        assert (out / fig).stat().st_size > 0, fig
    if name == "trot_demo_torch":  # the golden trot's set-up: held to its first rows
        rows = [chip_smoke.json.loads(line)
                for line in open(chip_smoke.TROT_GOLDEN)][:len(log.t)]
        line = chip_smoke.trot_check(log, rows, name)
        assert line["deviation"]["rows"] == 5


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_needs_cuda_unless_asked_for_the_cpu(name, monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    before, window, _ = EXAMPLES[name]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        importlib.import_module(name).main(before + [window, "--out", str(tmp_path)])
    assert os.listdir(tmp_path) == []


def test_no_figures_runs_and_draws_nothing(tmp_path):
    """--no-figures (a host without matplotlib, as the card's may be): the
    run and its prints, no figure and no output directory."""
    log = importlib.import_module("ee_tracking_demo_torch").main(
        ["0.002", "--device", "cpu", "--out", str(tmp_path / "figures"), "--no-figures"])
    assert log.safe and len(log.t) == 1
    assert os.listdir(tmp_path) == []
