"""BENCHMARK.json against the harness: names, units, and every
configuration, traffic and metric found by name."""
import copy
import json
import os
import sys

import pytest

from perfbench import harness, roofline, schema

ROOT = harness.ROOT


def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_benchmark_json_is_valid():
    schema.validate(bench())


@pytest.mark.parametrize("metric", [m["name"] for m in bench()["per_layer"]])
def test_every_metric_has_its_reader(metric):
    assert callable(harness.reader(metric).read)


@pytest.mark.parametrize("cell", [w["name"] for w in bench()["workloads"]])
def test_every_cell_resolves(cell):
    b, w, cfg, traffic = harness.cell_spec(cell)
    assert cfg["name"] == w["config"]
    assert hasattr(harness.generator(traffic["kind"]), "Stream")
    assert set(cfg["limits"]) == {"du_rel", "cost_rel", "viol_rel", "alpha_bad"}


@pytest.mark.parametrize("where,key,value", [
    ("workloads", "name", "trot farm"), ("workloads", "name", "trot/farm"),
    ("configs", "name", "a" * 65), ("per_layer", "name", "µs_share"),
    ("per_layer", "unit", "tokens per second"), ("end_to_end", "unit", "a" * 17),
    ("per_layer", "unit", "µs"), ("per_layer", "unit", ""),
])
def test_bad_name_or_unit_is_rejected(where, key, value):
    b = copy.deepcopy(bench())
    b[where][0][key] = value
    with pytest.raises(ValueError):
        schema.validate(b)


@pytest.mark.parametrize("change", ["moves_unreported", "no_second_rate", "no_per_layer"])
def test_a_cell_without_its_metrics_is_rejected(change):
    """Each per-layer metric moves an end-to-end metric that its cells
    report; each cell reports set-up, another end-to-end metric and a
    per-layer metric."""
    b = copy.deepcopy(bench())
    door = "door-press-b1024"
    if change == "moves_unreported":
        b["per_layer"][0]["workloads"] = [door]
    elif change == "no_second_rate":
        for m in b["end_to_end"]:
            if m["name"] != "setup_s":
                m["workloads"] = [w for w in m.get("workloads", [door]) if w != door]
        b["per_layer"] = [m for m in b["per_layer"] if door not in m["workloads"]]
    else:
        b["per_layer"] = [m for m in b["per_layer"] if door not in m["workloads"]]
    with pytest.raises(ValueError):
        schema.validate(b)


def test_units_may_hold_slash_and_percent():
    b = copy.deepcopy(bench())
    b["per_layer"][0]["unit"] = "launches/step"
    b["per_layer"][1]["unit"] = "%"
    schema.validate(b)


def test_a_cell_configuration_traffic_and_metric_added_as_files(tmp_path, monkeypatch):
    """A later change adds a cell with its configuration, traffic and
    metric as new files and entries; the harness finds each by name."""
    b = copy.deepcopy(bench())
    (tmp_path / "perfbench" / "configs").mkdir(parents=True)
    (tmp_path / "perfbench" / "traffic").mkdir()
    with open(os.path.join(ROOT, "perfbench", "configs", "aliengo-z1-trot.json")) as f:
        cfg = json.load(f)
    cfg["name"] = "aliengo-z1-trot-copy"
    (tmp_path / "perfbench" / "configs" / "aliengo-z1-trot-copy.json").write_text(json.dumps(cfg))
    with open(os.path.join(ROOT, "perfbench", "traffic", "mpc_stream.json")) as f:
        traffic = json.load(f)
    traffic["scenario_phase_stride"] = 7
    (tmp_path / "perfbench" / "traffic" / "mpc_stream_mixed.json").write_text(json.dumps(traffic))
    b["configs"].append({**b["configs"][0], "name": cfg["name"],
                         "file": "perfbench/configs/aliengo-z1-trot-copy.json"})
    b["workloads"].append({"name": "trot-mixed-b1024", "config": cfg["name"],
                           "traffic": "mpc_stream_mixed", "chips": 1, "why": "per-scenario phases"})
    for m in b["end_to_end"]:
        if m["name"] == "mpc_solves_per_s":
            m["workloads"].append("trot-mixed-b1024")
    b["per_layer"].append({"name": "new_counter", "unit": "n/step", "better": "lower",
                           "source": "program_counter", "layer": "MPC step",
                           "moves": "mpc_solves_per_s", "workloads": ["trot-mixed-b1024"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    metrics_dir = tmp_path / "metrics"
    metrics_dir.mkdir()
    (metrics_dir / "new_counter.py").write_text("def read(t):\n    return float(t.steps)\n")
    import perfbench.metrics

    monkeypatch.setattr(perfbench.metrics, "__path__", [*perfbench.metrics.__path__,
                                                        str(metrics_dir)])
    monkeypatch.delitem(sys.modules, "perfbench.metrics.new_counter", raising=False)
    got_b, cell, got_cfg, got_traffic = harness.cell_spec("trot-mixed-b1024", root=str(tmp_path))
    assert got_cfg["name"] == "aliengo-z1-trot-copy"
    assert got_traffic["scenario_phase_stride"] == 7
    names = [m["name"] for m in harness.metrics_of(got_b, cell, True)]
    assert "new_counter" in names
    assert [m["name"] for m in harness.metrics_of(got_b, got_b["workloads"][0], True)].count(
        "new_counter") == 0

    class T:
        steps = 3
    assert harness.reader("new_counter").read(T) == 3.0


def test_k1_byte_count():
    """The byte count of a K1 launch against the port's own records: the
    projection solve of (b) and the force-tracking gain solve."""
    assert roofline.spd_solve_bytes(25728, 12, 49) == 129_051_648
    assert roofline.spd_solve_bytes(384, 36, 31) == 4_451_328
    assert roofline.spd_solve_bound_s(25728, 12, 49) == 129_051_648 / roofline.HBM_BYTES_PER_S
