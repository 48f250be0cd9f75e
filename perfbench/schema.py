"""Checks of BENCHMARK.json that the harness makes before a run: names,
units and the references between entries."""
from __future__ import annotations

import re

NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")


def validate(bench) -> None:
    """Raise ValueError at the first entry of ``bench`` that breaks a rule."""
    def name(kind, value):
        if not isinstance(value, str) or not NAME.fullmatch(value):
            raise ValueError(f"{kind} {value!r}: a name is 1-64 of A-Z a-z 0-9 _ . - "
                             "and starts with a letter, a digit or _")

    configs = {c["name"] for c in bench["configs"]}
    for c in bench["configs"]:
        name("config", c["name"])
        for key in c["reduced"]:
            name("reduced key", key)
    cells = set()
    for w in bench["workloads"]:
        for kind in ("name", "config", "traffic"):
            name(f"workload {kind}", w[kind])
        if w["config"] not in configs:
            raise ValueError(f"workload {w['name']!r}: no configuration {w['config']!r}")
        if w["chips"] not in (1, 4):
            raise ValueError(f"workload {w['name']!r}: chips {w['chips']!r}, not 1 or 4")
        cells.add(w["name"])
    e2e = {m["name"] for m in bench["end_to_end"]}
    for key in ("end_to_end", "per_layer"):
        for m in bench[key]:
            name("metric", m["name"])
            if not isinstance(m["unit"], str) or not UNIT.fullmatch(m["unit"]):
                raise ValueError(f"metric {m['name']!r}: unit {m['unit']!r} is not 1-16 of "
                                 "A-Z a-z 0-9 _ / % . -")
            if m["better"] not in ("lower", "higher") or m["source"] not in SOURCES:
                raise ValueError(f"metric {m['name']!r}: better / source")
            if key == "per_layer" and m["moves"] not in e2e:
                raise ValueError(f"metric {m['name']!r}: moves {m['moves']!r}, no such "
                                 "end-to-end metric")
            for cell in m.get("workloads", ()):
                if cell not in cells:
                    raise ValueError(f"metric {m['name']!r}: no workload {cell!r}")
    reports = {m["name"]: set(m.get("workloads", cells)) for m in bench["end_to_end"]}
    for m in bench["per_layer"]:
        missing = set(m.get("workloads", cells)) - reports[m["moves"]]
        if missing:
            raise ValueError(f"metric {m['name']!r} moves {m['moves']!r}, which "
                             f"{sorted(missing)} do not report")
    for cell in cells:
        own = [name for name, where in reports.items() if cell in where]
        if "setup_s" not in own or len(own) < 2:
            raise ValueError(f"workload {cell!r}: reports {own}, not setup_s and another")
        if not any(cell in m.get("workloads", cells) for m in bench["per_layer"]):
            raise ValueError(f"workload {cell!r}: no per-layer metric")
