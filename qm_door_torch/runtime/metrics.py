"""Metrics / observability (port of qm_door_tpu/runtime/metrics.py, pure
Python, unchanged).

Replaces the reference's benchmark::RepeatedTimer pairs around advanceMpc /
wbc update (QMController.cpp:146-148, 322-324, printed at shutdown
QMController.cpp:348-356) and its rqt_multiplot observation channels with a
structured metrics registry: wall-clock timers (max/avg like RepeatedTimer),
counters, and a trajectory recorder that dumps JSONL for offline plotting.
"""
from __future__ import annotations

import json
import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List


@dataclass
class RepeatedTimer:
    """max/avg interval timer (ocs2::benchmark::RepeatedTimer equivalent)."""

    total: float = 0.0
    count: int = 0
    max_interval: float = 0.0
    _t0: float = field(default=0.0, repr=False)

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self):
        dt = time.perf_counter() - self._t0
        self.total += dt
        self.count += 1
        self.max_interval = max(self.max_interval, dt)
        return dt

    @property
    def average_ms(self):
        return 1e3 * self.total / max(self.count, 1)

    @property
    def max_ms(self):
        return 1e3 * self.max_interval

    def summary(self):
        return {"avg_ms": round(self.average_ms, 4), "max_ms": round(self.max_ms, 4),
                "count": self.count}


class Metrics:
    """Process-wide registry: timers, counters, gauges."""

    def __init__(self):
        self.timers: Dict[str, RepeatedTimer] = defaultdict(RepeatedTimer)
        self.counters: Dict[str, float] = defaultdict(float)
        self.gauges: Dict[str, float] = {}

    def timer(self, name: str) -> RepeatedTimer:
        return self.timers[name]

    def count(self, name: str, inc: float = 1.0):
        self.counters[name] += inc

    def gauge(self, name: str, value: float):
        self.gauges[name] = float(value)

    def summary(self) -> dict:
        return {
            "timers": {k: t.summary() for k, t in self.timers.items()},
            "counters": dict(self.counters),
            "gauges": dict(self.gauges),
        }

    def report(self) -> str:
        """Shutdown report (the reference prints MPC/WBC max/avg ms)."""
        lines = []
        for name, t in self.timers.items():
            lines.append(
                f"### {name}: max {t.max_ms:.3f} ms, avg {t.average_ms:.3f} ms "
                f"({t.count} calls)"
            )
        for name, v in self.counters.items():
            lines.append(f"### {name}: {v}")
        return "\n".join(lines)


class TrajectoryRecorder:
    """JSONL trajectory dump: the observation/EE/joint channels the reference
    publishes to rqt_multiplot (qm_controllers/config/rqt_multiplot.xml)."""

    def __init__(self):
        self.rows: List[dict] = []

    def record(self, t, **channels):
        row = {"t": float(t)}
        for k, v in channels.items():
            try:
                row[k] = [float(x) for x in v]
            except TypeError:
                row[k] = float(v)
        self.rows.append(row)

    def dump(self, path: str):
        with open(path, "w") as f:
            for row in self.rows:
                f.write(json.dumps(row) + "\n")
