"""What a traced run reads: the profiler's raw events of the profiled steps,
reduced to the device's busy time, K1's kernel time and the top device
operations (steps traced on the device alone), device time and operations
by layer and the idle gaps by host range (steps traced with the host's
ranges), and the spans and counters of the whole traced window. The
per-layer metrics (``metrics/<name>.py``) read the :class:`TraceData` this
module makes.

The raw kineto events are read (as ``chip_smoke.py:device_busy`` does):
each device operation is tied to the host range it was launched in by the
correlation id of its runtime call, and the layer ranges are the profiler
annotations the benchmark puts around the step's layers.
"""
from __future__ import annotations

import re
from dataclasses import dataclass, field

LAYERS = ("linearize", "lq_stage", "linesearch")
STEP = "step"
# the runtime and driver calls that put an operation on the device
LAUNCH_CALLS = ("cudaLaunch", "cudaMemcpy", "cudaMemset", "cuLaunch", "cuMemcpy", "cuMemset",
                "cudaGraphLaunch")
K1_KERNEL = re.compile(r"spd_(solve|reg|reg64|blk128)_kernel")


@dataclass
class TraceData:
    step_ms: list = field(default_factory=list)      # unprofiled steps, host clock
    steps: int = 0                                   # steps of the traced window
    batch: int = 0                                   # solves a step
    span_ms: dict = field(default_factory=dict)      # layer -> host ms over the window
    linesearch_calls: int = 0                        # over the window
    profiled_steps: int = 0
    layer_device_ms: dict = field(default_factory=dict)
    layer_device_ops: dict = field(default_factory=dict)
    k1_kernel_s: float = 0.0                         # device time of K1's kernels
    k1_by_shape: dict = field(default_factory=dict)  # profiled steps' launches
    k1_launches: int = 0                             # profiled steps' launches
    busy_s: float = 0.0
    window_s: float = 0.0                            # the device-traced steps' wall time
    device_ops: list = field(default_factory=list)   # [[name, s], ...] top 10
    idle_gaps: list = field(default_factory=list)    # [[host range, s], ...] top 10


def _union_s(intervals):
    busy, end = 0, float("-inf")
    for start, stop in sorted(intervals):
        if stop > end:
            busy += stop - max(start, end)
            end = stop
    return busy / 1e9


def _containing(ranges, t):
    """The name of the range (name, start, end) that holds time t, or None."""
    for name, start, end in ranges:
        if start <= t <= end:
            return name
    return None


def _events(prof):
    """(device operations, launch time by correlation id, layer ranges,
    step ranges) of a profile's raw events."""
    from torch.autograd import DeviceType

    device, launches, ranges, steps = [], {}, [], []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if e.device_type() == DeviceType.CUDA:
            if name not in LAYERS and name != STEP:  # not the annotations' device copies
                device.append(e)
        elif name in LAYERS:
            ranges.append((name, e.start_ns(), e.end_ns()))
        elif name == STEP:
            steps.append((e.start_ns(), e.end_ns()))
        elif name.startswith(LAUNCH_CALLS):
            launches[e.correlation_id()] = e.start_ns()
    return device, launches, ranges, steps


def device_work(prof):
    """What a profile's device operations did: ``work_s``, the sum of their
    durations; ``busy_s``, the union of their intervals (the same on one
    stream, where the operations run one after another); ``ops``, their
    number; ``streams``; ``zero``, those with no duration; ``overlap_s``,
    by how much ``work_s`` exceeds ``busy_s``."""
    device = _events(prof)[0]
    work = sum(e.duration_ns() for e in device) / 1e9
    busy = _union_s([(e.start_ns(), e.end_ns()) for e in device])
    streams = {getattr(e, "device_resource_id", lambda: None)() for e in device}
    return dict(work_s=work, busy_s=busy, ops=len(device), streams=len(streams),
                zero=sum(1 for e in device if e.duration_ns() <= 0), overlap_s=work - busy)


def reduce_device(prof, data: TraceData):
    """Busy time, K1's kernel time and the top device operations of the
    steps traced on the device alone (``data.window_s`` is their wall time
    on the host's clock)."""
    device = _events(prof)[0]
    if not device:
        return
    data.busy_s = _union_s([(e.start_ns(), e.end_ns()) for e in device])
    by_name = {}
    for e in device:
        name = e.name()
        by_name[name[:80]] = by_name.get(name[:80], 0.0) + e.duration_ns() / 1e9
        if K1_KERNEL.search(name):
            data.k1_kernel_s += e.duration_ns() / 1e9
    data.device_ops = [[k, v] for k, v in sorted(by_name.items(), key=lambda kv: -kv[1])[:10]]


def reduce_layers(prof, data: TraceData):
    """Device time and operations a step by the layer that launched them,
    and the idle gaps by the host range the host was in, from the steps
    traced with the host's ranges (tracing the host slows it, so these
    gaps are longer than an untraced step's)."""
    device, launches, ranges, steps = _events(prof)
    if not device or not steps:
        return
    intervals = [(e.start_ns(), e.end_ns()) for e in device]
    per_layer = {layer: [] for layer in LAYERS}
    for e, interval in zip(device, intervals):
        t = launches.get(e.correlation_id())
        layer = None if t is None else _containing(ranges, t)
        if layer is not None:
            per_layer[layer].append(interval)
    n = max(data.profiled_steps, 1)
    data.layer_device_ms = {k: 1e3 * _union_s(v) / n for k, v in per_layer.items()}
    data.layer_device_ops = {k: len(v) / n for k, v in per_layer.items()}

    gaps, end = {}, None
    lo, hi = min(s[0] for s in steps), max(s[1] for s in steps)
    for start, stop in sorted(intervals):
        if end is not None and start > end and lo <= end <= hi:
            label = _containing(ranges, end)
            if label is None:
                label = "step, outside the layers" if _containing(
                    [(STEP, a, b) for a, b in steps], end) else "between steps (the stream)"
            gaps[label] = gaps.get(label, 0.0) + (start - end) / 1e9
        end = stop if end is None else max(end, stop)
    data.idle_gaps = [[k, v] for k, v in sorted(gaps.items(), key=lambda kv: -kv[1])[:10]]
