"""One run of one cell: set-up, the measured window, the traced window's
readings and the comparison that decides ``correct``.

Driven by data: the cell, its configuration and its traffic come from
``BENCHMARK.json`` and the files it names; a traffic's ``kind`` names its
generator ``traffic/<kind>.py``; each per-layer metric is read by
``metrics/<name>.py`` (a metric ``<name>.<part>`` is the same quantity in
cells that report another end-to-end metric, read by the same file).
"""
from __future__ import annotations

import contextlib
import gc
import importlib
import json
import os
import resource
import time

import numpy as np
import torch

from . import correct, schema
from .trace import STEP, TraceData, device_work, reduce_device, reduce_layers

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROFILED_STEPS = 2
# steps a device-only profile holds where an untraced window is traced
# whole (~6 MB of the profiler's buffers a step of ~21k launches)
CHUNK_STEPS = 8


def process_age_s():
    """Seconds since this process started (the kernel's clock ticks)."""
    with open("/proc/self/stat") as f:
        start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    return time.clock_gettime(time.CLOCK_BOOTTIME) - start_ticks / os.sysconf("SC_CLK_TCK")


def load_json(rel, root=ROOT):
    with open(os.path.join(root, rel)) as f:
        return json.load(f)


def cell_spec(name, root=ROOT):
    """(bench, cell, configuration, traffic parameters) of a workload, all
    found by name: the cell in BENCHMARK.json, its configuration's file,
    its traffic in ``perfbench/traffic/<traffic>.json``."""
    bench = load_json("BENCHMARK.json", root)
    schema.validate(bench)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; BENCHMARK.json has {sorted(cells)}")
    cell = cells[name]
    conf = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    cfg = load_json(conf["file"], root)
    traffic = load_json(os.path.join("perfbench", "traffic", f"{cell['traffic']}.json"), root)
    return bench, cell, cfg, traffic


def reader(metric):
    """The reader of a per-layer metric: ``metrics/<name>.py``, where
    ``<name>`` is the metric's name up to its first dot."""
    return importlib.import_module(f"perfbench.metrics.{metric.split('.')[0]}")


def generator(kind):
    """The generator of a traffic kind: ``traffic/<kind>.py``."""
    return importlib.import_module(f"perfbench.traffic.{kind}")


def metrics_of(bench, cell, trace):
    """The cell's metrics of this kind of run: end-to-end with --trace 0,
    per-layer with --trace 1 (those whose ``workloads`` name the cell, or
    every cell where the metric names none)."""
    key = "per_layer" if trace else "end_to_end"
    return [m for m in bench[key] if cell["name"] in m.get("workloads", [cell["name"]])]


class Recorder:
    """Keeps the inputs and outputs of the sampled scenarios of every
    window step (on the device), drawn from the seed."""

    def __init__(self, seed, B, S, device, max_steps=4096):
        rng = np.random.default_rng(seed)
        rows = np.stack([np.sort(rng.choice(B, size=min(S, B), replace=False))
                         for _ in range(max_steps)])
        # on the device in set-up, so that keeping a step copies nothing from
        # the host (a copy from pageable memory would wait for the stream)
        self.rows = torch.as_tensor(rows, device=device)
        self.steps = []

    def keep(self, k, phases, x_init, X, U, Xo, Uo, stats):
        idx = self.rows[k % self.rows.shape[0]]
        ph = np.full(idx.shape[0], phases) if isinstance(phases, int) else phases[idx]
        pick = lambda t: t.index_select(0, idx)  # noqa: E731
        self.steps.append(dict(phases=ph, x_init=pick(x_init), X_in=pick(X), U_in=pick(U),
                               X_out=pick(Xo), U_out=pick(Uo), cost=pick(stats[0]),
                               viol=pick(stats[1]), alpha=pick(stats[2])))

    def sample(self, seed, n_steps):
        """The groups to check: ``n_steps`` window steps drawn from the seed."""
        rng = np.random.default_rng([seed, 1])
        take = np.sort(rng.choice(len(self.steps), size=min(n_steps, len(self.steps)),
                                  replace=False))
        out = []
        for i in take:
            g = self.steps[i]
            ph = g["phases"]
            out.append({**{k: v.cpu() for k, v in g.items() if k != "phases"},
                        "phases": ph.cpu().numpy() if torch.is_tensor(ph) else ph})
        return out


class HostLook:
    """What the host did in the window, for the look at the spread of the
    host-paced step: the cyclic collector's passes and pauses by
    generation, the process's CPU time and context switches, the load."""

    def __init__(self):
        self.passes, self.pause_s, self._t = [0, 0, 0], [0.0, 0.0, 0.0], 0.0
        gc.callbacks.append(self._gc)
        self.load0 = os.getloadavg()[0]
        self.ru0 = resource.getrusage(resource.RUSAGE_SELF)

    def _gc(self, phase, info):
        if phase == "start":
            self._t = time.perf_counter()
        else:
            g = info["generation"]
            self.passes[g] += 1
            self.pause_s[g] += time.perf_counter() - self._t

    def close(self, ends, window_s):
        """A dict of the readings, every step's end (s from the window's
        start) among them; the collector's callback is removed."""
        gc.callbacks.remove(self._gc)
        ru = resource.getrusage(resource.RUSAGE_SELF)
        return dict(window_s=window_s, step_end_s=[round(t, 4) for t in ends],
                    gc_passes=self.passes, gc_pause_s=[round(t, 4) for t in self.pause_s],
                    cpu_user_s=round(ru.ru_utime - self.ru0.ru_utime, 3),
                    cpu_sys_s=round(ru.ru_stime - self.ru0.ru_stime, 3),
                    ctx_voluntary=ru.ru_nvcsw - self.ru0.ru_nvcsw,
                    ctx_involuntary=ru.ru_nivcsw - self.ru0.ru_nivcsw,
                    load1=[self.load0, os.getloadavg()[0]])


class WindowTrace:
    """The device's time over a whole untraced window, for the
    end-to-end metrics read from the device's trace: device-only profiles
    of CHUNK_STEPS steps each, one after another, each started before a
    step's first launch and stopped after a synchronize, so that every
    operation of the window is in one of them and none holds more than a
    few tens of MB of the profiler's buffers. ``profile`` makes a started
    profiler (the tests pass a stand-in)."""

    def __init__(self, sync, profile=None):
        self.sync, self.make, self.done, self.prof, self.first = sync, profile, [], None, 0
        if profile is None:
            from torch.profiler import ProfilerActivity
            from torch.profiler import profile as torch_profile

            def started():
                p = torch_profile(activities=[ProfilerActivity.CUDA])
                p.start()
                return p
            self.make = started

    def before_step(self, k):
        if self.prof is None:
            self.prof, self.first = self.make(), k

    def after_step(self, k):
        if k + 1 - self.first >= CHUNK_STEPS:
            self.stop(k)

    def stop(self, k):
        """Ends the open profile, if any, after step ``k``."""
        if self.prof is not None:
            self.sync()
            self.prof.stop()
            self.done.append((k + 1 - self.first, self.prof))
            self.prof = None

    def read(self):
        """[{steps, and trace.device_work's readings}, ...], a profile each."""
        return [dict(steps=n, **device_work(p)) for n, p in self.done]


def nonfinite(X, U):
    """(B,) bool: a scenario whose solution holds a non-finite number."""
    return ~(torch.isfinite(X).flatten(1).all(1) & torch.isfinite(U).flatten(1).all(1))


def run(workload, seed, seconds, trace, device="cuda", step_hook=None, batch=None):
    """One run; returns the result line's fields. The tests run it on the
    CPU with a smaller ``batch``, and plant faults with ``step_hook(system,
    stage, x_init, X, U)`` in place of the system's step."""
    from .system import LAYER_OF, System, k1_counters, layer_spans

    bench, cell, cfg, traffic = cell_spec(workload)
    if batch is not None:
        cfg = {**cfg, "batch": batch}
    kind = generator(traffic["kind"])
    on_cuda = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if on_cuda else (lambda: None)
    if on_cuda:
        torch.cuda.reset_peak_memory_stats()

    system = System(cfg, torch.device(device), torch.float32,
                    shared_stage=traffic["scenario_phase_stride"] == 0)
    step = step_hook or (lambda sysm, *a: sysm.step(*a))
    stream = kind.Stream(system, cfg, traffic, seed)

    # set-up: the cold step and the warm steps, at the cell's own shapes
    phases, x_init, X, U = stream.first()
    X, U, stats = step(system, system.stage_for(phases), x_init, X, U)
    t_warm = time.perf_counter()
    for _ in range(traffic["warm_steps"]):
        phases, x_init, Xw, Uw = stream.next(X, U)
        X, U, stats = step(system, system.stage_for(phases), x_init, Xw, Uw)
    sync()
    warm_step_s = (time.perf_counter() - t_warm) / max(traffic["warm_steps"], 1)
    # the untraced window is traced whole on the device where an end-to-end
    # metric of the cell comes from the device's trace
    whole = on_cuda and not trace and any(m["source"] == "device_trace"
                                          for m in metrics_of(bench, cell, False))
    if trace and on_cuda or whole:
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
            torch.ones(8, device=device).sum()
            sync()

    # the measured window
    B = cfg["batch"]
    rec = Recorder(seed, B, traffic["check"]["scenarios"], X.device)
    bad = torch.zeros((), dtype=torch.int64, device=X.device)
    spans, tdata = [], TraceData()
    # the profiled steps, in the middle of the window (by the warm steps'
    # time): PROFILED_STEPS traced on the device alone (busy time and kernels,
    # the host at its own speed), then PROFILED_STEPS with the host's layer
    # ranges too (which device operation each layer launched)
    first = max(1, int(0.5 * seconds / max(warm_step_s, 1e-3)) - PROFILED_STEPS)
    if trace and on_cuda:
        from torch.profiler import ProfilerActivity, profile

        profs = [profile(activities=[ProfilerActivity.CUDA]),
                 profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])]
        starts = {first: 0, first + PROFILED_STEPS: 1}
        stops = {first + PROFILED_STEPS - 1: 0, first + 2 * PROFILED_STEPS - 1: 1}
    else:
        profs, starts, stops = [], {}, {}
    last = first + 2 * PROFILED_STEPS - 1 if profs else -1
    wtrace = WindowTrace(sync) if whole else None
    evals, marks, ends = 0, {}, []
    gc.collect()
    sync()
    setup_s = process_age_s()
    look = HostLook()
    t0 = time.perf_counter()
    k = 0
    with layer_spans(spans, annotate=bool(profs)) if trace else contextlib.nullcontext():
        while True:
            if wtrace is not None:
                wtrace.before_step(k)
            phases, x_init, Xw, Uw = stream.next(X, U)
            stage = system.stage_for(phases)
            if trace:
                if k in starts:
                    profs[starts[k]].start()
                    marks[("start", starts[k])] = (time.perf_counter(), k1_counters())
                n_spans = len(spans)
                ts = time.perf_counter()
                with torch.profiler.record_function(STEP):
                    X, U, stats = step(system, stage, x_init, Xw, Uw)
                sync()
                if not first <= k <= last:
                    tdata.step_ms.append(1e3 * (time.perf_counter() - ts))
                evals += sum(1 for s in spans[n_spans:] if s[0] == "evaluate_trajectory")
                if k in stops:
                    # the window ends with the step's synchronize, before the
                    # profiler's own stop (which collects its buffers)
                    marks[("stop", stops[k])] = (time.perf_counter(), k1_counters())
                    profs[stops[k]].stop()
            else:
                X, U, stats = step(system, stage, x_init, Xw, Uw)
            rec.keep(k, phases, x_init, Xw, Uw, X, U, stats)
            bad += nonfinite(X, U).sum()
            if wtrace is not None:
                wtrace.after_step(k)
            k += 1
            ends.append(time.perf_counter() - t0)
            if ends[-1] >= seconds and not first < k <= last:
                break
        sync()
        window_s = time.perf_counter() - t0
    if wtrace is not None:
        wtrace.stop(k - 1)
    host = look.close(ends, window_s)
    failed = int(bad)
    peak = torch.cuda.max_memory_allocated() if on_cuda else 0

    result = dict(attempted=B * k, failed=failed, steps=k, window_s=window_s,
                  setup_s=setup_s, memory_peak_bytes=peak, host=host)
    if trace:
        tdata.steps = k
        tdata.batch = B
        tdata.linesearch_calls = evals
        for name, a, b in spans:
            layer = LAYER_OF[name]
            tdata.span_ms[layer] = tdata.span_ms.get(layer, 0.0) + (b - a) / 1e6
        result["profiles"] = None
        if profs and k > last:
            (t_a, k1_a), (t_b, k1_b) = marks[("start", 0)], marks[("stop", 0)]
            result["profiles"] = profs
            tdata.profiled_steps = PROFILED_STEPS
            tdata.window_s = t_b - t_a
            tdata.k1_launches = k1_b[0] - k1_a[0]
            tdata.k1_by_shape = {s: n - k1_a[1].get(s, 0) for s, n in k1_b[1].items()
                                 if n - k1_a[1].get(s, 0)}
        result["trace"] = tdata
    else:
        result["mpc_solves_per_s"] = B * k / window_s
        if wtrace is not None:
            t_read = time.perf_counter()
            chunks = wtrace.read()
            # the card's time: the summed durations of the window's device
            # operations (their union on one stream), which a block of the
            # trace's timestamps shifted onto others leaves whole; one
            # profile's union once read a fifth short with every operation
            # counted
            work_s = sum(c["work_s"] for c in chunks)
            result["device_window"] = dict(work_s=work_s, read_s=time.perf_counter() - t_read,
                                           chunks=chunks)
            if work_s > 0.0:
                result["solves_per_device_s"] = B * sum(c["steps"] for c in chunks) / work_s

    # correctness, once the window has closed and the program's state is freed
    samples = rec.sample(seed, traffic["check"]["steps"])
    del system, stream, X, U, Xw, Uw, stats, rec
    gc.collect()
    if on_cuda:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    checks, ok = correct.judge(cfg, cfg["limits"], samples, device)
    result.update(checks=checks, correct=ok and failed == 0, samples=samples,
                  check_s=time.perf_counter() - t_check, cfg=cfg, bench=bench, cell=cell)
    return result


def read_metrics(bench, cell, result, trace):
    """{name: {"value", "unit"}} of the cell's metrics that have a reading."""
    out = {}
    if trace:
        tdata = result["trace"]
        if result["profiles"] is not None:
            reduce_device(result["profiles"][0], tdata)
            reduce_layers(result["profiles"][1], tdata)
        for m in metrics_of(bench, cell, True):
            value = reader(m["name"]).read(tdata)
            if value is not None:
                out[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in metrics_of(bench, cell, False):
            if m["name"] in result:
                out[m["name"]] = {"value": result[m["name"]], "unit": m["unit"]}
    return out
