"""A run with the timed path broken underneath must come out not correct:
the harness's look for a card is skipped (CPU, B = 4) and the rest of the
run is driven as on the card."""
import json

import pytest
import torch

from perfbench import run


def unchanged(system, stage, x_init, X, U):
    """A step that returns its state unchanged."""
    _, _, stats = system.step(stage, x_init, X, U)
    return X.clone(), U.clone(), stats


def half_batch(system, stage, x_init, X, U):
    """Half of the batch left out: only the first half is solved, the rest
    keeps its input."""
    Xo, Uo, stats = system.step(stage, x_init, X, U)
    h = X.shape[0] // 2
    Xo[h:], Uo[h:] = X[h:], U[h:]
    return Xo, Uo, stats


def altered(system, stage, x_init, X, U):
    """An answer altered where it is produced: one input of one scenario's
    solution moved by 1 N."""
    Xo, Uo, stats = system.step(stage, x_init, X, U)
    Uo[0, 3, 2] += 1.0
    return Xo, Uo, stats


@pytest.mark.parametrize("fault", [unchanged, half_batch, altered], ids=lambda f: f.__name__)
def test_a_broken_step_is_not_correct(fault, capsys):
    torch.manual_seed(0)
    rc = run.main(["--workload", "trot-farm-b1024", "--seed", "977", "--seconds", "0.5",
                   "--trace", "0"], device="cpu", batch=4, step_hook=fault)
    assert rc == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["correct"] is False


def test_a_sound_run_prints_the_result_line(capsys):
    rc = run.main(["--workload", "trot-farm-b1024", "--seed", str(2 ** 31 + 3),
                   "--seconds", "0.5", "--trace", "0"], device="cpu", batch=4)
    assert rc == 0
    lines = capsys.readouterr().out.strip().splitlines()
    line = json.loads(lines[-1])
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert line["correct"] is True
    assert set(line["metrics"]) == {"mpc_solves_per_s", "setup_s"}
    assert line["attempted"] % 4 == 0 and line["failed"] == 0


def test_per_scenario_phases_hold_to_the_reference(monkeypatch):
    """The stream's per-scenario ring phases (``scenario_phase_stride``,
    for a later cell that mixes the trot's contact modes in one batch):
    a run at B = 4 with stride 7 is correct."""
    from perfbench import harness

    spec = harness.cell_spec

    def mixed(name, root=harness.ROOT):
        bench, cell, cfg, traffic = spec(name, root)
        return bench, cell, cfg, {**traffic, "scenario_phase_stride": 7}

    monkeypatch.setattr(harness, "cell_spec", mixed)
    res = harness.run("trot-farm-b1024", 2 ** 31 + 9, 0.5, False, device="cpu", batch=4)
    phases = res["samples"][0]["phases"]
    assert len(set(int(p) for p in phases)) == 4
    assert res["correct"], res["checks"]


def test_an_untraced_run_times_the_program_unwrapped(capsys):
    """Without --trace the window's step calls the program's own layer
    functions (no host spans around them), and the host look of the window
    is printed on standard error: a step's end each, the collector's
    passes by generation."""
    from qm_door_torch.solver import batched_sqp

    own = {n: getattr(batched_sqp, n) for n in ("linearize_ocp", "evaluate_trajectory")}
    seen = []

    def step(system, stage, x_init, X, U):
        seen.append(all(getattr(batched_sqp, n) is f for n, f in own.items()))
        return system.step(stage, x_init, X, U)

    rc = run.main(["--workload", "trot-farm-b1024", "--seed", "2100000977", "--seconds", "0.5",
                   "--trace", "0"], device="cpu", batch=4, step_hook=step)
    assert rc == 0 and seen and all(seen)
    err = capsys.readouterr().err
    host = json.loads(next(l for l in err.splitlines() if l.startswith("perfbench: host "))
                      .removeprefix("perfbench: host "))
    steps = int(next(l for l in err.splitlines() if " steps in " in l).split()[1])
    assert len(host["step_end_s"]) == steps and len(host["gc_passes"]) == 3


def test_the_sampled_rows_are_kept_on_the_device():
    """The recorder draws every step's rows from the seed in set-up, as one
    tensor on the run's device, and keeps those rows of each step."""
    from perfbench.harness import Recorder

    rec = Recorder(2100000977, 8, 3, torch.device("cpu"), max_steps=5)
    assert rec.rows.shape == (5, 3) and rec.rows.device.type == "cpu"
    X = torch.arange(8.0)[:, None, None].expand(8, 2, 30).clone()
    U = X[:, :1].clone()
    stats = (torch.arange(8.0),) * 3
    rec.keep(6, 0, X[:, 0], X, U, X, U, stats)
    assert torch.equal(rec.steps[0]["cost"], rec.rows[1].float())
    assert Recorder(2100000977, 8, 3, torch.device("cpu"), max_steps=5).rows.equal(rec.rows)


def test_a_window_traced_whole_leaves_no_step_out():
    """Where an end-to-end metric comes from the device's trace, the window
    is profiled whole in profiles of CHUNK_STEPS steps: every step falls in
    exactly one, and each is stopped after a synchronize."""
    from perfbench import harness

    events = []

    class Prof:
        def stop(self):
            events.append("stop")

    def make():
        events.append("start")
        return Prof()

    wt = harness.WindowTrace(lambda: events.append("sync"), profile=make)
    steps = 2 * harness.CHUNK_STEPS + 3
    for k in range(steps):
        wt.before_step(k)
        events.append(k)
        wt.after_step(k)
    wt.stop(steps - 1)
    wt.stop(steps - 1)
    assert [n for n, _ in wt.done] == [harness.CHUNK_STEPS, harness.CHUNK_STEPS, 3]
    assert [e for e in events if isinstance(e, int)] == list(range(steps))
    opened = False
    for prev, e in zip([None, *events], events):
        if e == "start":
            assert not opened
            opened = True
        elif e == "stop":
            assert opened and prev == "sync"
            opened = False
        elif isinstance(e, int):
            assert opened
    assert not opened


def test_a_split_metric_shares_its_reader():
    """``<name>.<part>`` is the quantity ``<name>`` in cells that report
    another end-to-end metric, read by the same file; the host-paced rate
    read per layer is the batch over the mean unprofiled step."""
    from perfbench import harness
    from perfbench.trace import TraceData

    assert harness.reader("k1_roofline.door") is harness.reader("k1_roofline")
    t = TraceData(step_ms=[500.0, 1500.0], batch=4)
    assert harness.reader("mpc_solves_per_s.door").read(t) == 4.0
    assert harness.reader("mpc_solves_per_s.door").read(TraceData()) is None


def test_the_door_cell_reports_its_device_rate_only_from_a_card(capsys):
    """The door cell's end-to-end rate is read from the device's trace of
    the whole window: without a card there is nothing to read, and the
    line holds set-up alone; the run is still judged."""
    rc = run.main(["--workload", "door-press-b1024", "--seed", "2100000978", "--seconds", "0.5",
                   "--trace", "0"], device="cpu", batch=4)
    assert rc == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(line["metrics"]) == {"setup_s"}
    assert line["correct"] is True


def test_the_device_work_of_a_profile():
    """The card's time of a profile is its device operations' summed
    durations: on one stream it is their union, and a block of timestamps
    shifted onto other operations leaves it whole where the union shrinks;
    host events are not counted."""
    from types import SimpleNamespace

    from torch.autograd import DeviceType

    from perfbench.trace import device_work

    def event(start, end, device=True, stream=7):
        return SimpleNamespace(
            name=lambda: "kernel" if device else "cudaLaunchKernel",
            device_type=lambda: DeviceType.CUDA if device else DeviceType.CPU,
            start_ns=lambda: start, end_ns=lambda: end, duration_ns=lambda: end - start,
            device_resource_id=lambda: stream, correlation_id=lambda: 0)

    def prof(events):
        return SimpleNamespace(profiler=SimpleNamespace(
            kineto_results=SimpleNamespace(events=lambda: events)))

    ops = [event(10 * i, 10 * i + 8) for i in range(10)]
    got = device_work(prof(ops + [event(0, 1000, device=False)]))
    assert got["work_s"] == got["busy_s"] == 80e-9
    assert (got["ops"], got["streams"], got["zero"]) == (10, 1, 0)
    shifted = ops[:5] + [event(e.start_ns() - 50, e.end_ns() - 50) for e in ops[5:]]
    got = device_work(prof(shifted))
    assert got["work_s"] == 80e-9 and got["busy_s"] == 40e-9
    assert abs(got["overlap_s"] - 40e-9) < 1e-15
