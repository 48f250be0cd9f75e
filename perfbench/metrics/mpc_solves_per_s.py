"""Solves a second (solves/s) over the traced run's unprofiled steps: the
batch times their number over their summed host time, each step timed from
its call to the synchronize after it. ``mpc_solves_per_s`` read per layer,
in a cell whose host-paced rate spreads too widely to be bounded end to
end."""


def read(t):
    if not t.step_ms or not t.batch:
        return None
    return 1e3 * t.batch * len(t.step_ms) / sum(t.step_ms)
