"""Share of the profiled steps' wall time (%) in which no operation ran on
the device: 1 - busy / window, both from the profiler's trace."""


def read(t):
    if not t.profiled_steps or t.window_s <= 0.0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
