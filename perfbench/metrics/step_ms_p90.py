"""90th percentile of the host time of a step (ms) over the traced
window's unprofiled steps (Python's statistics.quantiles, inclusive)."""
import statistics


def read(t):
    if len(t.step_ms) < 2:
        return None
    return statistics.quantiles(t.step_ms, n=10, method="inclusive")[-1]
