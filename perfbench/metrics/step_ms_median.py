"""Median host time of a step (ms) over the traced window's unprofiled
steps, each timed from its call to the synchronize after it."""
import statistics


def read(t):
    return statistics.median(t.step_ms) if t.step_ms else None
