"""Linesearch candidates evaluated a step (calls of
solver/sqp.py:evaluate_trajectory by the step), over the traced window."""


def read(t):
    return t.linesearch_calls / t.steps if t.steps else None
