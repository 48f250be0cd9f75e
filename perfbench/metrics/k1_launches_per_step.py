"""K1 launches a step (ops/spd_solve.py's launch counter) over the
profiled steps."""


def read(t):
    return t.k1_launches / t.profiled_steps if t.profiled_steps else None
