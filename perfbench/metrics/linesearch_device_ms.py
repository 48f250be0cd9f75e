"""Device time a step (ms) of the operations launched inside the
linesearch's trajectory evaluations, over the profiled steps."""


def read(t):
    return t.layer_device_ms.get("linesearch") if t.profiled_steps else None
