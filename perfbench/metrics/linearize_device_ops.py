"""Device operations a step (kernels, copies, fills) launched inside
linearize (solver/transcription.py:linearize_ocp), over the profiled steps."""


def read(t):
    return t.layer_device_ops.get("linearize") if t.profiled_steps else None
