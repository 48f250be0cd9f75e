"""Device time a step (ms) of the operations launched inside linearize
(solver/transcription.py:linearize_ocp), over the profiled steps."""


def read(t):
    return t.layer_device_ms.get("linearize") if t.profiled_steps else None
