"""Device time a step (ms) of the operations launched inside the LQ stage
(transcription.project_ocp_batched and riccati.lqr_solve_batched), over the
profiled steps."""


def read(t):
    return t.layer_device_ms.get("lq_stage") if t.profiled_steps else None
