"""Host time a step (ms) inside the LQ stage's calls
(transcription.project_ocp_batched and riccati.lqr_solve_batched), over
every step of the traced window."""


def read(t):
    if not t.steps or "lq_stage" not in t.span_ms:
        return None
    return t.span_ms["lq_stage"] / t.steps
