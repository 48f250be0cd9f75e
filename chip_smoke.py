#!/usr/bin/env python3
"""Smoke run of the torch port (qm_door_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Needs one CUDA device and the CUDA toolkit (nvcc); builds every kernel of
the main path from qm_door_torch/csrc at first use. Exits non-zero, with no
result line, when CUDA is unavailable or any phase fails.

Phases:
  (a) kernels: builds K1 (the SPD solve) and holds it against its plain
      torch version and an f64 plain solve at the main path's shapes, on SPD
      inputs of condition ~1e3 (pass: max relative error <= 1e-4); times
      kernel, plain version and torch.linalg (cholesky + cholesky_solve);
      checks ragged batches, n = 1 and 64, odd RHS widths, a shift, and
      that the wrapper refuses float64, n > 64 and too much shared memory.
  (b) main path: BatchedMpc at B = 384, N = 67 (AlienGo+Z1 trot,
      lin_tangents="analytic_bf16", sensitivity="frozen", 2 linesearch
      candidates, seed-0 perturbations x 0.02): one cold step and 20 warm
      steps, per-stage host times, K1 launches (exactly 68 a step), mean
      violation <= 1e-5; then each stage and one step once more under
      torch.profiler for device busy time, device op count and the card's
      idle share of a step (after the timed steps, so they carry no
      profiler cost).
  (c) cross precision: 3 steps at B = 4 with lin_tangents="analytic", the
      port on the GPU in f32 against the port on the CPU in f64
      (max|dX| <= 2e-5, max|dU| <= 2.5e-3 N).

The line before the last is {"kernels": [...]}; the last line is
{"ok": true, "device": {...}}.
"""
import json
import os
import subprocess
import sys
import time

import numpy as np

BATCH = 384
WARM_STEPS = 20
PERTURBATION = 0.02
HBM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3
F32_FLOPS_PER_S = 67e12     # H100 SXM f32, outside the tensor cores
K1_REL_TOL = 1e-4
VIOLATION_MAX = 1e-5
CROSS_DX_MAX = 2e-5
CROSS_DU_MAX = 2.5e-3


def log(*args):
    print(*args, flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps, warmup=3):
    """Mean ms per call over `reps` chained calls, timed with CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_busy(fn):
    """One call of `fn` under torch.profiler: the union of the device
    intervals it traced (kernels, copies, fills) in ms, their count, and the
    five kernels with the most device time. kernel_ms is None where the
    profiler saw no device activity (no CUPTI)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    spans, by_name = [], {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            spans.append((e.time_range.start, e.time_range.end))
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    busy_us, end = 0.0, float("-inf")
    for start, stop in sorted(spans):
        if stop > end:
            busy_us += stop - max(start, end)
            end = stop
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    return {"kernel_ms": busy_us / 1e3 if spans else None, "device_ops": len(spans),
            "top_ms": {name[:80]: ms for name, ms in top}}


def spd_batch(rng, batch, n, m):
    """SPD matrices with eigenvalues logspaced over [1, 1e3] (condition 1e3)."""
    Q, _ = np.linalg.qr(rng.normal(size=(batch, n, n)))
    eig = np.logspace(0.0, 3.0, n)
    A = (Q * eig[None, None, :]) @ np.swapaxes(Q, -1, -2)
    A = 0.5 * (A + np.swapaxes(A, -1, -2))
    return A, rng.normal(size=(batch, n, m))


def phase_kernels(dev):
    """(a) build K1, hold it against its plain versions, time it."""
    import torch

    from qm_door_torch.ops import cuda_build
    from qm_door_torch.ops.spd_solve import spd_solve, spd_solve_plain

    t0 = time.time()
    nvcc_out = cuda_build.build("spd_solve")
    log(f"[a] built K1 in {time.time() - t0:.1f} s")
    for line in nvcc_out.splitlines():
        log(f"[a] nvcc: {line}")

    rng = np.random.default_rng(0)
    shapes = [("projection", BATCH * 67, 12, 49, 1),
              ("riccati_gain", BATCH, 30, 31, 67),
              ("wbc_gram_off_path", 512, 58, 58, 0)]
    rows = []
    for label, batch, n, m, per_step in shapes:
        A64, Y64 = spd_batch(rng, batch, n, m)
        A = torch.tensor(A64, dtype=torch.float32, device=dev)
        Y = torch.tensor(Y64, dtype=torch.float32, device=dev)
        X_ref = spd_solve_plain(torch.tensor(A64, device=dev), torch.tensor(Y64, device=dev))
        X_k = spd_solve(A, Y)
        X_p = spd_solve_plain(A, Y)
        torch.cuda.synchronize()
        scale = X_ref.abs().max().item()
        rel_k = (X_k.double() - X_ref).abs().max().item() / scale
        rel_p = (X_p.double() - X_ref).abs().max().item() / scale
        abs_kp = (X_k - X_p).abs().max().item()
        if not (rel_k <= K1_REL_TOL and rel_p <= K1_REL_TOL and np.isfinite(abs_kp)):
            raise RuntimeError(f"K1 {label} ({batch},{n},{m}): relative error kernel "
                               f"{rel_k:.3e}, plain {rel_p:.3e} > {K1_REL_TOL}")
        ms = cuda_ms(lambda: spd_solve(A, Y), reps=50)
        plain_ms = cuda_ms(lambda: spd_solve_plain(A, Y), reps=5, warmup=1)
        lib_ms = cuda_ms(lambda: torch.cholesky_solve(Y, torch.linalg.cholesky(A)), reps=20)
        # the kernel reads A's lower triangle and Y once, writes X once
        nbytes = 4 * batch * (n * (n + 1) // 2 + 2 * n * m)
        flops = batch * (n ** 3 / 3.0 + 2.0 * n * n * m)
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOPS_PER_S * 1e3
        row = dict(shape=label, batch=batch, n=n, m=m, calls_per_step=per_step,
                   rel_err_kernel=rel_k, rel_err_plain=rel_p, max_abs_err=abs_kp,
                   ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bytes=nbytes,
                   flops=flops, bytes_ms=t_bytes, ops_ms=t_ops, bound_ms=max(t_bytes, t_ops),
                   bound_by="bytes" if t_bytes >= t_ops else "operations")
        log("[a] " + json.dumps(row))
        rows.append(row)
    check_k1_edges(dev, rng)
    return rows


def check_k1_edges(dev, rng):
    """K1 off the main shapes: ragged batches (one and several systems a
    block), n = 1 and n = 64, RHS widths around the 32-lane stride, a shift,
    and the launches it must refuse."""
    import torch

    from qm_door_torch.ops.spd_solve import spd_solve, spd_solve_plain

    for batch, n, m, shift in ((1, 1, 1, 0.0), (7, 12, 5, 0.5), (1000, 12, 49, 1e-3),
                               (1001, 30, 33, 0.0), (33, 64, 1, 1e-5), (5, 17, 100, 0.0)):
        A64, Y64 = spd_batch(rng, batch, n, m)
        X_k = spd_solve(torch.tensor(A64, dtype=torch.float32, device=dev),
                        torch.tensor(Y64, dtype=torch.float32, device=dev), shift)
        X_ref = spd_solve_plain(torch.tensor(A64, device=dev), torch.tensor(Y64, device=dev),
                                shift)
        torch.cuda.synchronize()
        rel = (X_k.double() - X_ref).abs().max().item() / X_ref.abs().max().item()
        if not rel <= K1_REL_TOL:
            raise RuntimeError(f"K1 ({batch},{n},{m}) shift {shift}: relative error {rel:.3e}")
    refusals = (
        (TypeError, torch.eye(4, device=dev, dtype=torch.float64)[None],
         torch.ones(1, 4, 1, device=dev, dtype=torch.float64)),
        (ValueError, torch.eye(65, device=dev)[None], torch.ones(1, 65, 1, device=dev)),
        (ValueError, torch.eye(64, device=dev)[None], torch.ones(1, 64, 4000, device=dev)),
    )
    for error, A, Y in refusals:
        try:
            spd_solve(A, Y)
        except error:
            continue
        raise RuntimeError(f"K1 took ({tuple(A.shape)}, {tuple(Y.shape)}, {A.dtype}), "
                           f"which it must refuse with {error.__name__}")
    log("[a] K1 edge cases and refusals: ok")


def make_problem(dev, dtype, batch, lin_tangents):
    """The bench problem: AlienGo+Z1, 1 s / 67-node trot horizon, targets at
    the nominal pose, seed-0 initial-state perturbations."""
    import torch

    from qm_door_torch.config import default_config
    from qm_door_torch.models import kinematics, spatial
    from qm_door_torch.models.model import aliengo_z1
    from qm_door_torch.ocp.gait import GAIT_LIBRARY, GaitSchedule
    from qm_door_torch.ocp.problem import build_stage_data, make_ocp_config
    from qm_door_torch.ocp.reference import TargetTrajectories
    from qm_door_torch.parallel.batched import BatchedMpc
    from qm_door_torch.solver.sqp import SqpSolver

    cfg = default_config()
    cfg.sqp.linesearch_steps = 2
    cfg.sqp.lin_tangents = lin_tangents
    cfg.sqp.sensitivity = "frozen"
    model = aliengo_z1(dtype=dtype, device=dev)
    solver = SqpSolver(model, make_ocp_config(model, cfg), cfg)
    x0 = torch.tensor(cfg.initial_state(), dtype=dtype, device=dev)
    R_ee, p_ee = kinematics.ee_pose(model, x0[6:30])
    tstate = torch.cat([x0, p_ee, spatial.rot_to_quat(R_ee)])
    targets = TargetTrajectories.create(
        torch.tensor([0.0, 1e5], dtype=dtype, device=dev),
        torch.stack([tstate, tstate]), torch.zeros((2, 30), dtype=dtype, device=dev))
    sched = GaitSchedule()
    sched.insert_template(GAIT_LIBRARY["trot"], 0.0, 5.0)
    stage = build_stage_data(model, cfg, sched, targets, 0.0)
    perturb = np.random.default_rng(0).normal(size=(BATCH, 30)) * PERTURBATION
    x0_np = cfg.initial_state().astype(np.float32 if dtype == torch.float32 else np.float64)
    x_batch = torch.tensor(x0_np[None] + perturb[:batch], dtype=dtype, device=dev)
    return BatchedMpc(solver), stage, x_batch


def phase_main_path(dev):
    """(b) BatchedMpc at full width, K1 launch count, per-stage times and
    device profile."""
    import torch

    from qm_door_torch.ops.spd_solve import spd_solve
    from qm_door_torch.solver.riccati import lqr_solve_batched
    from qm_door_torch.solver.sqp import evaluate_trajectory
    from qm_door_torch.solver.transcription import linearize_ocp, project_ocp_batched

    mpc, stage, x_batch = make_problem(dev, torch.float32, BATCH, "analytic_bf16")
    X, U = mpc.cold_start(stage, x_batch)

    spd_solve.launches = 0
    t0 = time.time()
    X, U, stats = mpc.step(stage, x_batch, X, U)
    torch.cuda.synchronize()
    cold_s = time.time() - t0
    t0 = time.time()
    for _ in range(WARM_STEPS):
        X, U, stats = mpc.step(stage, x_batch, X, U)
    torch.cuda.synchronize()
    elapsed = time.time() - t0
    launches = spd_solve.launches
    steps = WARM_STEPS + 1

    viol = stats[1].mean().item()
    finite = bool(torch.isfinite(X).all() and torch.isfinite(U).all())
    if launches != 68 * steps:
        raise RuntimeError(f"K1 launched {launches} times in {steps} steps, not 68 a step")
    if not (finite and np.isfinite(viol) and viol <= VIOLATION_MAX):
        raise RuntimeError(f"main path: finite={finite}, mean violation {viol:.3e}")

    # per-stage split at the warm iterate (separate timed calls, after the
    # launch count was read)
    s, solver = mpc.solver.settings, mpc.solver
    N = solver.n_intervals

    stage_ms, device = {}, {}

    def timed(name, fn, reps=3):
        """Host ms per call over `reps` calls, then one call profiled."""
        fn()
        torch.cuda.synchronize()
        t = time.time()
        for _ in range(reps):
            out = fn()
        torch.cuda.synchronize()
        stage_ms[name] = (time.time() - t) / reps * 1e3
        device[name] = device_busy(fn)
        return out

    lq = timed("linearize", lambda: linearize_ocp(
        solver.model, solver.ocp, stage, s.dt, X, U,
        sensitivity=s.sensitivity, tangents=s.lin_tangents))
    flags = stage.contact_flags[:N].expand(BATCH, N, 4)
    plq = timed("project", lambda: project_ocp_batched(lq, flags, U, shift=s.hessian_shift))
    dX, dU, _, _ = timed("riccati", lambda: lqr_solve_batched(plq, x_batch - X[:, 0]))
    timed("linesearch_eval_per_candidate", lambda: evaluate_trajectory(
        solver.model, solver.ocp, stage, s.dt, X + dX, U + dU))
    device["step"] = device_busy(lambda: mpc.step(stage, x_batch, X, U))
    step_ms = 1e3 * elapsed / WARM_STEPS
    busy_ms = device["step"]["kernel_ms"]

    result = {
        "metric": "mpc_solves_per_s",
        "value": BATCH * WARM_STEPS / elapsed,
        "unit": "solves/s",
        "vs_baseline": BATCH * WARM_STEPS / elapsed / 10000.0,
        "batch": BATCH,
        "reps": WARM_STEPS,
        "per_solve_us": 1e6 * elapsed / (BATCH * WARM_STEPS),
        "compile_s": cold_s,
        "backend": "bm_k1_cuda",
        "config": "combined",
        "mean_violation": viol,
        "device": torch.cuda.get_device_name(0),
        "impl": "torch",
        "step_ms": step_ms,
        "stage_ms": stage_ms,
        "device_profile": device,
        "device_idle_share": None if busy_ms is None else 1.0 - busy_ms / step_ms,
        "k1_launches": launches,
        "k1_launches_per_step": launches / steps,
        "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 2 ** 30,
    }
    log("[b] " + json.dumps(result))
    return launches


def phase_cross_precision(dev):
    """(c) 3 steps at B = 4, GPU f32 against CPU f64 (lin_tangents="analytic")."""
    import torch

    out = {}
    for name, device, dtype in (("gpu_f32", dev, torch.float32),
                                ("cpu_f64", torch.device("cpu"), torch.float64)):
        mpc, stage, x_batch = make_problem(device, dtype, 4, "analytic")
        X, U = mpc.cold_start(stage, x_batch)
        for _ in range(3):
            X, U, stats = mpc.step(stage, x_batch, X, U)
        out[name] = (X.double().cpu(), U.double().cpu(), [t.double().cpu() for t in stats])
    dX = (out["gpu_f32"][0] - out["cpu_f64"][0]).abs().max().item()
    dU = (out["gpu_f32"][1] - out["cpu_f64"][1]).abs().max().item()
    dF = (out["gpu_f32"][1][..., :12] - out["cpu_f64"][1][..., :12]).abs().max().item()
    row = {"X_err_max": dX, "U_err_max": dU, "force_err_max_N": dF,
           "cost": {k: v[2][0].tolist() for k, v in out.items()},
           "violation": {k: v[2][1].tolist() for k, v in out.items()},
           "alpha": {k: v[2][2].tolist() for k, v in out.items()}}
    log("[c] " + json.dumps(row))
    if not (dX <= CROSS_DX_MAX and dU <= CROSS_DU_MAX):
        raise RuntimeError(f"cross precision: max|dX| {dX:.3e} (<= {CROSS_DX_MAX}), "
                           f"max|dU| {dU:.3e} (<= {CROSS_DU_MAX})")


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import qm_door_torch  # noqa: F401  (pins full-f32 matmuls)

    if not (torch.backends.cuda.matmul.allow_tf32 is False
            and torch.backends.cudnn.allow_tf32 is False
            and torch.get_float32_matmul_precision() == "highest"):
        raise RuntimeError("TF32 is not off")
    dev = torch.device("cuda", 0)
    t_start = time.time()
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    card = card_line()

    rows = phase_kernels(dev)
    launches = phase_main_path(dev)
    phase_cross_precision(dev)

    on_path = [r for r in rows if r["calls_per_step"]]
    per_step = lambda key: sum(r[key] * r["calls_per_step"] for r in on_path)  # noqa: E731
    k1 = {
        "name": "spd_solve",
        "route": "cuda",
        "source": "qm_door_torch/csrc/spd_solve.cu",
        "replaces": "qm_door_tpu/ops/pallas_chol.py:103",
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in on_path),
        # one SQP step's K1 work: 1 projection solve + 67 gain solves
        "ms": per_step("ms"),
        "plain_ms": per_step("plain_ms"),
        "bound_ms": per_step("bound_ms"),
        "bound_by": "bytes" if per_step("bytes_ms") >= per_step("ops_ms") else "operations",
        "library_ms": per_step("library_ms"),
        "shapes": rows,
    }
    log(f"total {time.time() - t_start:.1f} s")
    log(card)
    print(json.dumps({"kernels": [k1]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
