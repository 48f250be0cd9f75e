#!/usr/bin/env python3
"""Smoke run of the torch port (qm_door_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Needs one CUDA device and the CUDA toolkit (nvcc); builds every kernel
source in qm_door_torch/csrc first, one nvcc each, all at once. Exits
non-zero, with no result line, when CUDA is unavailable or any phase fails.

Phases:
  (a) kernels: builds K1 (the SPD solve) and holds the variant its
      dispatch picks (reg16 at the projection shape, reg32 at the gain
      shape; at the six shapes of the whole-body cascade at B = 512,
      (h)'s WBC_K1_SHAPES, reg64 but reg32 at 30 x 30 x 36; blk128 at
      512 x 65 / 92 / 128 x 1; reg64 at the door's batch-1 shapes 1 x 42 x
      1, 1 x 36 x 42, 1 x 58 x 42, 1 x 36 x 31) against its plain torch
      version and an f64 plain solve, on SPD inputs of condition ~1e3
      (pass: max relative error <= 1e-4); at every shape also PR 1's
      kernel (variant smem, only ever forced) on the same inputs, the two
      timed in turns (smem, new, new, smem), each with CUDA events over
      chained calls (`ms`, as every kernel) and in a CUDA graph
      (`ms_graph`), beside the plain version and torch.linalg (cholesky +
      cholesky_solve); checks ragged batches (one and several systems a
      block, half-filled blocks, reg64 past one wave), the per-scenario
      solve's shapes (67 x 12 x 18, 1 x 30 x 31), n = 1, 16 | 17, 32 | 33,
      48 | 49, 64 | 65 and 128, m = 1 | 2, 64 | 65, 100 and 4000, odd RHS
      widths, a shift, a misaligned base with NaN above the diagonal
      (never read) on each variant, that each goes to the variant
      k1_variant names, and that the wrapper refuses float64, n > 128
      (n = 129) and, on PR 1's kernel, a system too large for its shared
      memory. 512 x 92 x 92 x 1 is wbc/qp.py:solve_qp_batched's stacked
      Newton systems.
  (b) main path: BatchedMpc at B = 384, N = 67 (AlienGo+Z1 trot,
      lin_tangents="analytic_bf16", sensitivity="frozen", 2 linesearch
      candidates, seed-0 perturbations x 0.02): one cold step and 20 warm
      steps, per-stage host times, K1 launches (exactly 68 a step: 67
      reg32 + 1 reg16, no other variant), mean
      violation <= 1e-5; then each stage and one step once more under
      torch.profiler for device busy time, device op count and the card's
      idle share of a step (after the timed steps, so they carry no
      profiler cost).
  (c) cross precision: 3 steps at B = 4 with lin_tangents="analytic", the
      port on the GPU in f32 against the port on the CPU in f64
      (max|dX| <= 2e-5, max|dU| <= 2.5e-3 N); the CPU run (bm_k1's plain
      path) is made once a problem and serves (e)'s and (g)'s checks too.
  (d) kernels of the other LQ backends, on (b)'s own warm-iterate data at
      B = 384, N = 67: K2 (fused backward sweep), K3a/K3b (projection;
      each also timed in turns (scalar, new, new, scalar) against the
      measuring build of its scalar-product kernel, -DQM_LQ_SCALAR_PRODUCTS, with
      both builds' per-phase clock64() cycles a node, and held through its
      wrapper to 1e-4 of f64 on seeded inputs of every fm/act pattern:
      all-stance, all-swing, a mix, act rows off; 7 x 67 nodes, one node,
      and misaligned inputs),
      K3c (backward sweep), K3d (forward rollout; also timed in turns
      (row_warps, new, new, row_warps) against the measuring build of the
      PR 2 kernel, -DQM_FWD_ROW_WARPS, with both builds' phase clock64()
      cycles a node, registers and blocks an SM, and held through its
      wrapper to 1e-3 of f64 on seeded inputs of every fm/act pattern at
      7 x 67, one node, one scenario, 397 scenarios (past one wave) and
      misaligned inputs), each against its plain
      version in f64 on the same inputs (pass: relative max error <= 1e-4
      for K3a/K3b, <= 1e-3 for the sweeps and K3d; the plain f32 error
      printed beside), timed with CUDA events next to its bound and its
      plain time;
      K2 and K3c run the reg variant there, and the smem variant on the same
      data is checked too and timed in turns (smem, reg, reg, smem), with
      each variant's per-phase clock64() cycles a node; then K2 and K3c at
      (Bb, N, nx, nu) = (5, 9, 7, 4), (3, 1, 30, 30), (7, 11, 36, 32),
      (2, 5, 30, 36), (3, 4, 36, 36) and (2, 5, 30, 33), with and without a
      shift, on the JAX tests' random recipe, each through the variant
      sweep_variant names (reg, reg, reg with two solving warps, reg2,
      reg2 with two solving warps, reg2) and within 1e-3 of the f64 plain
      sweep; K1-ll (lanes-last K1, through K1's dispatch: reg32 at
      384 x 30 x 31) against spd_solve_plain, timed beside
      torch.cholesky_solve on the permuted view, then with ragged batches, reg64
      by rows and by columns and blk128 among them;
      each new wrapper refuses float64 and a non-contiguous input.
  (e) backends: BatchedMpc(backend="bm_fused") and ("lq_fused") driven as
      (b) drives bm_k1 (one cold and 20 warm steps, exact launches a step:
      bm_fused K1 1 (reg16) + K2 1 (reg); lq_fused K3a, K3b, K3c (reg), K3d
      1 each, no K1;
      mean violation <= 1e-5), their LQ stage's host ms and device busy
      ms at (b)'s iterate and its max|dX|, |dU| difference from bm_k1 there,
      and (c)'s cross-precision check for each.
  (f) backends in mirrored pairs: bm_k1, bm_fused, lq_fused, lq_fused,
      bm_fused, bm_k1, 2 steps each on the problems (b) and (e) built, host
      ms a step of each turn and each backend's mean.
  (g) force tracking (nu = 36) at full width: (b)'s problem with the stage
      widened (grasp from t >= 0.3 s, wrench reference [4, 0, -9, 0, 0,
      0.4]) and U from weight_compensating_input_ft; bm_k1 and bm_fused
      driven as (b) drives bm_k1 (exact launches a step: bm_k1 K1 68 = 1
      reg16 + 67 reg64; bm_fused K1 1 reg16 + K2 1 reg2), mean violation <=
      1e-5, the off-grasp wrench exactly 0, per-stage host ms and the card's
      idle share, and (c)'s cross-precision check for each; K1's reg64
      variant at 384 x 36 x 31 (node 0's gain system at the warm iterate,
      within 1e-4 of f64; timed in turns against PR 1's kernel) and K2's
      reg2 variant at 384 x 67 x 30 x 36 (within 1e-3 of f64; at least 3
      blocks an SM by cudaOccupancyMaxActiveBlocksPerMultiprocessor; the
      smem variant on the same inputs held to f64 too and timed in turns,
      smem, reg2, reg2, smem, with both variants' phase clocks a node; K3c's
      reg2 on the same inputs held to f64),
      each timed beside its bound and its plain
      version (K1 also beside torch.linalg); the other options on bm_k1
      with the launches checked: lin_tangents f32 and bf16 a cold and 20
      warm steps each, mean violation <= 1e-5; sensitivity rk2, arm_locked
      on quad_only_config and per-scenario stage data a cold and 2 warm
      steps each, and (c)'s cross-precision check for each; one
      SqpSolver.solve (nu = 30) and one warm-started from it, host ms and K1
      launches (68 a solve: 1 reg16 + 67 reg32), every K1 call of the two
      solves within 1e-4 of its f64 plain version, and each solution
      against the same solve on the CPU in f64 within (c)'s bars. The CPU
      f64 runs of (g)'s cross-precision checks are made meanwhile in two
      spawned processes.

  (h) the whole-body cascade (wbc/wbc.py:hierarchical_wbc_batched, 36
      variables, and wbc/force.py:hierarchical_wbc_ft_batched, 42, with the
      wrench) as tools/wbc_bench.py runs them: B = 512 in f32, one cold and
      5 chained ticks (xs += 1e-9 * cmd[:, :30]) a stack, K1 exactly 101
      launches a tick, by variant (nominal 97 reg64 + 4 reg32, ft 101 reg64)
      and by shape (93 Newton, 4 + 4 Gram), ticks/s, host ms and device
      busy ms a tick, the card's idle share; every K1 call of one tick
      held to spd_solve_plain in f64 (backward error <= 1e-4 and forward
      error <= n * cond * 2^-23 on every system: the Newton systems reach
      condition 1e6-1e10) and counted by shape; K1 at each of the six
      shapes on the tick's own systems, timed beside its bound, its plain
      version and torch.linalg; at B = 4 the card's f32 tick and the CPU's
      f32 and f64 ticks each finite and within the physical bars (level-0
      EoM residual and swing-foot forces < 1e-2, level-0 inequalities
      <= 1e-2, torques within effort_limit x (1 + 1e-3)), each f32 tick's
      level-1 and level-2 residuals within 0.02 and 0.2 of ||b_l|| of the
      f64 tick's, the card against each CPU tick printed on
      cmd / max(|cmd|, 1).
  (i) the batched closed loop (sim/batched_rollout.py:BatchedClosedLoop)
      as tools/rollout_bench.py runs it: B = 1024 scenarios, f32, bm_k1,
      default_config() (lin_chunk = 0), the trot from t = 0, N = 67,
      SimConfig(), 10 physics steps a cycle with a WBC tick every 2,
      seed-0 perturbations of q0 x 0.01, a 0-60 N payload every cycle and a
      0-60 N push in cycles 3-4; one untimed cycle, then 6 timed cycles
      from the same start: closed_loop_sim_s_per_wall_s, mpc_solves_per_s,
      the wall time, host ms a cycle by part (solve, WBC ticks, physics
      steps; one more cycle, each part ended by a synchronize), device busy
      ms and the card's idle share of one cycle, K1 exactly 573 launches a
      cycle (by variant: reg16 1, reg32 87, reg64 485; by shape), the K1
      calls of one cycle's SQP step and first WBC tick held to f64 (as
      (h)), the alive count; held: every
      state finite, all 1024 alive, every base within 5 cm of the stance
      height; K1 at the loop's five shapes timed beside its bound, its
      plain version and torch.linalg; at B = 4 and 2 cycles the card's f32
      loop against the CPU's f64 loop (run in a spawned process once the
      timings are taken) on the base pose and the joint positions after
      each cycle (LOOP_CROSS_BARS).
  (j) one robot, the README's entry point (sim/closed_loop.py:
      ClosedLoopRunner) on tools/record_trace.py:canonical_trot_run's
      set-up: AlienGo+Z1, default_config() with the legs and the arm
      commanded from t = 0, N = 67, f32, 0.1 s of the trot (100 physics
      steps, 50 ticks, 11 solves), every solve, tick and physics step
      timed between two synchronizes (host ms against the 10 / 2 / 1 ms
      periods), one solve and one tick under torch.profiler (the card's
      idle share of each) and their K1 calls held to f64; K1 exactly 68 a
      solve and 101 a tick, by variant and shape; held to the golden trace's
      first 50 rows (docs/artifacts/trot_2s_trace.jsonl) at TROT_BARS; K1
      at the solve's and the tick's batch-1 shapes timed beside its bound,
      its plain version and torch.linalg; then the separated WBC and the
      Kalman filter (sensor_noise="default") for 0.01 s each, K1 exact, the
      card's f32 run against the port's own f64 run on the CPU (computed
      meanwhile in two spawned processes, once the trot's timings are
      taken) at SIDE_BARS: the base pose, the leg and the arm joints.
  (k) the door (sim/door_loop.py:DoorOpeningRunner) on the push door:
      AlienGo+Z1, default_config() with the legs and the arm commanded from
      t = 0, N = 67, f32, DoorScenario(t_reach=0.01, handle_ahead=0.0) for
      0.04 s (40 coupled physics steps with the grasp spring and the panel
      contact, 20 force-aware ticks, 2-iteration solves at t = 0 (cold and
      warm), 10, 20 and 30 ms), every solve, tick and coupled step timed
      between two synchronizes, one solve and one tick under
      torch.profiler (the card's idle share) and their K1 calls held to
      f64; K1 exactly 136 a solve (2 reg16 projections at 67 x 12 x 18, 134
      reg64 gains at 1 x 36 x 31) and 101 a tick (reg64: 93 at 1 x 42 x 1,
      4 at 1 x 36 x 42, 4 at 1 x 58 x 42), by variant and shape; held to
      the JAX package's f64 trace of the same window
      (docs/artifacts/door_press_trace.jsonl) at DOOR_BARS, the solves'
      times and phases the trace's (press at 10, 20, 30 ms), the planned
      wrench exactly 0 on the reach ticks and non-zero after the first
      press solve, every violation within VIOLATION_MAX; K1 at the door's
      five shapes timed beside its bound, its plain version and
      torch.linalg.

Every launch counter is set to 0 just before each backend's steps and read
just after. The line before the last is {"kernels": [...]} (K1 and K2 a
second time, on (g)'s force-tracking path; K1 at (h)'s six shapes; K1 on
(i)'s path, a cycle's work; K1 on (j)'s and (k)'s paths, a solve and five
ticks each); the last line is {"ok": true, "device": {...}}.
"""
import contextlib
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

BATCH = 384
WARM_STEPS = 20
PERTURBATION = 0.02
HBM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3
F32_FLOPS_PER_S = 67e12     # H100 SXM f32, outside the tensor cores
K1_REL_TOL = 1e-4
PROJECTION_REL_TOL = 1e-4  # K3a, K3b
SWEEP_REL_TOL = 1e-3       # K2, K3c, K3d
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


def graph_ms(fn, calls=50, replays=5):
    """Device ms per call of `fn` with no host in the loop: `calls` calls
    captured in one CUDA graph (after a warm-up call on a side stream),
    replayed `replays` times between two CUDA events."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (calls * replays)


def in_turns(calls, order, timer):
    """Time each call of `calls` ({name: call}) with `timer` (call -> ms),
    once for each place its name has in `order`, in that order, so that
    every build or variant meets the card's clocks alike. Returns the
    per-turn times ({"<name>_<i>": ms}) and each name's mean."""
    turns = {f"{name}_{i}": timer(calls[name]) for i, name in enumerate(order)}
    means = {name: float(np.mean([ms for key, ms in turns.items()
                                  if key.rsplit("_", 1)[0] == str(name)])) for name in calls}
    return turns, means


def chained(reps):
    """A timer for in_turns: ms a call over `reps` chained calls (cuda_ms)."""
    return lambda fn: cuda_ms(fn, reps=reps)


def device_busy(fn):
    """One call of `fn` under torch.profiler: the union of the device
    intervals it traced (kernels, copies, fills) in ms, their count, and the
    five kernels with the most device time. kernel_ms is None where the
    profiler saw no device activity (no CUPTI). Only the device is traced:
    tracing the host's operators too made each step's profile tens of
    seconds longer and changed none of these numbers. The raw kineto events
    are read, not prof.events(): building those took ~70 s for one
    closed-loop cycle's ~330k device ops."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    spans, by_name = [], {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            spans.append((e.start_ns(), e.end_ns()))
            by_name[e.name()] = by_name.get(e.name(), 0.0) + e.duration_ns() / 1e6
    busy_ns, end = 0, float("-inf")
    for start, stop in sorted(spans):
        if stop > end:
            busy_ns += stop - max(start, end)
            end = stop
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    return {"kernel_ms": busy_ns / 1e6 if spans else None, "device_ops": len(spans),
            "top_ms": {name[:80]: ms for name, ms in top}}


def spd_batch(rng, batch, n, m):
    """SPD matrices with eigenvalues logspaced over [1, 1e3] (condition 1e3)."""
    Q, _ = np.linalg.qr(rng.normal(size=(batch, n, n)))
    eig = np.logspace(0.0, 3.0, n)
    A = (Q * eig[None, None, :]) @ np.swapaxes(Q, -1, -2)
    A = 0.5 * (A + np.swapaxes(A, -1, -2))
    return A, rng.normal(size=(batch, n, m))


def build_all():
    """Build every kernel source of qm_door_torch/csrc, the diagnostic build
    of the sweep kernel and the measuring and diagnostic builds of K3a/K3b
    and K3d, one nvcc each, all started together; log each one's ptxas
    report (kept from the build when a library is reused) and fail unless
    it shows the four K1 reg16 / reg32 kernels, the four reg64 kernels
    (rows padded to 48 / 64 x solved by rows / columns), the blk128 kernel,
    the six sweep kernels (K2/K3c x
    reg/reg2/smem), the four K3a/K3b kernels (x bulk/4-byte copies) and the two
    K3d kernels (bulk/4-byte copies) of the normal build without spills.
    The phase-clock builds' spills are logged: their cycle counts carry
    them."""
    from qm_door_torch.ops import cuda_build
    from qm_door_torch.ops import lq
    from qm_door_torch.ops import riccati_fused

    libs = [(n[:-3], ()) for n in sorted(os.listdir(cuda_build.CSRC)) if n.endswith(".cu")]
    libs += [("riccati_bwd", (riccati_fused.PHASE_CLOCKS,))]
    libs += [("lq_project", PROJECTION_BUILDS["scalar"])]
    libs += [("lq_project", d + (lq.PHASE_CLOCKS,)) for d in PROJECTION_BUILDS.values()]
    libs += [("lq_forward", FORWARD_BUILDS["row_warps"])]
    libs += [("lq_forward", d + (lq.FWD_PHASE_CLOCKS,)) for d in FORWARD_BUILDS.values()]
    t0 = time.time()
    with ThreadPoolExecutor(len(libs)) as pool:
        outs = list(pool.map(lambda lib: cuda_build.build(*lib), libs))
    log(f"built {', '.join(' -D'.join((n,) + d) for n, d in libs)} in {time.time() - t0:.1f} s")
    for (name, defines), out in zip(libs, outs):
        for line in out.splitlines():
            log(f"nvcc {' -D'.join((name,) + defines)}: {line}")
    for label, lib, kernel, count in (
            ("K1 reg16 / reg32", ("spd_solve", ()), "spd_reg_kernel", 4),
            ("K1 reg64", ("spd_solve", ()), "spd_reg64_kernel", 4),
            ("K1 blk128", ("spd_solve", ()), "spd_blk128_kernel", 1),
            ("sweep kernels", ("riccati_bwd", ()), "riccati_bwd_kernel", 6),
            ("K3a/K3b kernels", ("lq_project", ()), "project_", 4),
            ("K3d kernels", ("lq_forward", ()), "forward_kernel", 2)):
        spills = kernel_spills(outs[libs.index(lib)], kernel)
        log(f"{label}, bytes of spill stores: {json.dumps(spills)}")
        if len(spills) != count or any(spills.values()):
            raise RuntimeError(f"{label}: expected {count} kernels without spills, "
                               f"ptxas reports {spills}")
    for build, defines in PROJECTION_BUILDS.items():
        out = outs[libs.index(("lq_project", defines + (lq.PHASE_CLOCKS,)))]
        LQ_CLOCK_SPILLS[build] = {lq_instance(name): v
                                  for name, v in kernel_spills(out, "project_").items()}
    log(f"K3a/K3b phase-clock builds, bytes of spill stores: {json.dumps(LQ_CLOCK_SPILLS)}")
    for build, defines in FORWARD_BUILDS.items():
        FORWARD_PTXAS[build] = forward_ptxas(outs[libs.index(("lq_forward", defines))])
        FORWARD_CLOCK_SPILLS[build] = {
            k: v["spill_stores"] for k, v in forward_ptxas(
                outs[libs.index(("lq_forward", defines + (lq.FWD_PHASE_CLOCKS,)))]).items()}
    log(f"K3d builds (registers, spills): {json.dumps(FORWARD_PTXAS)}; phase-clock builds, "
        f"bytes of spill stores: {json.dumps(FORWARD_CLOCK_SPILLS)}")
    clock_spills = kernel_spills(
        outs[libs.index(("riccati_bwd", (riccati_fused.PHASE_CLOCKS,)))], "riccati_bwd_kernel")
    SWEEP_CLOCK_SPILLS.update({sweep_instance(k): v for k, v in clock_spills.items()})
    log(f"sweep phase-clock build, bytes of spill stores: {json.dumps(SWEEP_CLOCK_SPILLS)}")


SWEEP_CLOCK_SPILLS = {}  # the phase-clock build's spills, noted beside its readings
LQ_CLOCK_SPILLS = {}     # the same for K3a/K3b's phase-clock builds, by build
FORWARD_CLOCK_SPILLS = {}  # and for K3d's, by build
FORWARD_PTXAS = {}         # K3d's registers and spills, by build and instantiation
# K3a/K3b's builds: the normal one and the scalar-product kernels (a measuring build)
PROJECTION_BUILDS = {"new": (), "scalar": ("QM_LQ_SCALAR_PRODUCTS",)}
# K3d's builds: the normal one and the PR 2 kernel (a measuring build)
FORWARD_BUILDS = {"new": (), "row_warps": ("QM_FWD_ROW_WARPS",)}
LQ_BUILDS = {"K3a": PROJECTION_BUILDS, "K3b": PROJECTION_BUILDS, "K3d": FORWARD_BUILDS}


SWEEP_TEMPLATE_VARIANTS = {"0": "smem", "1": "reg", "2": "reg2"}  # csrc/riccati_bwd.cu:Variant


def sweep_instance(name):
    """"K2_reg", "K3c_reg2", "K2_smem", ... for a mangled
    riccati_bwd_kernel<kSym, V> name."""
    tail = name.split("riccati_bwd_kernelILb")[1]  # "<kSym>ELi<V>E..."
    return f"{'K2' if tail[0] == '1' else 'K3c'}_{SWEEP_TEMPLATE_VARIANTS[tail[4]]}"


def kernel_spills(ptxas_out, kernel):
    """Bytes of spill stores of each instantiation of `kernel` in a ptxas -v
    report ("Function properties for <name>" then "... N bytes spill stores
    ...")."""
    spills, current = {}, None
    for line in ptxas_out.splitlines():
        if "Function properties for" in line:
            current = line.split("Function properties for")[-1].strip()
        elif current and "spill stores" in line:
            if kernel in current:
                spills[current] = int(line.split("bytes spill stores")[0].split(",")[-1])
            current = None
    return spills


def kernel_registers(ptxas_out, kernel):
    """Registers of each instantiation of `kernel` in a ptxas -v report."""
    out, current = {}, None
    for line in ptxas_out.splitlines():
        if "Compiling entry function" in line:
            current = line.split("'")[1] if kernel in line else None
        elif current and "Used" in line and "registers" in line:
            out[current] = int(line.split("Used")[1].split("registers")[0])
    return out


def lq_instance(name):
    """"geom_bulk", "cost_cp.async4", ... for a mangled
    project_<geom|cost>_kernel<kBulk> name; "geom", "cost" for the scalar-product
    kernels (no template)."""
    kind = name.split("_kernel")[0].split("project_")[-1]
    if "kernelILb" not in name:
        return kind
    return f"{kind}_{'bulk' if name.split('kernelILb')[1][0] == '1' else 'cp.async4'}"


def forward_instance(name):
    """"bulk", "cp.async4" for a mangled forward_kernel<kBulk> name;
    "row_warps" for the PR 2 kernel (no template)."""
    if "kernelILb" not in name:
        return "row_warps"
    return "bulk" if name.split("kernelILb")[1][0] == "1" else "cp.async4"


def forward_ptxas(report):
    """{instantiation: {"registers", "spill_stores"}} of K3d's kernels in a
    ptxas report of an lq_forward build."""
    spills = kernel_spills(report, "forward_kernel")
    return {forward_instance(f): {"registers": r, "spill_stores": spills[f]}
            for f, r in kernel_registers(report, "forward_kernel").items()}


def launch_counters():
    """Every kernel wrapper that counts its launches, by kernel id."""
    from qm_door_torch.ops import lq, riccati_fused, spd_solve

    return {"K1": spd_solve.spd_solve, "K1-ll": spd_solve.spd_solve_ll,
            "K2": riccati_fused.riccati_backward_fused, "K3a": lq.project_geom,
            "K3b": lq.project_cost, "K3c": lq.riccati_backward_ll, "K3d": lq.riccati_forward_ll}


def reset_launches():
    for wrapper in launch_counters().values():
        wrapper.launches = 0
        for variant in getattr(wrapper, "launches_by_variant", {}):
            wrapper.launches_by_variant[variant] = 0
        getattr(wrapper, "launches_by_shape", {}).clear()


def read_launches():
    return {kid: wrapper.launches for kid, wrapper in launch_counters().items()}


def k1_run(A, Y, X_ref, label, shift=0.0, variant=None):
    """One K1 call on the card (the variant its dispatch picks, or `variant`
    forced): fails unless it ran that variant and is within K1_REL_TOL of
    the f64 reference X_ref (relative to max|X_ref|). Returns X, the
    relative error and the variant."""
    import torch

    from qm_door_torch.ops.spd_solve import k1_variant, spd_solve

    want = variant or k1_variant(*Y.shape[1:])
    before = dict(spd_solve.launches_by_variant)
    X = spd_solve(A, Y, shift, _variant=variant)
    torch.cuda.synchronize()
    ran = {v: cnt - before[v] for v, cnt in spd_solve.launches_by_variant.items()
           if cnt != before[v]}
    rel = (X.double() - X_ref).abs().max().item() / X_ref.abs().max().item()
    if ran != {want: 1}:
        raise RuntimeError(f"K1 {label}: launched {ran}, expected one {want}")
    if not rel <= K1_REL_TOL:
        raise RuntimeError(f"K1 {label} ({want}): relative error {rel:.3e} > {K1_REL_TOL}")
    return X, rel, want


@contextlib.contextmanager
def k1_calls(*modules):
    """Records every call the given modules make to their spd_solve (K1's
    wrapper) as (A, Y, shift, X) while the context is open."""
    calls, solves = [], [m.spd_solve for m in modules]

    def recording(solve):
        def call(A, Y, shift=0.0, **kw):
            X = solve(A, Y, shift, **kw)
            calls.append((A, Y, shift, X))
            return X
        return call

    for m, solve in zip(modules, solves):
        m.spd_solve = recording(solve)
    try:
        yield calls
    finally:
        for m, solve in zip(modules, solves):
            m.spd_solve = solve


def check_k1_calls(calls, label):
    """Each recorded K1 call's result against spd_solve_plain in f64 on the
    same inputs: fails above K1_REL_TOL (relative to max|X_ref| of the call).
    Returns the worst relative error and the calls by shape."""
    from qm_door_torch.ops.spd_solve import spd_solve_plain

    worst, shapes = 0.0, {}
    for A, Y, shift, X in calls:
        ref = spd_solve_plain(A.double(), Y.double(), shift)
        rel = (X.double() - ref).abs().max().item() / max(ref.abs().max().item(), 1e-30)
        if not rel <= K1_REL_TOL:
            raise RuntimeError(f"K1 {label} at {tuple(Y.shape)}: relative error {rel:.3e} "
                               f"> {K1_REL_TOL}")
        worst = max(worst, rel)
        key = "x".join(map(str, Y.shape))
        shapes[key] = shapes.get(key, 0) + 1
    return worst, shapes


def phase_kernels(dev):
    """(a) hold K1 against its plain versions, time its variants in turns."""
    import torch

    from qm_door_torch.ops.spd_solve import spd_solve, spd_solve_plain

    rng = np.random.default_rng(0)
    shapes = [("projection", BATCH * 67, 12, 49, 1),
              ("riccati_gain", BATCH, 30, 31, 67)]
    # the whole-body cascade's shapes at the WBC bench's batch (h): per tick
    shapes += [(f"wbc_{stack}_{kind}", WBC_BATCH, n, m, 0)
               for stack, by_shape in WBC_K1_SHAPES.items()
               for kind, (n, m, _) in by_shape.items()]
    # K1's range past n = 64: the stacked interior-point systems of
    # wbc/qp.py:solve_qp_batched (n + nv = 92) and the bound's ends
    shapes += [(label, WBC_BATCH, n, 1, 0) for label, n in K1_RANGE_SHAPES]
    # the door's force-tracking tick and nu = 36 gain at batch 1
    shapes += [(label, 1, n, m, 0) for label, n, m in K1_DOOR_SHAPES]
    rows = []
    for label, batch, n, m, per_step in shapes:
        A64, Y64 = spd_batch(rng, batch, n, m)
        A = torch.tensor(A64, dtype=torch.float32, device=dev)
        Y = torch.tensor(Y64, dtype=torch.float32, device=dev)
        X_ref = spd_solve_plain(torch.tensor(A64, device=dev), torch.tensor(Y64, device=dev))
        X_k, rel_k, variant = k1_run(A, Y, X_ref, label)
        X_p = spd_solve_plain(A, Y)
        torch.cuda.synchronize()
        rel_p = (X_p.double() - X_ref).abs().max().item() / X_ref.abs().max().item()
        abs_kp = (X_k - X_p).abs().max().item()
        if not (rel_p <= K1_REL_TOL and np.isfinite(abs_kp)):
            raise RuntimeError(f"K1 {label} ({batch},{n},{m}): plain f32 relative error "
                               f"{rel_p:.3e} > {K1_REL_TOL}")
        row = dict(shape=label, batch=batch, n=n, m=m, calls_per_step=per_step,
                   variant=variant, rel_err_kernel=rel_k, rel_err_plain=rel_p,
                   max_abs_err=abs_kp)
        if label.startswith("wbc_"):
            _, stack, kind = label.split("_", 2)
            row["calls_per_tick"] = WBC_K1_SHAPES[stack][kind][2]
        # ms: 50 chained calls through the wrapper between two CUDA events, as
        # every kernel is timed (the wrapper's host time bounds it when that
        # exceeds the kernel's); ms_graph: the same 50 calls in a CUDA graph,
        # the kernel with no host in the loop; PR 1's kernel (smem) on the
        # same inputs, in turns
        turns = ("smem", variant, variant, "smem")
        _, row["rel_err_smem"], _ = k1_run(A, Y, X_ref, label, variant="smem")
        calls = {v: (lambda v=v: spd_solve(A, Y, _variant=v)) for v in turns}
        row["ms_turns"], events = in_turns(calls, turns, chained(50))
        row["ms_graph_turns"], graph = in_turns(calls, turns, graph_ms)
        ms = events[variant]
        row["ms_graph"] = graph[variant]
        row.update(ms_smem=events["smem"], ms_smem_graph=graph["smem"])
        plain_ms = cuda_ms(lambda: spd_solve_plain(A, Y), reps=5, warmup=1)
        lib_ms = cuda_ms(lambda: torch.cholesky_solve(Y, torch.linalg.cholesky(A)), reps=20)
        # the kernel reads A's lower triangle and Y once, writes X once
        nbytes = 4 * batch * (n * (n + 1) // 2 + 2 * n * m)
        flops = batch * (n ** 3 / 3.0 + 2.0 * n * n * m)
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOPS_PER_S * 1e3
        row.update(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bytes=nbytes,
                   flops=flops, bytes_ms=t_bytes, ops_ms=t_ops, bound_ms=max(t_bytes, t_ops),
                   bound_by="bytes" if t_bytes >= t_ops else "operations")
        log("[a] " + json.dumps(row))
        rows.append(row)
    check_k1_edges(dev, rng)
    check_stacked_qp(dev, rng)
    return rows


K1_RANGE_SHAPES = (("range_65", 65), ("stacked_qp_92", 92), ("range_128", 128))
# the door's batch-1 K1 shapes (force tracking, 42 variables): the Newton
# solve, the two Gram solves and the nu = 36 gain
K1_DOOR_SHAPES = (("door_newton", 42, 1), ("door_gram0", 36, 42), ("door_gram1", 58, 42),
                  ("door_gain", 36, 31))
# wbc/qp.py:solve_qp_batched on the stacked form of a level QP at the WBC's
# sizes (n = 36 variables, nv = 56 slacked inequalities: n + nv = 92, K1's
# blk128 variant), B = 512
STACKED_QP = {"batch": 512, "n": 36, "nv": 56, "mp": 8}
STACKED_QP_CPU = 32  # the problems also solved on the CPU (f64 and f32), and
# those of each K1 call held to f64
K1_EDGES = (  # batch, n, m, shift
    (1, 1, 1, 0.0), (7, 12, 5, 0.5), (1000, 12, 49, 1e-3), (1001, 30, 33, 0.0),
    (33, 64, 1, 1e-5), (5, 17, 100, 0.0), (3, 65, 7, 1e-3), (2, 128, 33, 0.0), (9, 100, 1, 0.0),
    # the variants' boundaries: n = 16 | 17 and 32 | 33, m = 64 | 65
    (1058, 16, 40, 0.0), (37, 17, 40, 1e-3), (1059, 32, 31, 0.0), (9, 33, 31, 0.0),
    (11, 12, 64, 0.0), (11, 12, 65, 0.0), (6, 30, 64, 1e-3), (6, 30, 65, 0.0),
    # large batches that leave the last 4-warp block half filled, and a
    # grid stride with a ragged last round
    (4 * 1000 + 2, 12, 49, 0.0), (40003, 12, 49, 0.0), (3 * 1031 + 1, 30, 31, 0.0),
    # (g)'s SqpSolver.solve: the projection's node solves and a one-system gain
    (67, 12, 18, 0.0), (1, 30, 31, 0.0),
    # reg64 and blk128: n = 48 | 49 (reg64's row padding 48 | 64), 64 | 65,
    # m = 1 | 2, m past 64 (columns from device memory), one and several
    # systems a block, ragged blocks, the loop's 1024 x 36 x 1 and a batch
    # past one wave with a ragged last wave
    (5, 48, 1, 0.0), (6, 49, 1, 1e-3), (7, 64, 2, 0.0), (3, 65, 1, 0.0), (1, 40, 1, 0.0),
    (2, 36, 2, 1e-3), (1, 64, 4000, 0.0), (3, 50, 100, 0.0), (1, 52, 36, 0.0),
    (1026, 36, 1, 0.0), (1024, 36, 1, 1e-5), (5003, 36, 1, 0.0), (1, 128, 1, 0.0),
)


def check_stacked_qp(dev, rng):
    """wbc/qp.py:solve_qp_batched on the card at STACKED_QP's sizes: the
    stacked [z; v] form of random level QPs (tests/test_wbc_batched.py's
    recipe) in f32, its 30 Newton solves and the polish on K1 at
    (512, 92, 1), exactly 31 launches, the first STACKED_QP_CPU systems of
    each held to f64 (check_wbc_k1_calls); the solution finite and feasible
    to 1e-3, and on
    the first STACKED_QP_CPU problems its objective off the CPU's f64 solve
    (relative to max(1, |f64|), the mean over the problems) by at most
    twice the CPU's own f32 solve's: the f32 interior point stops at mu_tol
    and polishes, which leaves its objective percents off the f64 one on
    this recipe (a few percent in the JAX package's f32 solve too)."""
    import torch

    from qm_door_torch.ops.spd_solve import spd_solve
    from qm_door_torch.wbc import qp

    B, n, nv, mp = (STACKED_QP[k] for k in ("batch", "n", "nv", "mp"))
    Az = rng.normal(size=(B, n + 2, n))
    H = np.zeros((B, n + nv, n + nv))
    H[:, :n, :n] = np.swapaxes(Az, -1, -2) @ Az + 1e-6 * np.eye(n)
    H[:, n:, n:] = np.eye(nv)
    c = np.concatenate([rng.normal(size=(B, n)), np.zeros((B, nv))], axis=-1)
    eye = np.broadcast_to(np.eye(nv), (B, nv, nv))
    G = np.concatenate([np.concatenate([rng.normal(size=(B, nv, n)), -eye], axis=-1),
                        np.concatenate([np.zeros((B, nv, n)), -eye], axis=-1),
                        np.concatenate([rng.normal(size=(B, mp, n)), np.zeros((B, mp, nv))],
                                       axis=-1)], axis=1)
    h = np.concatenate([rng.normal(size=(B, nv)) + 0.5, np.zeros((B, nv)),
                        rng.normal(size=(B, mp)) + 0.5], axis=-1)

    def solve(device, dtype, k=B):
        return qp.solve_qp_batched(*(torch.tensor(a[:k], dtype=dtype, device=device)
                                     for a in (H, c, G, h)))[0].double().cpu().numpy()

    reset_launches()
    with k1_calls(qp) as calls:
        z = solve(dev, torch.float32)
        torch.cuda.synchronize()
    by_shape = dict(spd_solve.launches_by_shape)
    k = STACKED_QP_CPU
    k1 = check_wbc_k1_calls([(A[:k], Y[:k], shift, X[:k]) for A, Y, shift, X in calls],
                            "in solve_qp_batched (stacked)")
    k1["calls_by_shape"] = shape_keys(k1["calls_by_shape"])
    del calls
    cpu = torch.device("cpu")
    z64, z32 = solve(cpu, torch.float64, k), solve(cpu, torch.float32, k)
    obj = lambda x: (0.5 * np.einsum("bi,bij,bj->b", x, H[:k], x)  # noqa: E731
                     + np.einsum("bi,bi->b", c[:k], x))
    rel = lambda x: float((np.abs(obj(x[:k]) - obj(z64))  # noqa: E731
                           / np.maximum(1.0, np.abs(obj(z64)))).mean())
    feas = float((np.einsum("bij,bj->bi", G, z) - h).max())
    out = {"shape": [B, n + nv, n + nv, 1], "launches_by_shape": shape_keys(by_shape),
           "k1_calls_against_f64": k1, "finite": bool(np.isfinite(z).all()),
           "feasibility_max": feas, "cpu_problems": k, "objective_rel_dev_mean": rel(z),
           "cpu_f32_objective_rel_dev_mean": rel(z32),
           "z_dev_max": float(np.abs(z[:k] - z64).max())}
    log("[a] stacked QP " + json.dumps(out))
    if not (by_shape == {(B, n + nv, 1): 31} and out["finite"] and feas <= 1e-3
            and rel(z) <= max(2 * rel(z32), 1e-6)):
        raise RuntimeError(f"solve_qp_batched on the card: {out}")


def check_k1_edges(dev, rng):
    """K1 off the main shapes, each through the variant k1_variant names:
    ragged batches (one and several systems a block, half-filled blocks, a
    ragged grid stride, reg64 past one wave), n = 1, 16 | 17, 32 | 33,
    48 | 49, 64 | 65 and 128, m = 1 | 2, 64 | 65, 100 and 4000, RHS widths
    around the 32-lane stride, a shift; then each variant (reg64 by rows and
    by columns, from shared and from device memory) on a misaligned base
    with NaN above the diagonal (never read); and the launches it must
    refuse."""
    import torch

    from qm_door_torch.ops.spd_solve import spd_solve, spd_solve_plain

    ran = {}
    for batch, n, m, shift in K1_EDGES:
        A64, Y64 = spd_batch(rng, batch, n, m)
        X_ref = spd_solve_plain(torch.tensor(A64, device=dev), torch.tensor(Y64, device=dev),
                                shift)
        _, _, variant = k1_run(torch.tensor(A64, dtype=torch.float32, device=dev),
                               torch.tensor(Y64, dtype=torch.float32, device=dev), X_ref,
                               f"edge ({batch},{n},{m})", shift)
        ran[f"{batch}x{n}x{m}"] = variant

    def misaligned(t):  # contiguous, one float past an aligned base
        flat = torch.empty(t.numel() + 1, dtype=torch.float32, device=dev)
        out = flat[1:].view(t.shape)
        out.copy_(t)
        return out

    for batch, n, m in ((13, 12, 49), (13, 30, 31), (13, 40, 3), (13, 40, 1), (13, 50, 70),
                        (13, 92, 1)):
        A64, Y64 = spd_batch(rng, batch, n, m)
        X_ref = spd_solve_plain(torch.tensor(A64, device=dev), torch.tensor(Y64, device=dev))
        A = torch.tensor(A64, dtype=torch.float32, device=dev)
        A = torch.where(torch.ones(n, n, dtype=torch.bool, device=dev).triu(1), float("nan"), A)
        _, _, variant = k1_run(misaligned(A), misaligned(torch.tensor(Y64, dtype=torch.float32,
                                                                      device=dev)),
                               X_ref, f"misaligned, NaN above the diagonal ({batch},{n},{m})")
        ran[f"misaligned_nan_upper_{batch}x{n}x{m}"] = variant
    # reg64 and blk128 read the right-hand sides past 64 columns from device
    # memory, so no n <= 128 outgrows their shared memory; PR 1's kernel
    # (forced) still stages the whole system and must refuse 64 x 4000
    refusals = (
        (TypeError, torch.eye(4, device=dev, dtype=torch.float64)[None],
         torch.ones(1, 4, 1, device=dev, dtype=torch.float64), None),
        (ValueError, torch.eye(129, device=dev)[None], torch.ones(1, 129, 1, device=dev), None),
        (ValueError, torch.eye(64, device=dev)[None], torch.ones(1, 64, 4000, device=dev),
         "smem"),
    )
    for error, A, Y, variant in refusals:
        try:
            spd_solve(A, Y, _variant=variant)
        except error:
            continue
        raise RuntimeError(f"K1 took ({tuple(A.shape)}, {tuple(Y.shape)}, {A.dtype}) on "
                           f"{variant or 'its dispatch'}, which it must refuse with "
                           f"{error.__name__}")
    log(f"[a] K1 edge cases (variant each ran) and refusals: ok {json.dumps(ran)}")


# force tracking, phase (g): the grasp from FT_GRASP_FROM s on, the wrench
# reference of tests/test_batched_sqp.py:82-85
FT_GRASP_FROM = 0.3
FT_WRENCH_REF = (4.0, 0.0, -9.0, 0.0, 0.0, 0.4)
# the start times of the gait the scenarios take in turn with per-scenario
# stage data (shared_stage=False)
STAGE_T0S = (0.0, 0.1, 0.2, 0.3)


def make_problem(dev, dtype, batch, lin_tangents, backend="bm_k1", sensitivity="frozen",
                 force_tracking=False, quad_only=False, shared_stage=True, t0=0.0):
    """The bench problem: AlienGo+Z1, 1 s / 67-node trot horizon, targets at
    the nominal pose, seed-0 initial-state perturbations; BatchedMpc on the
    given LQ backend. Options: the force-tracking problem (nu = 36, the
    stage widened with the grasp from FT_GRASP_FROM s and the wrench
    reference FT_WRENCH_REF), the quad-only config (arm_locked), per-scenario
    stage data (the trot from the STAGE_T0S in turn); the horizon from t0 s
    on. Returns (mpc, stage,
    x_batch, X, U): the cold start, U from weight_compensating_input_ft
    (zero wrench) on the force-tracking problem."""
    import torch

    from qm_door_torch.config import default_config, quad_only_config
    from qm_door_torch.models import kinematics, spatial
    from qm_door_torch.models.model import aliengo_z1
    from qm_door_torch.ocp import force
    from qm_door_torch.ocp.gait import GAIT_LIBRARY, GaitSchedule
    from qm_door_torch.ocp.problem import StageData, build_stage_data, make_ocp_config
    from qm_door_torch.ocp.reference import TargetTrajectories
    from qm_door_torch.parallel.batched import BatchedMpc
    from qm_door_torch.solver.sqp import SqpSolver

    cfg = quad_only_config() if quad_only else default_config()
    cfg.sqp.linesearch_steps = 2
    cfg.sqp.lin_tangents = lin_tangents
    cfg.sqp.sensitivity = sensitivity
    model = aliengo_z1(dtype=dtype, device=dev)
    ocp = (force.make_ocp_config_ft if force_tracking else make_ocp_config)(model, cfg)
    solver = SqpSolver(model, ocp, cfg)
    x0 = torch.tensor(cfg.initial_state(), dtype=dtype, device=dev)
    R_ee, p_ee = kinematics.ee_pose(model, x0[6:30])
    tstate = torch.cat([x0, p_ee, spatial.rot_to_quat(R_ee)])
    targets = TargetTrajectories.create(
        torch.tensor([0.0, 1e5], dtype=dtype, device=dev),
        torch.stack([tstate, tstate]), torch.zeros((2, 30), dtype=dtype, device=dev))
    sched = GaitSchedule()
    sched.insert_template(GAIT_LIBRARY["trot"], 0.0, 5.0)
    if shared_stage:
        stage = build_stage_data(model, cfg, sched, targets, t0)
    else:
        stages = [build_stage_data(model, cfg, sched, targets, t0 + t) for t in STAGE_T0S]
        pick = torch.arange(batch, device=dev) % len(stages)
        stage = StageData(**{k: torch.stack([getattr(s, k) for s in stages])[pick]
                             for k in vars(stages[0]) if getattr(stages[0], k) is not None})
    if force_tracking:
        grasp = (stage.times >= FT_GRASP_FROM).to(dtype)
        stage = force.widen_stage_data(
            stage, grasp, torch.tensor(FT_WRENCH_REF, dtype=dtype, device=dev).expand(
                stage.times.shape[0], 6))
    perturb = np.random.default_rng(0).normal(size=(BATCH, 30)) * PERTURBATION
    x0_np = cfg.initial_state().astype(np.float32 if dtype == torch.float32 else np.float64)
    x_batch = torch.tensor(x0_np[None] + perturb[:batch], dtype=dtype, device=dev)
    mpc = BatchedMpc(solver, shared_stage=shared_stage, backend=backend)
    X, U = mpc.cold_start(stage, x_batch)
    if force_tracking:
        N = solver.n_intervals
        U = force.weight_compensating_input_ft(model, stage.contact_flags[:N]).expand(
            batch, N, 36).clone()
    return mpc, stage, x_batch, X, U


# launches a step of each LQ backend, and K1's by variant; every other
# counter must stay at 0
LAUNCHES_PER_STEP = {"bm_k1": {"K1": 68}, "bm_fused": {"K1": 1, "K2": 1},
                     "lq_fused": {"K3a": 1, "K3b": 1, "K3c": 1, "K3d": 1}}
K1_VARIANTS_PER_STEP = {"bm_k1": {"reg32": 67, "reg16": 1}, "bm_fused": {"reg16": 1},
                        "lq_fused": {}}
SWEEP_VARIANTS_PER_STEP = {"bm_k1": {}, "bm_fused": {"K2": {"reg": 1}},
                           "lq_fused": {"K3c": {"reg": 1}}}


def drive(dev, backend, tag, problem=None, warm_steps=WARM_STEPS, expect=None,
          viol_max=VIOLATION_MAX):
    """BatchedMpc(backend) at B = 384: one cold and `warm_steps` warm steps
    with the launch counters set to 0 just before and read just after;
    checks the launches a step and the mean violation. `problem`:
    make_problem's (mpc, stage, x_batch, X, U), by default (b)'s problem on
    `backend`; `expect`: the launches, K1's by variant and the sweeps' by
    variant a step, by default LAUNCHES_PER_STEP's and the two tables
    beside it; `viol_max` None: the violation is only required finite.
    Returns the run's numbers and its final state."""
    import torch

    from qm_door_torch.ops.spd_solve import spd_solve
    from qm_door_torch.solver import batched_sqp

    if problem is None:
        problem = make_problem(dev, torch.float32, BATCH, "analytic_bf16", backend)
    mpc, stage, x_batch, X, U = problem
    per_step, k1_per_step, sweep_per_step = expect or (
        LAUNCHES_PER_STEP[backend], K1_VARIANTS_PER_STEP[backend],
        SWEEP_VARIANTS_PER_STEP[backend])
    # count the linesearch's trajectory evaluations (1 or 2 a step)
    evaluate, evals = batched_sqp.evaluate_trajectory, []
    batched_sqp.evaluate_trajectory = lambda *a: evals.append(1) or evaluate(*a)
    try:
        reset_launches()
        t0 = time.time()
        X, U, stats = mpc.step(stage, x_batch, X, U)
        torch.cuda.synchronize()
        cold_s = time.time() - t0
        viols = [stats[1].mean()]  # on the card: read after the timed steps
        t0 = time.time()
        for _ in range(warm_steps):
            X, U, stats = mpc.step(stage, x_batch, X, U)
            viols.append(stats[1].mean())
        torch.cuda.synchronize()
        elapsed = time.time() - t0
        launches = read_launches()
        k1_variants = dict(spd_solve.launches_by_variant)
        sweep_variants = {kid: dict(w.launches_by_variant)
                          for kid, w in sweep_wrappers().items()}
    finally:
        batched_sqp.evaluate_trajectory = evaluate
    steps = warm_steps + 1
    want = {kid: per_step.get(kid, 0) * steps for kid in launches}
    want_k1 = {v: k1_per_step.get(v, 0) * steps for v in k1_variants}
    want_sweep = {kid: {v: sweep_per_step.get(kid, {}).get(v, 0) * steps
                        for v in counts} for kid, counts in sweep_variants.items()}
    viol = stats[1].mean().item()
    finite = bool(torch.isfinite(X).all() and torch.isfinite(U).all())
    if launches != want or k1_variants != want_k1 or sweep_variants != want_sweep:
        raise RuntimeError(f"{backend}: launches {launches}, K1 by variant {k1_variants}, "
                           f"sweeps by variant {sweep_variants} in {steps} steps, expected "
                           f"{want}, {want_k1}, {want_sweep}")
    if not (finite and np.isfinite(viol) and (viol_max is None or viol <= viol_max)):
        raise RuntimeError(f"{backend}: finite={finite}, mean violation {viol:.3e}")
    log(f"[{tag}] {backend}: launches in {steps} steps {launches}, K1 by variant "
        f"{k1_variants}, sweeps by variant {sweep_variants}")
    return dict(mpc=mpc, stage=stage, x_batch=x_batch, X=X, U=U, cold_s=cold_s,
                elapsed=elapsed, launches=launches, k1_variants=k1_variants,
                sweep_variants=sweep_variants, steps=steps, warm_steps=warm_steps, viol=viol,
                viol_by_step=torch.stack(viols).tolist(), linesearch_evals=len(evals))


def timer(stage_ms, device):
    """timed(name, fn): host ms per call over 3 calls (after one warm-up);
    one call's span on the stream between two CUDA events (device time plus
    the gaps where the card waits for the host); then one call profiled for
    device busy time."""
    import torch

    def timed(name, fn, reps=3):
        fn()
        torch.cuda.synchronize()
        t = time.time()
        for _ in range(reps):
            out = fn()
        torch.cuda.synchronize()
        stage_ms[name] = (time.time() - t) / reps * 1e3
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        device[name] = device_busy(fn)
        device[name]["stream_span_ms"] = start.elapsed_time(end)
        return out

    return timed


def run_result(run, backend, step_device):
    """The bench.py-style result line of one backend's run."""
    import torch

    elapsed, steps, warm = run["elapsed"], run["steps"], run["warm_steps"]
    step_ms = 1e3 * elapsed / warm
    busy_ms = step_device["kernel_ms"]
    return {
        "metric": "mpc_solves_per_s",
        "value": BATCH * warm / elapsed,
        "unit": "solves/s",
        "vs_baseline": BATCH * warm / elapsed / 10000.0,
        "batch": BATCH,
        "reps": warm,
        "per_solve_us": 1e6 * elapsed / (BATCH * warm),
        "compile_s": run["cold_s"],
        "backend": f"{backend}_cuda",
        "config": "combined",
        "mean_violation": run["viol"],
        "mean_violation_by_step": run["viol_by_step"],
        "device": torch.cuda.get_device_name(0),
        "impl": "torch",
        "step_ms": step_ms,
        "device_idle_share": None if busy_ms is None else 1.0 - busy_ms / step_ms,
        "launches": run["launches"],
        "launches_per_step": {k: v / steps for k, v in run["launches"].items() if v},
        "linesearch_evals_per_step": run["linesearch_evals"] / steps,
        "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 2 ** 30,
    }


def stage_split(run, riccati="k1"):
    """Per-stage split of a bm_k1 / bm_fused step at a driven run's warm
    iterate (separate timed calls, after its launch count was read): host
    ms, device busy ms and stream span of linearize, project, riccati and
    one linesearch candidate; then one whole step profiled. Returns the
    stage times, the device profile and the LQ data there."""
    from qm_door_torch.solver.riccati import lqr_solve_batched
    from qm_door_torch.solver.sqp import evaluate_trajectory
    from qm_door_torch.solver.transcription import linearize_ocp, project_ocp_batched

    mpc, stage, x_batch, X, U = (run[k] for k in ("mpc", "stage", "x_batch", "X", "U"))
    s, solver = mpc.solver.settings, mpc.solver
    B, N = U.shape[:2]
    stage_ms, device = {}, {}
    timed = timer(stage_ms, device)
    lq = timed("linearize", lambda: linearize_ocp(
        solver.model, solver.ocp, stage, s.dt, X, U, sensitivity=s.sensitivity,
        tangents=s.lin_tangents, stage_batched=not mpc.shared_stage))
    flags = stage.contact_flags[..., :N, :].expand(B, N, 4)
    grasp = None if stage.grasp_flags is None else stage.grasp_flags[..., :N].expand(B, N)
    plq = timed("project", lambda: project_ocp_batched(
        lq, flags, U, shift=s.hessian_shift, grasp=grasp, arm_locked=solver.ocp.arm_locked))
    dX, dU, _, _ = timed(f"riccati_{riccati}", lambda: lqr_solve_batched(
        plq, x_batch - X[:, 0], backend=riccati))
    timed("linesearch_eval_per_candidate", lambda: evaluate_trajectory(
        solver.model, solver.ocp, stage, s.dt, X + dX, U + dU))
    device["step"] = device_busy(lambda: mpc.step(stage, x_batch, X, U))
    return stage_ms, device, dict(lq=lq, plq=plq, flags=flags, dX=dX, dU=dU,
                                  shift=s.hessian_shift)


def phase_main_path(dev):
    """(b) BatchedMpc (bm_k1) at full width, K1 launch count, per-stage times
    and device profile. Returns the run and the LQ data at its final
    (warm) iterate for (d) and (e)."""
    run = drive(dev, "bm_k1", "b")
    stage_ms, device, lq_data = stage_split(run)
    stage_ms["riccati"] = stage_ms.pop("riccati_k1")
    device["riccati"] = device.pop("riccati_k1")

    result = run_result(run, "bm_k1", device["step"])
    result.update(stage_ms=stage_ms, device_profile=device,
                  k1_launches=run["launches"]["K1"],
                  k1_launches_per_step=run["launches"]["K1"] / run["steps"],
                  k1_launches_by_variant=run["k1_variants"])
    log("[b] " + json.dumps(result))
    return dict(run=run, **lq_data)


def rel_err(outs, refs):
    """max over outputs of max|out - ref| / max|ref| (ref in f64), and the
    largest absolute difference."""
    rel, err = 0.0, 0.0
    for out, ref in zip(outs, refs):
        diff = (out.double() - ref).abs().max().item()
        rel = max(rel, diff / max(ref.abs().max().item(), 1e-30))
        err = max(err, diff)
    return rel, err


def sweep_cost(B, N, nx, nu):
    """(bytes, flops) of the backward sweep (K2, K3c): per node A, B, d, lx,
    lu, lxx, luu, lux read and K, kff written once, plus the terminal cost."""
    per_node = 2 * nx * nx + 2 * nx * nu + nu * nu + 2 * nx + nu + nu * nx + nu
    flops = 2.0 * (2 * nx ** 3 + nx * nx * nu + nx * nu * nu + 2 * nx * nx * nu + 2 * nx * nx
                   + nx * nu + nu * nx) + nu ** 3 / 3.0 + 2.0 * nu * nu * (nx + 1)
    return 4 * (B * N * per_node + B * (nx * nx + nx)), B * N * flops


NODE_COST = {  # (floats moved, flops) per node, nx = nu = 30, 18 joint and 12 force inputs
    "K3a": (2454 + 2724, 2.0 * (12 * 12 * 18 + 12 * 12 * 49 + 12 * (18 + 18 * 30 + 18 * 18)
                                + 30 * 30 * 18 + 30 * 18 * 18 + 30 * 30) + 12 ** 3 / 3.0),
    "K3b": (3666 + 2760, 2.0 * (30 * 30 + 18 * 30 + 30 * 30 + 18 * 18 + 2 * 18 * 30 * 30
                                + 18 * 18 * 30 + 18 * 30 * 30 + 2 * 18 * 12 * 18
                                + 2 * 18 * 18 * 18 + 18 * 30 * 30 + 18 * 18 * 30)),
    "K3d": (3666 + 60, 2.0 * (30 * 30 + 18 * 18 + 18 * 30 + 30 * 30 + 30 * 30)),
}


# the phases of K3a/K3b (csrc/lq_project.cu's -DQM_LQ_PHASE_CLOCKS) and of
# K3d (csrc/lq_forward.cu's -DQM_FWD_PHASE_CLOCKS), by kernel and build:
# the normal build ("new") and the measuring build of the kernel it replaced
# (K3a/K3b "scalar", K3d "row_warps"); K3d's are block 0's thread 0's, in
# the normal build a row of warp 0, which waits at the two named barriers
# for warps 1 and 2 ("rows_A_Px": A dx, Px_v dx; "dx_next_du": B u_red,
# P u_v), in the PR 2 kernel row 0's warp
LQ_PHASES = {
    ("K3a", "scalar"): ("load", "gram", "factor", "substitutions", "p_P_Px", "A_B_d_bar_stores"),
    ("K3a", "new"): ("load", "gram", "factor", "substitutions", "p_P_Px", "A_B_d_bar_stores"),
    ("K3b", "scalar"): ("load", "first_products", "lx_lu", "lxx", "luu", "lux"),
    ("K3b", "new"): ("load", "first_products", "second_products", "stores"),
    ("K3d", "new"): ("wait", "u", "rows_A_Px", "dx_next_du", "release"),
    ("K3d", "row_warps"): ("wait", "u", "du", "dx_next", "stores"),
}
# the int64 slots of their `clocks` argument: six phases (K3a/K3b) or five
# (K3d) at most, then block 0's node count
LQ_CLOCK_SLOTS = {"K3a": 7, "K3b": 7, "K3d": 6}
# the fm/act patterns of the projection's branches: every foot in stance,
# every foot in swing, a random mix, and a random mix with act rows switched
# off beyond the swing rows (a constraint row dropped, its Gv row zero)
PROJECTION_PATTERNS = ("stance", "swing", "mix", "act_off")


def projection_data(Bb, N, pattern, seed):
    """float64 numpy inputs of K3a (A, B, d, g0, Gx, Gv, F_bar, act, fm) and
    of K3b (lx, lu, lxx, luu, lux; K3b's p, P, Px_v come from K3a) on the
    recipe of tests/test_pallas_lq.py:_random_lq (the JAX tests' own):
    contact flags by `pattern`, act the velocity-row mask (stance (1,1,1),
    swing (0,0,1) a foot), fm the flags thrice; g0, Gx, Gv masked by act."""
    rng = np.random.default_rng(seed)
    shape = (Bb, N)
    if pattern in ("stance", "swing"):
        flags = np.full(shape + (4,), 1.0 if pattern == "stance" else 0.0)
    else:
        flags = rng.integers(0, 2, size=shape + (4,)).astype(np.float64)
    act = np.stack([flags, flags, np.ones_like(flags)], axis=-1).reshape(shape + (12,))
    if pattern == "act_off":
        act = act * rng.integers(0, 2, size=shape + (12,))
    fm = np.repeat(flags, 3, axis=-1)

    def spd(n):
        W = rng.normal(size=shape + (n, n))
        return W @ np.swapaxes(W, -1, -2) + 0.5 * np.eye(n)

    geom = [np.eye(30) + 0.05 * rng.normal(size=shape + (30, 30)),
            0.1 * rng.normal(size=shape + (30, 30)), 0.01 * rng.normal(size=shape + (30,)),
            rng.normal(size=shape + (12,)) * act,
            rng.normal(size=shape + (12, 30)) * act[..., None],
            rng.normal(size=shape + (12, 18)) * act[..., None],
            rng.normal(size=shape + (12,)), act, fm]
    cost = [rng.normal(size=shape + (30,)), rng.normal(size=shape + (30,)), spd(30), spd(30),
            0.1 * rng.normal(size=shape + (30, 30))]
    return geom, cost


def lq_call(kid, defines, args, shift=0.0, clocks=None):
    """A call that launches K3a, K3b or K3d from its source's build with
    `defines` on CUDA tensors `args` (its wrapper's inputs) into outputs
    allocated once, and returns them; the wrapper's launch counter is not
    touched. `clocks` (int64 on the card) is for the phase-clock builds."""
    import torch

    from qm_door_torch.ops import lq as tl
    from qm_door_torch.ops.cuda_build import check_launch

    dev = args[0].device
    if kid == "K3d":
        Bb, N = args[0].shape[:2]
        outs = (torch.empty(Bb, N + 1, 30, device=dev), torch.empty(Bb, N, 30, device=dev))
        fn, sizes = tl.forward_fn(defines), (Bb, N)
    else:
        geom = kid == "K3a"
        lead = (args[0] if geom else args[2]).shape[:-2]
        outs = tuple(torch.empty(*lead, *tail, device=dev)
                     for tail in (tl.GEOM_OUT if geom else tl.COST_OUT))
        fn, sizes = tl.project_fn("geom" if geom else "cost", defines), (int(np.prod(lead)),)
    head = [t.data_ptr() for t in args] + ([float(shift)] if kid == "K3b" else [])
    tail = [t.data_ptr() for t in outs] + list(sizes)
    stream = torch.cuda.current_stream(dev).cuda_stream
    clk = None if clocks is None else clocks.data_ptr()

    def call():
        check_launch(f"{kid} build {defines}", fn(*head, *tail, stream, clk))
        return outs

    return call


def phase_clocks(launch, names, slots, device, nodes=None):
    """clock64() cycles a node of each phase `names` of a phase-clock build
    in block 0's thread 0: `launch(clocks)` runs the build once with
    `clocks`, `slots` int64 on `device` that begin with a slot a phase and,
    unless `nodes` gives the nodes block 0 ran, end with the kernel's count
    of them."""
    import torch

    clocks = torch.zeros(slots, dtype=torch.int64, device=device)
    launch(clocks)
    torch.cuda.synchronize()
    counts = clocks.tolist()
    nodes = counts[-1] if nodes is None else nodes
    cycles = {name: c / nodes for name, c in zip(names, counts)}
    total = sum(cycles.values())
    return {"cycles": cycles, "total": total, "nodes_block0": nodes,
            "share": {name: c / total for name, c in cycles.items()}}


def lq_phases(kid, build, args, shift=0.0):
    """Cycles a node of each phase of K3a's, K3b's or K3d's build `build`
    (a key of LQ_BUILDS[kid]), from its phase-clock build."""
    from qm_door_torch.ops.lq import FWD_PHASE_CLOCKS, PHASE_CLOCKS

    defines = LQ_BUILDS[kid][build] + (FWD_PHASE_CLOCKS if kid == "K3d" else PHASE_CLOCKS,)
    return phase_clocks(lambda clocks: lq_call(kid, defines, args, shift, clocks)(),
                        LQ_PHASES[kid, build], LQ_CLOCK_SLOTS[kid], args[0].device)


def forward_bytes(Bb, N):
    """Bytes K3d must move for Bb scenarios of N nodes: NODE_COST's floats
    a node, and each scenario's dx0 and last dX row."""
    return 4 * (Bb * N * NODE_COST["K3d"][0] + 2 * Bb * 30)


PATH_SHIFT = 1e-5  # the solver's Hessian shift (BatchedMpc's default)


def forward_data(Bb, N, pattern, seed, device="cpu"):
    """float64 torch inputs of K3d (A_bar, B_bar, d_bar, K, kff, p, P, Px_v,
    fm, dx0) on `device`: projection_data's inputs of `pattern` through the
    plain K3a and K3b (at PATH_SHIFT), the gains of the plain K3c on them
    from a seeded SPD terminal cost, and dx0 ~ 0.1 N(0, 1), as backend
    lq_fused chains the kernels."""
    import torch

    from qm_door_torch.ops import lq as tl

    geom, cost = projection_data(Bb, N, pattern, seed)
    rng = np.random.default_rng(seed + 1)
    W = rng.normal(size=(Bb, 30, 30))
    t = lambda a: torch.tensor(a, device=device)  # noqa: E731
    g = [t(a) for a in geom]
    A_bar, B_bar, d_bar, p, P, Px_v = tl.project_geom_plain(*g)
    projected = tl.project_cost_plain(*[t(a) for a in cost], p, P, Px_v, g[-1], shift=PATH_SHIFT)
    K, kff = tl.riccati_backward_ll_plain(
        A_bar, B_bar, d_bar, *projected, t(W @ np.swapaxes(W, -1, -2) + 0.5 * np.eye(30)),
        t(rng.normal(size=(Bb, 30))))
    return [A_bar, B_bar, d_bar, K, kff, p, P, Px_v, g[-1], t(0.1 * rng.normal(size=(Bb, 30)))]


def forward_blocks_per_sm(defines):
    """Blocks an SM of K3d's lq_forward build with `defines` on the current
    device, as cudaOccupancyMaxActiveBlocksPerMultiprocessor counts them."""
    import ctypes

    from qm_door_torch.ops import lq as tl
    from qm_door_torch.ops.cuda_build import check_launch

    blocks = ctypes.c_int(0)
    check_launch("K3d occupancy query", tl.c_entry(
        "lq_forward", "qm_lq_forward_blocks_per_sm", defines)(ctypes.byref(blocks)))
    return blocks.value


SWEEP_PHASES = ("load", "SA_SB_Sd", "Q_terms", "cholesky", "substitutions", "S_update")


def sweep_phases(args, symmetrize, variant):
    """clock64() cycles a node of each phase of a sweep variant (K2 or K3c)
    in block 0's thread 0 (on the reg variant, the factoring warp), from its
    diagnostic build, on the sweep's inputs ``args``."""
    import torch

    from qm_door_torch.ops import riccati_fused as rf
    from qm_door_torch.ops.cuda_build import check_launch

    A, B = args[0], args[1]
    Bb, N, nx, nu = B.shape
    K = torch.empty(Bb, N, nu, nx, device=A.device)
    kff = torch.empty(Bb, N, nu, device=A.device)

    def launch(clocks):
        check_launch("sweep phase clocks", rf.kernel_fn(variant, (rf.PHASE_CLOCKS,))(
            *(t.data_ptr() for t in args), K.data_ptr(), kff.data_ptr(), Bb, N, nx, nu, 0.0,
            int(symmetrize), torch.cuda.current_stream(A.device).cuda_stream, clocks.data_ptr()))

    return phase_clocks(launch, SWEEP_PHASES, len(SWEEP_PHASES), A.device, nodes=N)


# (Bb, N, nx, nu) off the path, each with and without a shift: the small
# parity shape, one node, the reg variant with a second solving warp
# (nx + 1 = 37 columns), and reg2 at nu = 36, with a second solving warp
# (36 / 36) and at its narrowest, nu = 33
SWEEP_SHAPES = ((5, 9, 7, 4), (3, 1, 30, 30), (7, 11, 36, 32), (2, 5, 30, 36), (3, 4, 36, 36),
                (2, 5, 30, 33))
SWEEP_SHIFT = 1e-3


def sweep_data(shape):
    """float64 sweep inputs on the recipe of
    tests/test_torch_riccati_fused.py:_random_plq (the JAX tests' own):
    A near I, SPD lxx, luu, lxx_f, seeded by the shape."""
    Bb, N, nx, nu = shape
    rng = np.random.default_rng(sum(shape))

    def spd(*s):
        M = rng.normal(size=s + (s[-1],)) * 0.3
        return M @ np.swapaxes(M, -1, -2) + 2.0 * np.eye(s[-1])

    A = rng.normal(size=(Bb, N, nx, nx)) * 0.2 + np.eye(nx)
    B = rng.normal(size=(Bb, N, nx, nu)) * 0.3
    d = rng.normal(size=(Bb, N, nx)) * 0.1
    lx = rng.normal(size=(Bb, N, nx))
    lu = rng.normal(size=(Bb, N, nu))
    lxx, luu = spd(Bb, N, nx), spd(Bb, N, nu)
    lux = rng.normal(size=(Bb, N, nu, nx)) * 0.2
    lxx_f, lx_f = spd(Bb, nx), rng.normal(size=(Bb, nx))
    return [A, B, d, lx, lu, lxx, luu, lux, lxx_f, lx_f]


def sweep_call(kid, args, shift=0.0, variant=None):
    """One launch of K2 or K3c on CUDA tensors ``args``: through its wrapper,
    or, with ``variant`` forced or a shift for K3c (whose wrapper takes none,
    as the TPU kernel), through the launch both wrappers share, counted on
    the wrapper's."""
    from qm_door_torch.ops import riccati_fused as rf

    wrapper = sweep_wrappers()[kid]
    if variant is None and (kid == "K2" or shift == 0.0):
        return wrapper(*args, shift=shift) if kid == "K2" else wrapper(*args)
    return rf.launch_sweep(wrapper, args, shift, symmetrize=kid == "K2", variant=variant)


def sweep_wrappers():
    return {kid: launch_counters()[kid] for kid in ("K2", "K3c")}


def sweep_run(kid, args, ref, label, shift=0.0, variant=None):
    """One sweep call on the card: fails unless it ran the variant
    sweep_variant names (or `variant`) once and is within SWEEP_REL_TOL of
    the f64 reference ``ref`` (K, kff). Returns the outputs, the relative
    error and the variant."""
    import torch

    from qm_door_torch.ops.riccati_fused import sweep_variant

    wrapper = sweep_wrappers()[kid]
    want = variant or sweep_variant(*args[1].shape[2:])
    before = dict(wrapper.launches_by_variant)
    outs = sweep_call(kid, args, shift, variant)
    torch.cuda.synchronize()
    ran = {v: cnt - before[v] for v, cnt in wrapper.launches_by_variant.items()
           if cnt != before[v]}
    rel, _ = rel_err(outs, ref)
    if ran != {want: 1}:
        raise RuntimeError(f"{kid} {label}: launched {ran}, expected one {want}")
    if not (rel <= SWEEP_REL_TOL and np.isfinite(rel)):
        raise RuntimeError(f"{kid} {label} ({want}): relative error {rel:.3e} > {SWEEP_REL_TOL}")
    return outs, rel, want


def check_sweep_at_shapes(dev):
    """(d) K2 and K3c off the path's shape: each of SWEEP_SHAPES with and
    without a shift, against sweep_plain in f64, through the variant
    sweep_variant names."""
    import torch

    from qm_door_torch.ops.riccati_fused import sweep_plain

    ran = {}
    for shape in SWEEP_SHAPES:
        data = sweep_data(shape)
        args = [torch.tensor(t, dtype=torch.float32, device=dev) for t in data]
        f64 = [torch.tensor(t, device=dev) for t in data]
        for shift in (0.0, SWEEP_SHIFT):
            for kid, symmetrize in (("K2", True), ("K3c", False)):
                ref = sweep_plain(*f64, shift, symmetrize)
                label = f"{'x'.join(map(str, shape))} shift {shift}"
                _, rel, variant = sweep_run(kid, args, ref, label, shift)
                ran[f"{kid} {label}"] = [variant, rel]
    log(f"[d] sweep shapes (variant, relative error): ok {json.dumps(ran)}")


def kernel_row(kid, name, fn, plain, args, refs_f64, tol, nbytes, flops, reps=20, tag="d",
               **extra):
    """Hold one kernel against its plain version in f64 on the same inputs,
    time kernel and plain f32 version, and compute its bound."""
    import torch

    outs = fn(*args)
    outs_plain = plain(*args)
    torch.cuda.synchronize()
    rel, err = rel_err(outs, refs_f64)
    rel_plain, _ = rel_err(outs_plain, refs_f64)
    if not (rel <= tol and np.isfinite(rel)):
        raise RuntimeError(f"{kid} {name}: relative error {rel:.3e} > {tol} "
                           f"(plain f32: {rel_plain:.3e})")
    ms = cuda_ms(lambda: fn(*args), reps=reps)
    plain_ms = cuda_ms(lambda: plain(*args), reps=2, warmup=1)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOPS_PER_S * 1e3
    row = dict(id=kid, name=name, rel_err=rel, rel_err_plain_f32=rel_plain, bar=tol,
               max_abs_err=err, ms=ms, plain_ms=plain_ms, bytes=nbytes, flops=flops,
               bytes_ms=t_bytes, ops_ms=t_ops, bound_ms=max(t_bytes, t_ops),
               bound_by="bytes" if t_bytes >= t_ops else "operations", **extra)
    log(f"[{tag}] " + json.dumps(row))
    return row, outs


def sweep_turns(row, args, ref, symmetrize, reps=20, tag="d"):
    """The path's sweep variant and the block-parallel kernel (smem, only
    ever forced) on the same inputs: smem held against the f64 reference,
    then the two timed in turns (smem, path, path, smem) in chained calls;
    `ms` becomes the path variant's mean, `ms_smem` smem's; the phase
    clocks of both."""
    from qm_door_torch.ops.riccati_fused import sweep_variant

    kid = row["id"]
    path = sweep_variant(*args[1].shape[2:])
    _, row["rel_err_smem"], _ = sweep_run(kid, args, ref, "path data", variant="smem")
    calls = {v: (lambda v=v: sweep_call(kid, args, variant=v)) for v in ("smem", path)}
    turns, means = in_turns(calls, ("smem", path, path, "smem"), chained(reps))
    row.update(variant=path, ms=means[path], ms_turns=turns, ms_smem=means["smem"],
               phase_cycles_per_node={v: sweep_phases(args, symmetrize, v)
                                      for v in (path, "smem")},
               phase_clock_build_spills=SWEEP_CLOCK_SPILLS)
    log(f"[{tag}] {kid} in turns: " + json.dumps({k: row[k] for k in (
        "variant", "ms", "ms_smem", "ms_turns", "rel_err_smem", "phase_cycles_per_node",
        "phase_clock_build_spills")}))


def lq_turns(row, args, shift=0.0, reps=50):
    """K3a, K3b or K3d (row["id"]) against the measuring build of the kernel
    it replaced (LQ_BUILDS) on the same inputs, both launched straight
    through the C entry point into outputs allocated once (the measuring
    build has no wrapper), timed in turns (measuring, new, new, measuring)
    in chained calls: `ms_turns` holds each turn, `ms_<build>_turns` each
    build's mean. `ms` stays kernel_row's time through the wrapper. Both
    builds' phase clocks a node; for K3d also their registers and blocks
    an SM."""
    kid = row["id"]
    builds = LQ_BUILDS[kid]
    old = next(b for b in builds if b != "new")
    calls = {b: lq_call(kid, d, args, shift) for b, d in builds.items()}
    row["ms_turns"], means = in_turns(calls, (old, "new", "new", old), chained(reps))
    row.update({f"ms_{b}_turns": ms for b, ms in means.items()},
               phase_cycles_per_node={b: lq_phases(kid, b, args, shift) for b in builds},
               phase_clock_build_spills=FORWARD_CLOCK_SPILLS if kid == "K3d" else LQ_CLOCK_SPILLS)
    if kid == "K3d":
        row.update(registers={b: {k: v["registers"] for k, v in FORWARD_PTXAS[b].items()}
                              for b in builds},
                   blocks_per_sm={b: forward_blocks_per_sm(d) for b, d in builds.items()})
    log(f"[d] {kid} in turns: " + json.dumps({k: row[k] for k in lq_turn_keys(kid)}))


def lq_turn_keys(kid):
    """The keys lq_turns adds to K3a's, K3b's or K3d's row."""
    return (tuple(f"ms_{b}_turns" for b in LQ_BUILDS[kid]) + ("ms_turns", "phase_cycles_per_node")
            + (("registers", "blocks_per_sm") if kid == "K3d" else ())
            + ("phase_clock_build_spills",))


# (Bb, N, inputs one float past an aligned base) of the seeded K3d checks, each
# on every pattern: 7 x 67, one node, one scenario, one block past a wave of
# 3 blocks on 132 SMs, and the 4-byte copies that stand in for the bulk
# copies on misaligned inputs
FORWARD_CASES = ((7, 67, False), (3, 1, False), (1, 67, False), (397, 67, False),
                 (5, 9, True))


def misaligned(t):
    """A copy of CUDA tensor `t` whose base lies one element past an aligned one."""
    import torch

    flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = flat[1:].view(t.shape)
    out.copy_(t)
    return out


def wrapper_case(label, wrapper, args, ref, tol, off, **kw):
    """One call of the counted wrapper `wrapper` on the float64 tensors
    `args` cast to f32 (each moved one float past an aligned base if
    `off`): fails unless it launched its kernel once and is within `tol` of
    the f64 reference `ref`. Returns the relative error."""
    import torch

    f32 = [t.float().contiguous() for t in args]
    before = wrapper.launches
    outs = wrapper(*[misaligned(t) for t in f32] if off else f32, **kw)
    torch.cuda.synchronize()
    rel, _ = rel_err(outs, ref)
    if wrapper.launches != before + 1:
        raise RuntimeError(f"{label}: the wrapper did not launch its kernel")
    if not (rel <= tol and np.isfinite(rel)):
        raise RuntimeError(f"{label}: relative error {rel:.3e} > {tol}")
    return rel


def check_forward_cases(dev):
    """(d) K3d through its wrapper on seeded inputs of every fm/act pattern
    (PROJECTION_PATTERNS) in each of FORWARD_CASES, each within SWEEP_REL_TOL
    of the f64 plain version."""
    from qm_door_torch.ops import lq as tl

    checks = {}
    for i, pattern in enumerate(PROJECTION_PATTERNS):
        for Bb, N, off in FORWARD_CASES:
            args = forward_data(Bb, N, pattern, 2000 + 10 * i + Bb, dev)
            label = f"K3d {pattern} {Bb}x{N}{' misaligned' if off else ''}"
            checks[label] = wrapper_case(label, tl.riccati_forward_ll, args,
                                         tl.riccati_forward_ll_plain(*args), SWEEP_REL_TOL, off)
    log(f"[d] K3d on every fm pattern and edge case (relative error): ok {json.dumps(checks)}")


# (Bb, N, inputs one float past an aligned base) of the seeded projection
# checks: a random mix of every pattern at 7 x 67 nodes, one node, and the
# 4-byte copies that stand in for the bulk copies on misaligned inputs
PROJECTION_CASES = ((7, 67, False), (1, 1, False), (3, 5, True))
# K3b's second shift in those checks: at the path's shift (~1e-5) a kernel
# that dropped or doubled the shift on either diagonal block would stay
# within PROJECTION_REL_TOL; at 1.0 it misses it by orders of magnitude
UNIT_SHIFT = 1.0


def check_projection_patterns(dev, shift):
    """(d) K3a and K3b through their wrappers on seeded inputs of every
    fm/act pattern (PROJECTION_PATTERNS) in each of PROJECTION_CASES, each
    within PROJECTION_REL_TOL of the f64 plain version; K3b at `shift` and
    again at UNIT_SHIFT."""
    import torch

    from qm_door_torch.ops import lq as tl

    checks = {}
    for i, pattern in enumerate(PROJECTION_PATTERNS):
        for Bb, N, off in PROJECTION_CASES:
            geom, cost = projection_data(Bb, N, pattern, 1000 + 10 * i + Bb)
            g64 = [torch.tensor(t, device=dev) for t in geom]
            ref_geom = tl.project_geom_plain(*g64)
            c64 = [torch.tensor(t, device=dev) for t in cost] + list(ref_geom[3:]) + [g64[-1]]
            cases = [("K3a", tl.project_geom, g64, ref_geom, {})]
            cases += [("K3b", tl.project_cost, c64, tl.project_cost_plain(*c64, shift=s),
                       {"shift": s}) for s in (shift, UNIT_SHIFT)]
            for kid, wrapper, args, ref, kw in cases:
                label = f"{kid} {pattern} {Bb}x{N}{' misaligned' if off else ''}"
                if kw.get("shift") == UNIT_SHIFT:
                    label += f" shift {UNIT_SHIFT}"
                checks[label] = wrapper_case(label, wrapper, args, ref, PROJECTION_REL_TOL,
                                             off, **kw)
    log(f"[d] K3a/K3b on every fm/act pattern (relative error): ok {json.dumps(checks)}")


def phase_new_kernels(dev, main):
    """(d) K2, K3a-d on (b)'s warm-iterate data and K1-ll, each against its
    plain version in f64; timed beside its bound; the refusals."""
    import torch

    from qm_door_torch.ocp import constraints as cons
    from qm_door_torch.ops import lq as tl
    from qm_door_torch.ops import riccati_fused as rf
    from qm_door_torch.ops.spd_solve import k1_variant, spd_solve_ll, spd_solve_plain

    c = lambda t: t.contiguous()  # noqa: E731
    f64 = lambda ts: [t.double() for t in ts]  # noqa: E731
    lq, plq, flags, shift = main["lq"], main["plq"], main["flags"], main["shift"]
    X, U, x_batch = (main["run"][k] for k in ("X", "U", "x_batch"))
    B, N = U.shape[:2]
    rows = {}

    # K2 on the K1 projection's output, as backend bm_fused feeds it
    k2_args = [c(t) for t in (plq.A, plq.B, plq.d, plq.lx, plq.lu, plq.lxx, plq.luu, plq.lux,
                              plq.lxx_f, plq.lx_f)]
    nbytes, flops = sweep_cost(B, N, 30, 30)
    ref = rf.riccati_backward_fused_plain(*f64(k2_args))
    rows["K2"], _ = kernel_row(
        "K2", "riccati_backward_fused", rf.riccati_backward_fused,
        rf.riccati_backward_fused_plain, k2_args, ref, SWEEP_REL_TOL, nbytes, flops)
    sweep_turns(rows["K2"], k2_args, ref, True)

    # K3a -> K3b -> K3c -> K3d on the linearization, as backend lq_fused
    # chains them (each fed the previous kernel's outputs)
    act = c(cons.velocity_row_mask(flags))
    fm = c(torch.repeat_interleave(flags, 3, dim=-1))
    geom_args = [c(t) for t in (lq.A, lq.B, lq.d, lq.g0, lq.Gx, lq.Gv)] + [c(U[:, :, :12]), act, fm]
    floats, fl = NODE_COST["K3a"]
    rows["K3a"], (A_bar, B_bar, d_bar, p, P, Px_v) = kernel_row(
        "K3a", "project_geom", tl.project_geom, tl.project_geom_plain, geom_args,
        tl.project_geom_plain(*f64(geom_args)), PROJECTION_REL_TOL, 4 * B * N * floats,
        B * N * fl, reps=50)
    cost_args = [c(t) for t in (lq.lx, lq.lu, lq.lxx, lq.luu, lq.lux)] + [p, P, Px_v, fm]
    floats, fl = NODE_COST["K3b"]
    shifted = lambda fn: lambda *a: fn(*a, shift=shift)  # noqa: E731
    rows["K3b"], (lxb, lub, lxxb, luub, luxb) = kernel_row(
        "K3b", "project_cost", shifted(tl.project_cost), shifted(tl.project_cost_plain),
        cost_args, tl.project_cost_plain(*f64(cost_args), shift=shift), PROJECTION_REL_TOL,
        4 * B * N * floats, B * N * fl, reps=50)
    lq_turns(rows["K3a"], geom_args, shift)
    lq_turns(rows["K3b"], cost_args, shift)
    check_projection_patterns(dev, shift)
    bwd_args = [A_bar, B_bar, d_bar, lxb, lub, lxxb, luub, luxb, c(lq.lxx_f), c(lq.lx_f)]
    ref = tl.riccati_backward_ll_plain(*f64(bwd_args))
    rows["K3c"], (K, kff) = kernel_row(
        "K3c", "riccati_backward_ll", tl.riccati_backward_ll, tl.riccati_backward_ll_plain,
        bwd_args, ref, SWEEP_REL_TOL, nbytes, flops)
    sweep_turns(rows["K3c"], bwd_args, ref, False)
    check_sweep_at_shapes(dev)
    fwd_args = [A_bar, B_bar, d_bar, K, kff, p, P, Px_v, fm, c(x_batch - X[:, 0])]
    rows["K3d"], _ = kernel_row(
        "K3d", "riccati_forward_ll", tl.riccati_forward_ll, tl.riccati_forward_ll_plain,
        fwd_args, tl.riccati_forward_ll_plain(*f64(fwd_args)), SWEEP_REL_TOL,
        forward_bytes(B, N), B * N * NODE_COST["K3d"][1], reps=50)
    lq_turns(rows["K3d"], fwd_args)
    check_forward_cases(dev)

    # K1-ll: lanes-last SPD solves at the gain shape, then ragged batches;
    # each through the variant K1's dispatch names (reg32, reg16, reg64 by
    # columns and by rows, blk128)
    rng = np.random.default_rng(1)
    ll_variants = {}
    for batch, n, m, s_ll in ((BATCH, 30, 31, 0.0), (1001, 12, 49, 1e-3), (7, 64, 3, 0.0),
                              (50, 36, 1, 1e-3), (9, 92, 1, 0.0)):
        before = dict(spd_solve_ll.launches_by_variant)
        A64, Y64 = spd_batch(rng, batch, n, m)
        At = torch.tensor(A64, dtype=torch.float32, device=dev).permute(1, 2, 0).contiguous()
        Yt = torch.tensor(Y64, dtype=torch.float32, device=dev).permute(1, 2, 0).contiguous()
        ref = spd_solve_plain(torch.tensor(A64, device=dev), torch.tensor(Y64, device=dev),
                              s_ll).permute(1, 2, 0)
        if batch == BATCH:
            rows["K1-ll"], _ = kernel_row(
                "K1-ll", "spd_solve_ll", lambda At, Yt: (spd_solve_ll(At, Yt),),
                lambda At, Yt: (spd_solve_plain(At.permute(2, 0, 1), Yt.permute(2, 0, 1))
                                .permute(1, 2, 0),),
                [At, Yt], [ref], K1_REL_TOL, 4 * batch * (n * (n + 1) // 2 + 2 * n * m),
                batch * (n ** 3 / 3.0 + 2.0 * n * n * m), reps=50)
            # the library's call for the same function: Cholesky and
            # cholesky_solve on the batch-first view of the lanes-last data
            Ab, Yb = At.permute(2, 0, 1), Yt.permute(2, 0, 1)
            rows["K1-ll"]["library_ms"] = cuda_ms(
                lambda: torch.cholesky_solve(Yb, torch.linalg.cholesky(Ab)), reps=20)
            log(f"[d] K1-ll library (torch.cholesky_solve on the permuted view): "
                f"{rows['K1-ll']['library_ms']:.5f} ms")
        else:
            rel, _ = rel_err([spd_solve_ll(At, Yt, s_ll)], [ref])
            if not rel <= K1_REL_TOL:
                raise RuntimeError(f"K1-ll ({n},{m},{batch}) shift {s_ll}: relative error "
                                   f"{rel:.3e}")
        ran = {v for v, cnt in spd_solve_ll.launches_by_variant.items() if cnt != before[v]}
        if ran != {k1_variant(n, m)}:
            raise RuntimeError(f"K1-ll ({n},{m},{batch}) ran {ran}, not {k1_variant(n, m)}")
        ll_variants[f"{n}x{m}x{batch}"] = k1_variant(n, m)
    log(f"[d] K1-ll ragged batches (1001 x 12 x 49 and 50 x 36 x 1 with a shift, 7 x 64 x 3, "
        f"9 x 92 x 1): ok; variants "
        f"{json.dumps(ll_variants)}")

    # every new wrapper refuses float64 and a non-contiguous input on the card
    # (the same shape with its last two axes' strides swapped)
    strided = lambda t: t.transpose(-1, -2).contiguous().transpose(-1, -2)  # noqa: E731
    refusals = {
        "spd_solve_ll": (spd_solve_ll, [At, Yt]),
        "riccati_backward_fused": (rf.riccati_backward_fused, k2_args),
        "project_geom": (tl.project_geom, geom_args),
        "project_cost": (tl.project_cost, cost_args),
        "riccati_backward_ll": (tl.riccati_backward_ll, bwd_args),
        "riccati_forward_ll": (tl.riccati_forward_ll, fwd_args),
    }
    for name, (fn, args) in refusals.items():
        before = fn.launches
        for error, bad in ((TypeError, [a.double() for a in args]),
                           (ValueError, [strided(args[0])] + list(args[1:]))):
            try:
                fn(*bad)
            except error:
                continue
            raise RuntimeError(f"{name} took {'float64' if error is TypeError else 'a '
                               'non-contiguous input'} instead of raising {error.__name__}")
        if fn.launches != before:
            raise RuntimeError(f"{name} counted a launch it refused")
    log(f"[d] refusals (float64, non-contiguous): ok for {', '.join(refusals)}")
    return rows


def phase_backends(dev, main, refs):
    """(e) BatchedMpc on bm_fused and lq_fused, driven as (b) drives bm_k1;
    their LQ stage at (b)'s iterate against bm_k1's step there."""
    import torch

    from qm_door_torch.ocp import constraints as cons
    from qm_door_torch.ops.lq import solve_lq_batched
    from qm_door_torch.solver.riccati import lqr_solve_batched
    from qm_door_torch.solver.transcription import project_ocp_batched

    lq, plq, flags, shift = main["lq"], main["plq"], main["flags"], main["shift"]
    X, U, x_batch = (main["run"][k] for k in ("X", "U", "x_batch"))
    dx0 = x_batch - X[:, 0]
    stages = {
        "bm_fused": {
            "project": lambda: project_ocp_batched(lq, flags, U, shift=shift),
            "riccati_fused": lambda: lqr_solve_batched(plq, dx0, backend="fused")[:2]},
        "lq_fused": {
            "lq_stage": lambda: solve_lq_batched(
                lq, cons.velocity_row_mask(flags), torch.repeat_interleave(flags, 3, dim=-1),
                U[:, :, :12], dx0, shift=shift)},
    }
    launches, by_variant, runs = {}, {}, {}
    for backend, fns in stages.items():
        run = runs[backend] = drive(dev, backend, "e")
        stage_ms, device = {}, {}
        timed = timer(stage_ms, device)
        for name, fn in fns.items():
            out = timed(name, fn)
        dX, dU = out
        mpc, stage = run["mpc"], run["stage"]
        device["step"] = device_busy(lambda: mpc.step(stage, x_batch, X, U))
        result = run_result(run, backend, device["step"])
        result.update(stage_ms=stage_ms, device_profile=device,
                      k1_launches_by_variant=run["k1_variants"],
                      dX_vs_bm_k1=(dX - main["dX"]).abs().max().item(),
                      dU_vs_bm_k1=(dU - main["dU"]).abs().max().item())
        log("[e] " + json.dumps(result))
        phase_cross_precision(dev, refs, backend, "e")
        launches.update({k: v for k, v in run["launches"].items() if v})
        by_variant.update({kid: counts for kid, counts in run["sweep_variants"].items()
                           if run["launches"][kid]})
    return launches, by_variant, runs


PAIR_ORDER = ("bm_k1", "bm_fused", "lq_fused", "lq_fused", "bm_fused", "bm_k1")
PAIR_STEPS = 2  # short, so that the whole script fits its 1,200 s limit


def phase_pairs(runs):
    """(f) the three backends' steps in mirrored pairs (PAIR_ORDER), on the
    problems (b) and (e) built: each turn PAIR_STEPS steps from its
    backend's final iterate there, host clock around work that ends in
    torch.cuda.synchronize()."""
    import torch

    step_ms = {backend: [] for backend in runs}
    for backend in PAIR_ORDER:
        run = runs[backend]
        mpc, stage, x_batch, X, U = (run[k] for k in ("mpc", "stage", "x_batch", "X", "U"))
        torch.cuda.synchronize()
        t0 = time.time()
        for _ in range(PAIR_STEPS):
            X, U, _ = mpc.step(stage, x_batch, X, U)
        torch.cuda.synchronize()
        step_ms[backend].append((time.time() - t0) / PAIR_STEPS * 1e3)
    mean = {backend: float(np.mean(t)) for backend, t in step_ms.items()}
    row = {"order": PAIR_ORDER, "steps_a_turn": PAIR_STEPS, "step_ms": step_ms,
           "step_ms_mean": mean,
           "solves_per_s_mean": {backend: BATCH * 1e3 / t for backend, t in mean.items()}}
    log("[f] " + json.dumps(row))


def cross_steps(device, dtype, backend, problem):
    """3 steps at B = 4 from the cold start of make_problem's problem with
    the options `problem` (lin_tangents "analytic" unless it names one):
    (X, U, stats) in f64 on the CPU."""
    mpc, stage, x_batch, X, U = make_problem(device, dtype, 4, backend=backend,
                                             **dict(dict(lin_tangents="analytic"), **problem))
    for _ in range(3):
        X, U, stats = mpc.step(stage, x_batch, X, U)
    return X.double().cpu(), U.double().cpu(), [t.double().cpu() for t in stats]


def phase_cross_precision(dev, refs, backend="bm_k1", tag="c", **problem):
    """(c) 3 steps at B = 4, GPU f32 against CPU f64, on the 30-input
    problem or on make_problem's problem with the options `problem` (the
    force-tracking one: max|dU| over all 36 inputs). The CPU f64 run takes
    bm_k1's path (the plain solves), once a problem, and serves every
    backend's check: in f64 the backends agree to 1e-8
    (tests/test_torch_batched_sqp.py). `refs` keeps the CPU runs made, by
    problem."""
    import torch

    key = tuple(sorted(problem.items()))
    gpu_f32 = cross_steps(dev, torch.float32, backend, problem)
    if key not in refs:
        refs[key] = cross_steps(torch.device("cpu"), torch.float64, "bm_k1", problem)
    if hasattr(refs[key], "result"):  # computed beside the card's runs (cross_reference)
        refs[key] = refs[key].result()
    out = {"gpu_f32": gpu_f32, "cpu_f64": refs[key]}
    dX = (out["gpu_f32"][0] - out["cpu_f64"][0]).abs().max().item()
    dU = (out["gpu_f32"][1] - out["cpu_f64"][1]).abs().max().item()
    dF = (out["gpu_f32"][1][..., :12] - out["cpu_f64"][1][..., :12]).abs().max().item()
    row = {"backend": backend, "problem": problem, "nu": int(out["cpu_f64"][1].shape[-1]),
           "X_err_max": dX, "U_err_max": dU, "force_err_max_N": dF,
           "cost": {k: v[2][0].tolist() for k, v in out.items()},
           "violation": {k: v[2][1].tolist() for k, v in out.items()},
           "alpha": {k: v[2][2].tolist() for k, v in out.items()}}
    log(f"[{tag}] " + json.dumps(row))
    if not (dX <= CROSS_DX_MAX and dU <= CROSS_DU_MAX):
        raise RuntimeError(f"cross precision ({backend}, {problem}): max|dX| {dX:.3e} "
                           f"(<= {CROSS_DX_MAX}), max|dU| {dU:.3e} (<= {CROSS_DU_MAX})")
    return row


def cross_reference(problem):
    """cross_steps' CPU f64 run of a problem in a spawned process of
    phase_force_tracking's, two torch threads."""
    import torch

    torch.set_num_threads(2)
    return cross_steps(torch.device("cpu"), torch.float64, "bm_k1", problem)


# launches a step of the force-tracking problem (nu = 36): the gain solves
# go to K1's reg64 variant (n = 36 > 32), the sweep to K2's reg2 variant
FT_EXPECT = {
    "bm_k1": ({"K1": 68}, {"reg16": 1, "reg64": 67}, {}),
    "bm_fused": ({"K1": 1, "K2": 1}, {"reg16": 1}, {"K2": {"reg2": 1}}),
}
# reg2's blocks an SM at 30/36: 3 keep the 384 scenarios in one wave on 132 SMs
FT_SWEEP_BLOCKS = 3
OPTION_WARM_STEPS = 2
# (g) the other options on bm_k1: make_problem's keyword arguments and the
# check. The tangent families change only the Newton direction (bf16 rounds
# it on purpose), so a step-by-step comparison with f64 would measure that
# rounding: they are held to (b)'s violation bar after (b)'s warm steps. The
# others change the problem: (c)'s cross-precision bars after 3 steps.
OPTIONS = {
    "lin_tangents_f32": (dict(lin_tangents="f32"), "violation"),
    "lin_tangents_bf16": (dict(lin_tangents="bf16"), "violation"),
    "sensitivity_rk2": (dict(sensitivity="rk2"), "cross"),
    "arm_locked": (dict(quad_only=True), "cross"),
    "shared_stage_false": (dict(shared_stage=False), "cross"),
}


def phase_force_tracking(dev, refs):
    """(g) force tracking at full width: bm_k1 and bm_fused driven as (b)
    drives bm_k1, the off-grasp wrench exactly 0, per-stage host ms and the
    card's idle share, (c)'s cross-precision check for each; K1's reg64
    variant at the gain shape and K2's reg2 variant on (g)'s warm iterate;
    the other options; one SqpSolver.solve cold and warm. The cross checks'
    CPU f64 runs (the force-tracking problem and the options checked on
    it) are computed meanwhile in two spawned processes (cross_reference),
    so the host times of (g) carry their load. Returns the two runs and the
    two kernel rows."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    with ProcessPoolExecutor(2, mp_context=multiprocessing.get_context("spawn")) as pool:
        for problem in [dict(force_tracking=True)] + [
                kw for kw, check in OPTIONS.values() if check == "cross"]:
            key = tuple(sorted(problem.items()))
            if key not in refs:
                refs[key] = pool.submit(cross_reference, problem)
        return force_tracking_runs(dev, refs)


def force_tracking_runs(dev, refs):
    """phase_force_tracking's work on the card."""
    import torch

    runs, rows, seconds, t0 = {}, {}, {}, time.time()
    for backend in ("bm_k1", "bm_fused"):
        problem = make_problem(dev, torch.float32, BATCH, "analytic_bf16", backend,
                               force_tracking=True)
        run = runs[backend] = drive(dev, backend, "g", problem=problem,
                                    expect=FT_EXPECT[backend])
        stage, U = run["stage"], run["U"]
        N = U.shape[1]
        off = stage.grasp_flags[:N] < 0.5
        wrench_off = U[:, off, 30:36].abs().max().item()
        if not (off.any() and (~off).any() and wrench_off == 0.0):
            raise RuntimeError(f"force tracking {backend}: off-grasp wrench max {wrench_off} "
                               "(must be exactly 0)")
        seconds[f"drive_{backend}"], t0 = time.time() - t0, time.time()
        stage_ms, device, run["lq_data"] = stage_split(
            run, "fused" if backend == "bm_fused" else "k1")
        result = run_result(run, backend, device["step"])
        result.update(problem="force_tracking", nu=36, stage_ms=stage_ms,
                      device_profile=device, launches_by_variant={
                          "K1": run["k1_variants"], **{k: v for k, v in
                                                       run["sweep_variants"].items() if any(
                                                           v.values())}},
                      off_grasp_wrench_max=wrench_off,
                      on_grasp_wrench_mean=U[:, ~off, 30:36].mean(dim=(0, 1)).tolist())
        log("[g] " + json.dumps(result))
        phase_cross_precision(dev, refs, backend, "g", force_tracking=True)
        seconds[f"split_cross_{backend}"], t0 = time.time() - t0, time.time()
    rows["K1_gain"] = ft_gain_kernel(runs["bm_k1"])
    rows["K2_nu36"] = ft_sweep_kernel(runs["bm_fused"])
    seconds["kernels"], t0 = time.time() - t0, time.time()
    phase_options(dev, refs)
    seconds["options"], t0 = time.time() - t0, time.time()
    phase_single_solve(dev)
    seconds["single_solve"] = time.time() - t0
    log("[g] seconds: " + json.dumps({k: round(v, 1) for k, v in seconds.items()}))
    return runs, rows


def ft_gain_kernel(run):
    """K1's reg64 variant at the force-tracking gain shape (384 x 36 x 31:
    Quu 36 x 36, the right-hand sides [Qux, Qu], nx + 1 columns),
    on node 0's gain system of the sweep at (g)'s bm_k1 warm iterate: held
    against the f64 plain solve, timed in chained calls and in a CUDA graph
    beside its bound, its plain version and torch.linalg, and in turns
    (smem, reg64, reg64, smem) in a CUDA graph against PR 1's kernel."""
    import torch

    from qm_door_torch.ops.spd_solve import k1_variant, spd_solve, spd_solve_plain
    from qm_door_torch.solver import riccati

    plq = run["lq_data"]["plq"]
    with k1_calls(riccati) as calls:
        riccati.lqr_solve_batched(plq, run["x_batch"] - run["X"][:, 0])
    A, Y = calls[-1][:2]
    batch, n, m = Y.shape
    if (batch, n, m) != (BATCH, 36, 31) or k1_variant(n, m) != "reg64":
        raise RuntimeError(f"K1 at the nu = 36 gain: shape {(batch, n, m)}, variant "
                           f"{k1_variant(n, m)}")
    ref = spd_solve_plain(A.double(), Y.double())
    nbytes = 4 * batch * (n * (n + 1) // 2 + 2 * n * m)
    flops = batch * (n ** 3 / 3.0 + 2.0 * n * n * m)
    row, _ = kernel_row("K1", "spd_solve reg64, nu = 36 gain", lambda A, Y: (spd_solve(A, Y),),
                        lambda A, Y: (spd_solve_plain(A, Y),), [A, Y], [ref], K1_REL_TOL,
                        nbytes, flops, reps=50, tag="g", variant="reg64",
                        calls_per_step=len(calls))
    calls = {v: (lambda v=v: spd_solve(A, Y, _variant=v)) for v in ("smem", "reg64")}
    row["ms_graph_turns"], graph = in_turns(calls, ("smem", "reg64", "reg64", "smem"), graph_ms)
    row.update(ms_graph=graph["reg64"], ms_smem_graph=graph["smem"])
    row["library_ms"] = cuda_ms(lambda: torch.cholesky_solve(Y, torch.linalg.cholesky(A)),
                                reps=20)
    row["launches"] = run["k1_variants"]["reg64"]
    log("[g] K1 reg64 at the nu = 36 gain: " + json.dumps(
        {k: row[k] for k in ("ms", "ms_graph", "ms_smem_graph", "plain_ms", "library_ms",
                             "bound_ms", "launches")}))
    return row


def ft_sweep_kernel(run):
    """K2 at 384 x 67, nx 30, nu 36 on (g)'s bm_fused warm iterate: the
    variant the path runs (reg2) held against its f64 plain version and
    timed beside its bound; its blocks an SM (cudaOccupancyMaxActive-
    BlocksPerMultiprocessor, at least FT_SWEEP_BLOCKS); then the
    block-parallel kernel (smem) on the same inputs, held to f64 and timed in turns
    (smem, reg2, reg2, smem), with both variants' phase clocks a node; and
    K3c's reg2 on the same inputs, held to its own f64 plain sweep."""
    from qm_door_torch.ops import riccati_fused as rf

    plq = run["lq_data"]["plq"]
    args = [t.contiguous() for t in (plq.A, plq.B, plq.d, plq.lx, plq.lu, plq.lxx, plq.luu,
                                     plq.lux, plq.lxx_f, plq.lx_f)]
    B, N, nx, nu = args[1].shape
    if rf.sweep_variant(nx, nu) != "reg2" or nu != 36:
        raise RuntimeError(f"K2 at nu = {nu}: variant {rf.sweep_variant(nx, nu)}")
    blocks = {v: rf.blocks_per_sm(v, nx, nu) for v in ("reg2", "smem")}
    if blocks["reg2"] < FT_SWEEP_BLOCKS:
        raise RuntimeError(f"K2 reg2 at {nx}/{nu}: {blocks['reg2']} blocks an SM, "
                           f"fewer than {FT_SWEEP_BLOCKS}")
    nbytes, flops = sweep_cost(B, N, nx, nu)
    ref = rf.riccati_backward_fused_plain(*[t.double() for t in args])
    row, _ = kernel_row("K2", "riccati_backward_fused reg2, nu = 36", rf.riccati_backward_fused,
                        rf.riccati_backward_fused_plain, args, ref, SWEEP_REL_TOL, nbytes, flops,
                        tag="g", shape=[B, N, nx, nu], blocks_per_sm=blocks)
    sweep_turns(row, args, ref, True, tag="g")
    # K3c runs the same kernel without the input symmetrization: reg2 at
    # this shape too, on the same inputs, against its own f64 plain sweep
    _, row["rel_err_k3c"], _ = sweep_run("K3c", args, rf.sweep_plain(
        *[t.double() for t in args], 0.0, False), "nu = 36 iterate")
    log(f"[g] K3c reg2 at 384 x 67 x 30 x 36: relative error {row['rel_err_k3c']:.3e}")
    row["library_ms"] = None
    row["launches"] = run["sweep_variants"]["K2"]["reg2"]
    return row


def phase_options(dev, refs):
    """(g) the other options on the card, each on bm_k1 at B = 384: one cold
    and WARM_STEPS warm steps held to VIOLATION_MAX, or OPTION_WARM_STEPS
    warm steps and (c)'s cross-precision check (OPTIONS says which); the
    launches a step checked (K1 68: 67 reg32 + 1 reg16), the step ms and
    mean violation printed."""
    import torch

    out = {}
    for name, (kw, check) in OPTIONS.items():
        problem = make_problem(dev, torch.float32, BATCH, backend="bm_k1",
                               **dict(dict(lin_tangents="analytic_bf16"), **kw))
        converge = check == "violation"
        warm = WARM_STEPS if converge else OPTION_WARM_STEPS
        run = drive(dev, "bm_k1", "g", problem=problem, warm_steps=warm,
                    viol_max=VIOLATION_MAX if converge else None)
        out[name] = {"check": check, "step_ms": 1e3 * run["elapsed"] / warm,
                     "cold_step_s": run["cold_s"], "mean_violation": run["viol"],
                     "steps": run["steps"], "K1_launches": run["launches"]["K1"]}
        del run, problem
        torch.cuda.empty_cache()
        if not converge:
            cross = phase_cross_precision(dev, refs, "bm_k1", "g", **kw)
            out[name].update(cross_X_err_max=cross["X_err_max"],
                             cross_U_err_max=cross["U_err_max"])
    log("[g] options: " + json.dumps(out))


def solve_pair(device, dtype, around=lambda name, solve: solve()):
    """SqpSolver.solve of one scenario (nu = 30, lin_tangents "analytic",
    the config's sqp_iterations) from the bench problem's first initial
    state, then one warm-started from it on the grid one node later, from
    its planned state; each solve runs as around(name, solve). Returns the
    two solutions by name and the iterations a solve."""
    mpc, stage, x_batch, _, _ = make_problem(device, dtype, 1, "analytic")
    solver = mpc.solver
    sols, sol = {}, None
    for name in ("cold", "warm"):
        if name == "warm":  # the next MPC tick
            x0 = sol.X[1].clone()
            stage = make_problem(device, dtype, 1, "analytic", t0=solver.settings.dt)[1]
        else:
            x0 = x_batch[0]
        warm = None if sol is None else (sol.times, sol.X, sol.U)
        sol = sols[name] = around(name, lambda: solver.solve(stage, x0, warm=warm))
    return sols, solver.settings.sqp_iterations


def phase_single_solve(dev):
    """(g) solve_pair on the card: host ms and K1 launches of each solve (68
    an iteration: the projection's node solves, reg16, and 67 gain solves
    of one system, reg32), every K1 call of the solve held against its f64
    plain version, and both solutions against the same solves on the CPU in
    f64 within (c)'s bars."""
    import torch

    from qm_door_torch.ops.spd_solve import spd_solve
    from qm_door_torch.solver import projection, riccati

    out = {}

    def around(name, solve):
        with k1_calls(riccati, projection) as calls:
            reset_launches()
            torch.cuda.synchronize()
            t0 = time.time()
            new = solve()
            torch.cuda.synchronize()
            ms = (time.time() - t0) * 1e3
            launches = read_launches()
            by_variant = dict(spd_solve.launches_by_variant)
        want = {kid: 68 * iters if kid == "K1" else 0 for kid in launches}
        want_v = dict.fromkeys(spd_solve.launches_by_variant, 0)
        want_v.update(reg16=iters, reg32=67 * iters)
        ok = bool(torch.isfinite(new.X).all() and torch.isfinite(new.U).all())
        if (launches != want or by_variant != want_v or len(calls) != launches["K1"] or not ok
                or not float(new.step_size) > 0):
            raise RuntimeError(f"SqpSolver.solve ({name}): launches {launches}, K1 by variant "
                               f"{by_variant}, K1 calls recorded {len(calls)}, finite {ok}, "
                               f"step {float(new.step_size)}")
        rel, shapes = check_k1_calls(calls, f"in SqpSolver.solve ({name})")
        out[name] = {"host_ms": ms, "K1_launches": launches["K1"], "K1_by_variant": by_variant,
                     "K1_calls_by_shape": shapes, "K1_rel_err_max": rel,
                     "cost": float(new.cost), "violation": float(new.constraint_violation),
                     "step_size": float(new.step_size)}
        return new

    ref, iters = solve_pair(torch.device("cpu"), torch.float64)
    sols = solve_pair(dev, torch.float32, around)[0]
    for name, sol in sols.items():
        dX = (sol.X.double().cpu() - ref[name].X).abs().max().item()
        dU = (sol.U.double().cpu() - ref[name].U).abs().max().item()
        out[name].update(X_err_max=dX, U_err_max=dU, cpu_f64={
            "cost": float(ref[name].cost), "violation": float(ref[name].constraint_violation),
            "step_size": float(ref[name].step_size)})
        if not (dX <= CROSS_DX_MAX and dU <= CROSS_DU_MAX):
            raise RuntimeError(f"SqpSolver.solve ({name}): GPU f32 against CPU f64 max|dX| "
                               f"{dX:.3e} (<= {CROSS_DX_MAX}), max|dU| {dU:.3e} "
                               f"(<= {CROSS_DU_MAX})")
    log("[g] SqpSolver.solve: " + json.dumps(out))


# (h) the whole-body cascade, as tools/wbc_bench.py runs it: B robots, one
# cold and WBC_TICKS chained ticks a stack
WBC_BATCH = 512
WBC_TICKS = 5  # short, so that the whole script fits its 1,200 s limit
WBC_PERIOD = 0.002
WBC_CROSS_BATCH = 4
EOM_BAR = 1e-2    # the level-0 EoM residual bar of tests/test_wbc_batched.py:104-130
TAU_SLACK = 1e-3  # joint torques within effort_limit, relative
# levels 1, 2 of an f32 tick: |r_l(f32) - r_l(f64)| <= bar * ||b_l|| per robot
# (hoqp.level_residuals): twice, rounded up, the JAX package's own f32
# tick's largest deviation from its f64 tick on (h)'s B = 4 inputs on the
# CPU (backend "xla"): 0.0084 and 0.094
WBC_LEVEL_BARS = {1: 0.02, 2: 0.2}
# K1's calls a tick by stack: kind -> (n, m, calls). Every level has
# constraints, so each runs 30 interior-point Newton solves and the f32
# polish; each of the two null projectors solves its Gram system twice for
# each of its two ridges.
WBC_K1_SHAPES = {
    "batched": {"newton": (36, 1, 93), "gram0": (30, 36, 4), "gram1": (52, 36, 4)},
    "ft": {"newton": (42, 1, 93), "gram0": (36, 42, 4), "gram1": (58, 42, 4)},
}


def wbc_problem(dev, dtype, batch, stack):
    """tools/wbc_bench.py's set-up on the port: AlienGo+Z1 at the nominal
    pose, seed-0 state perturbations x 0.01, the weight-compensating input
    for flags [1, 0, 0, 1] (the wrench appended as zeros on "ft", grasp on),
    a zero last input. Returns tick(xs) -> cmd, and the inputs (model,
    gains, xs, us, rbds, flags, grasp, state)."""
    import torch

    from qm_door_torch.config import default_config
    from qm_door_torch.models import centroidal
    from qm_door_torch.models.model import aliengo_z1
    from qm_door_torch.wbc import force, wbc

    model = aliengo_z1(dtype=dtype, device=dev)
    cfg = default_config()
    gains = wbc.as_gains(cfg.wbc, dtype, dev)
    x0 = cfg.initial_state().astype(np.float32)
    rbd = centroidal.rbd_from_generalized(
        model, torch.tensor(x0[6:30], dtype=dtype, device=dev),
        torch.zeros(24, dtype=dtype, device=dev))
    flags = torch.tensor([1.0, 0.0, 0.0, 1.0], dtype=dtype, device=dev)
    u = centroidal.weight_compensating_input(model, flags)
    if stack == "ft":
        u = torch.cat([u, torch.zeros(6, dtype=dtype, device=dev)])
    perturb = np.random.default_rng(0).normal(size=(WBC_BATCH, 30))[:batch] * 0.01
    xs = torch.tensor(x0[None] + perturb, dtype=dtype, device=dev)
    us, rbds = u.expand(batch, -1).contiguous(), rbd.expand(batch, -1).contiguous()
    flagss = flags.expand(batch, 4).contiguous()
    grasp = torch.ones(batch, dtype=dtype, device=dev)
    state = wbc.WbcState.init(dtype=dtype, nu=u.shape[0], batch=(batch,), device=dev)
    inputs = (model, gains, xs, us, rbds, flagss, grasp, state)
    if stack == "ft":
        return (lambda xs: force.hierarchical_wbc_ft_batched(
            model, gains, xs, us, rbds, flagss, grasp, state, WBC_PERIOD)[0]), inputs
    return (lambda xs: wbc.hierarchical_wbc_batched(
        model, gains, xs, us, rbds, flagss, state, WBC_PERIOD, use_arm_init=False)[0]), inputs


def wbc_k1_expect(stack, ticks, batch=WBC_BATCH):
    """K1's launches in `ticks` ticks of a stack: by variant, and by
    (batch, n, m)."""
    from qm_door_torch.ops.spd_solve import VARIANTS, k1_variant

    by_variant, by_shape = dict.fromkeys(VARIANTS, 0), {}
    for n, m, calls in WBC_K1_SHAPES[stack].values():
        by_variant[k1_variant(n, m)] += calls * ticks
        by_shape[(batch, n, m)] = calls * ticks
    return by_variant, by_shape


def check_wbc_k1_calls(calls, label):
    """Every recorded K1 call of a tick against spd_solve_plain in f64 on the
    same inputs. The cascade's Newton systems reach condition 1e6-1e10 near
    convergence, where any f32 solve is off the f64 one by up to
    n * cond * eps (the plain version in f32 too), so each system is held to
    its backward error, ||(A + s I) X - Y|| / (||A + s I|| ||X|| + ||Y||) in
    the max norm, <= K1_REL_TOL, and to the f64 solution within
    n * cond * 2^-23 relative to its largest entry (cond from A's
    eigenvalues, which K1's algorithm bounds its forward error by). The
    forward error on the systems of condition <= 1e3 (phase (a)'s inputs'
    condition) is reported beside. Systems whose f64 solve is not finite,
    and those where K1 returns a non-finite solution at
    n * cond * 2^-24 > 1 (numerically indefinite in f32: the interior point
    rejects that step), are counted, not held. Returns the worst errors and
    the calls by (batch, n, m)."""
    import torch

    from qm_door_torch.ops.spd_solve import spd_solve_plain

    out = dict(backward_max=0.0, forward_over_bound_max=0.0, forward_max_cond_le_1e3=0.0,
               systems=0, systems_cond_le_1e3=0, systems_not_finite_in_f64=0,
               systems_not_finite_on_k1_f32_unfactorable=0, calls_by_shape={})
    for A, Y, shift, X in calls:
        n = A.shape[-1]
        eye = torch.eye(n, dtype=torch.float64, device=A.device)
        A64, Y64, X64 = A.double() + shift * eye, Y.double(), X.double()
        ref = spd_solve_plain(A.double(), Y64, shift)
        allfinite = lambda M: torch.isfinite(M).all(dim=-1).all(dim=-1)  # noqa: E731
        # A's lower triangle, as K1 reads it, on the CPU (cuSOLVER's batched
        # eigensolver refused the closed loop's batches); a system with a
        # non-finite entry has no condition (inf)
        finite_A = torch.isfinite(A64).all(dim=-1).all(dim=-1)
        eig = torch.full(A64.shape[:-1], float("nan"), dtype=torch.float64, device=A.device)
        eig[finite_A] = torch.linalg.eigvalsh(A64[finite_A].cpu()).to(A.device)
        cond = torch.where(eig[:, 0] > 0, eig[:, -1] / eig[:, 0], float("inf"))
        # held: finite in f64, and K1 finite unless n * cond * 2^-24 > 1, where
        # an f32 Cholesky need not complete (Higham, Thm 10.7)
        held = allfinite(ref) & (allfinite(X64) | (n * cond * 2.0 ** -24 <= 1.0))
        norm = lambda M: M.abs().amax(dim=(-2, -1))  # noqa: E731
        backward = norm(A64 @ X64 - Y64) / (A64.abs().sum(-1).amax(-1) * norm(X64) + norm(Y64))
        forward = norm(X64 - ref) / norm(ref).clamp(min=1e-30)
        over = forward / (n * cond * 2.0 ** -23)
        well = held & (cond <= 1e3)
        bad = held & ~((backward <= K1_REL_TOL) & (over <= 1.0))
        if bool(bad.any()):
            raise RuntimeError(f"K1 {label} at {tuple(Y.shape)}: backward error "
                               f"{backward[held].max().item():.3e} (bar {K1_REL_TOL}), "
                               f"forward error over n * cond * 2^-23 "
                               f"{over[held].max().item():.3e} (bar 1)")
        upd = lambda key, v: out.__setitem__(key, max(out[key], v))  # noqa: E731
        if held.any():
            upd("backward_max", backward[held].max().item())
            upd("forward_over_bound_max", over[held].max().item())
        if well.any():
            upd("forward_max_cond_le_1e3", forward[well].max().item())
        out["systems"] += A.shape[0]
        out["systems_cond_le_1e3"] += int(well.sum())
        out["systems_not_finite_in_f64"] += int((~allfinite(ref)).sum())
        out["systems_not_finite_on_k1_f32_unfactorable"] += int((allfinite(ref) & ~held).sum())
        key = tuple(Y.shape)
        out["calls_by_shape"][key] = out["calls_by_shape"].get(key, 0) + 1
    return out


def shape_keys(by_shape):
    """A count by (batch, n, m) with "BxNxM" keys, to print as JSON."""
    return {"x".join(map(str, shape)): count for shape, count in by_shape.items()}


def wbc_tasks(stack, inputs):
    """The EoM task and the priority levels of a tick's inputs
    (wbc_problem's)."""
    from qm_door_torch.wbc import force, tasks, wbc

    model, gains, xs, us, rbds, flagss, grasp, state = inputs
    if stack == "ft":
        data, levels = force.ft_tasks(model, gains, xs, us, rbds, flagss, grasp, state,
                                      WBC_PERIOD)
        return force.floating_base_eom_task_ft(data), levels
    data, levels = wbc.combined_tasks(model, gains, xs, us, rbds, flagss, state, WBC_PERIOD)
    return tasks.floating_base_eom_task(data), levels


def wbc_physical(inputs, eom, levels, cmd):
    """The physical bars of a tick's cmd, judged on wbc_tasks(inputs): the
    level-0 EoM residual, the swing feet's forces, the level-0 inequalities
    (torque limits, friction cone), the joint torques against
    effort_limit. Returns the worst of each."""
    model, flagss = inputs[0], inputs[5]
    n = eom.A.shape[-1]
    x = cmd[:, :n, None]
    F = cmd[:, 24:36].reshape(-1, 4, 3)
    swing = flagss < 0.5
    return {"eom_residual": ((eom.A @ x)[..., 0] - eom.b).abs().max().item(),
            "swing_force_max": F[swing].abs().max().item() if bool(swing.any()) else 0.0,
            "level0_inequality_max": ((levels[0].D @ x)[..., 0] - levels[0].f).max().item(),
            "tau_over_limit_max": (cmd[:, n:].abs() / model.effort_limit).max().item()}


def wbc_cross(dev, stack):
    """(h) at B = 4: the card's f32 tick beside the port's f32 and f64 ticks
    on the CPU. Held: each finite and within the physical bars
    (wbc_physical on the f64 tasks: EoM residual and swing forces < 1e-2,
    level-0 inequalities <= 1e-2, torques within effort_limit x (1 + 1e-3));
    each f32 tick's residual at levels 1 and 2 (hoqp.level_residuals on the
    f64 task data) within WBC_LEVEL_BARS x ||b_l|| of the f64 tick's.
    Printed: those deviations over ||b_l||, and the card's tick against
    each CPU tick on cmd / max(|cmd|, 1), by part (accelerations, forces
    and wrench, torques)."""
    import torch

    from qm_door_torch.wbc import hoqp

    cpu = torch.device("cpu")
    cmds, inputs = {}, {}
    for name, device, dtype in (("gpu_f32", dev, torch.float32), ("cpu_f32", cpu, torch.float32),
                                ("cpu_f64", cpu, torch.float64)):
        tick, inputs[name] = wbc_problem(device, dtype, WBC_CROSS_BATCH, stack)
        cmds[name] = tick(inputs[name][2]).double().cpu()
    nf = 18 if stack == "ft" else 12
    parts = {"qdd": slice(0, 24), "forces": slice(24, 24 + nf), "tau": slice(24 + nf, None)}
    row = {"stack": stack, "batch": WBC_CROSS_BATCH}
    eom, levels = wbc_tasks(stack, inputs["cpu_f64"])
    r64 = hoqp.level_residuals(levels, cmds["cpu_f64"])
    for name, cmd in cmds.items():
        phys = row[f"physical_{name}"] = wbc_physical(inputs["cpu_f64"], eom, levels, cmd)
        if not (bool(torch.isfinite(cmd).all()) and phys["eom_residual"] < EOM_BAR
                and phys["swing_force_max"] < EOM_BAR and phys["level0_inequality_max"] <= EOM_BAR
                and phys["tau_over_limit_max"] <= 1.0 + TAU_SLACK):
            raise RuntimeError(f"WBC {stack} {name}: finite "
                               f"{bool(torch.isfinite(cmd).all())}, physical bars {phys}")
        if name == "cpu_f64":
            continue
        r = hoqp.level_residuals(levels, cmd)
        dev_b = {level: ((r[:, level] - r64[:, level]).abs()
                         / torch.linalg.norm(levels[level].b, dim=-1)).max().item()
                 for level in WBC_LEVEL_BARS}
        row[f"level_residual_dev_over_b_{name}"] = dev_b
        if not all(dev_b[level] <= bar for level, bar in WBC_LEVEL_BARS.items()):
            raise RuntimeError(f"WBC {stack} {name}: level residuals off the f64 tick's by "
                               f"{dev_b} of ||b_l|| (bars {WBC_LEVEL_BARS})")
    row["level_residuals_cpu_f64"] = r64[:, 1:].tolist()
    scale = cmds["cpu_f64"].abs().clamp(min=1.0)
    for other in ("cpu_f32", "cpu_f64"):
        row[f"gpu_f32_vs_{other}_scaled"] = {
            k: ((cmds["gpu_f32"][:, sl] - cmds[other][:, sl]) / scale[:, sl]).abs().max().item()
            for k, sl in parts.items()}
    return row


def wbc_kernel_rows(stack, calls, launches_by_shape, ticks):
    """K1 at each of the stack's shapes, on the first recorded call of that
    shape in a tick (interior-point iteration 0's Newton system, the first
    projector's thin-ridge Gram system; check_wbc_k1_calls holds every call
    to f64): its launches in the chained ticks (`launches_by_shape`, the
    wrapper's count), its difference from the plain f32 solve, ms in
    chained calls and in a CUDA graph, the plain version's and
    torch.linalg's ms (cholesky_ex + cholesky_solve), the bound."""
    import torch

    from qm_door_torch.ops.spd_solve import k1_variant, spd_solve, spd_solve_plain

    rows = []
    for kind, (n, m, _) in WBC_K1_SHAPES[stack].items():
        A, Y, shift, X = next(c for c in calls if tuple(c[1].shape[1:]) == (n, m))
        batch = Y.shape[0]
        eye = torch.eye(n, dtype=A.dtype, device=A.device)
        plain = spd_solve_plain(A, Y, shift)
        launches = launches_by_shape[(batch, n, m)]
        nbytes = 4 * batch * (n * (n + 1) // 2 + 2 * n * m)
        flops = batch * (n ** 3 / 3.0 + 2.0 * n * n * m)
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOPS_PER_S * 1e3
        row = dict(stack=stack, kind=kind, shape=[batch, n, n, m], variant=k1_variant(n, m),
                   launches_per_tick=launches / ticks, launches=launches,
                   max_abs_err=(X - plain).abs().max().item(),
                   ms=cuda_ms(lambda: spd_solve(A, Y, shift), reps=50),
                   ms_graph=graph_ms(lambda: spd_solve(A, Y, shift)),
                   plain_ms=cuda_ms(lambda: spd_solve_plain(A, Y, shift), reps=2, warmup=1),
                   library_ms=cuda_ms(lambda: torch.cholesky_solve(
                       Y, torch.linalg.cholesky_ex(A + shift * eye)[0]), reps=20),
                   bytes=nbytes, flops=flops, bytes_ms=t_bytes, ops_ms=t_ops,
                   bound_ms=max(t_bytes, t_ops),
                   bound_by="bytes" if t_bytes >= t_ops else "operations")
        log("[h] K1 " + json.dumps(row))
        rows.append(row)
    return rows


def phase_wbc(dev):
    """(h) the whole-body cascade on the card, both stacks as
    tools/wbc_bench.py runs them (B = 512, f32): one cold tick and
    WBC_TICKS chained ticks (xs += 1e-9 * cmd[:, :30]) with the launch
    counters set to 0 before each and read after (K1 exactly 101 a tick,
    by variant and by shape as WBC_K1_SHAPES says; every other counter 0);
    ticks/s, host ms a tick, one tick's device busy ms under torch.profiler
    and the card's idle share; every K1 call of one tick held to f64
    (check_wbc_k1_calls) and counted by shape against WBC_K1_SHAPES; K1's
    rows at the six shapes with the chained ticks' launches by shape; the
    cross checks at B = 4 (wbc_cross). Returns the K1 rows."""
    import torch

    from qm_door_torch.ops.spd_solve import spd_solve
    from qm_door_torch.wbc import hoqp, qp

    rows = []
    for stack in ("batched", "ft"):
        per_tick = sum(c for _, _, c in WBC_K1_SHAPES[stack].values())
        tick, inputs = wbc_problem(dev, torch.float32, WBC_BATCH, stack)
        xs = inputs[2]
        counts = {}
        for name, ticks in (("cold", 1), ("chained", WBC_TICKS)):
            reset_launches()
            torch.cuda.synchronize()
            t0 = time.time()
            if name == "cold":
                out = tick(xs)
            else:
                for _ in range(ticks):
                    xs = xs + 1e-9 * out[:, :30]
                    out = tick(xs)
            torch.cuda.synchronize()
            seconds = time.time() - t0
            launches, by_variant = read_launches(), dict(spd_solve.launches_by_variant)
            by_shape = dict(spd_solve.launches_by_shape)
            want = {kid: per_tick * ticks if kid == "K1" else 0 for kid in launches}
            if (launches, (by_variant, by_shape)) != (want, wbc_k1_expect(stack, ticks)):
                raise RuntimeError(f"WBC {stack} ({name}, {ticks} ticks): launches {launches}, "
                                   f"K1 by variant {by_variant}, by shape {by_shape}, expected "
                                   f"{want}, {wbc_k1_expect(stack, ticks)}")
            counts[name] = dict(seconds=seconds, launches=launches, k1_by_variant=by_variant,
                                k1_by_shape=by_shape)
        if not bool(torch.isfinite(out).all()):
            raise RuntimeError(f"WBC {stack}: non-finite cmd after {WBC_TICKS} ticks")
        elapsed = counts["chained"]["seconds"]
        tick_ms = 1e3 * elapsed / WBC_TICKS
        seconds, t0 = {k: v["seconds"] for k, v in counts.items()}, time.time()
        prof = device_busy(lambda: tick(xs))
        seconds["profile"], t0 = time.time() - t0, time.time()
        with k1_calls(qp, hoqp) as calls:
            tick(xs)
            torch.cuda.synchronize()
        k1 = check_wbc_k1_calls(calls, f"in the {stack} tick")
        if k1["calls_by_shape"] != wbc_k1_expect(stack, 1)[1]:
            raise RuntimeError(f"WBC {stack}: K1 calls of the recorded tick by shape "
                               f"{k1['calls_by_shape']}, expected {wbc_k1_expect(stack, 1)[1]}")
        k1["calls_by_shape"] = shape_keys(k1["calls_by_shape"])
        seconds["k1_calls"], t0 = time.time() - t0, time.time()
        rows += wbc_kernel_rows(stack, calls, counts["chained"]["k1_by_shape"], WBC_TICKS)
        seconds["k1_rows"], t0 = time.time() - t0, time.time()
        cross = wbc_cross(dev, stack)
        seconds["cross"] = time.time() - t0
        result = {
            "metric": "wbc_ticks_per_s", "value": WBC_BATCH * WBC_TICKS / elapsed,
            "unit": "ticks/s", "per_tick_us": 1e6 * elapsed / (WBC_BATCH * WBC_TICKS),
            "batch": WBC_BATCH, "mode": stack, "ticks": WBC_TICKS, "dtype": "float32",
            "cold_tick_s": counts["cold"]["seconds"], "host_ms_per_tick": tick_ms,
            "device_busy_ms_per_tick": prof["kernel_ms"], "device_ops_per_tick": prof["device_ops"],
            "device_idle_share": None if prof["kernel_ms"] is None
            else 1.0 - prof["kernel_ms"] / tick_ms,
            "top_device_ms": prof["top_ms"],
            "k1_launches": counts["chained"]["launches"]["K1"],
            "k1_launches_per_tick": counts["chained"]["launches"]["K1"] / WBC_TICKS,
            "k1_by_variant": counts["chained"]["k1_by_variant"],
            "k1_by_shape": shape_keys(counts["chained"]["k1_by_shape"]),
            "k1_calls_against_f64": k1, "finite": True, "impl": "torch",
            "device": torch.cuda.get_device_name(0), "seconds": seconds}
        log("[h] " + json.dumps(result))
        log("[h] cross " + json.dumps(cross))
    return rows


# (i) the batched closed loop, as tools/rollout_bench.py runs it: B scenarios
# x LOOP_CYCLES MPC cycles of LOOP_MPC_DECIM physics steps (1 kHz), a WBC
# tick every LOOP_CONTROL_DECIM of them
LOOP_BATCH = 1024
LOOP_CYCLES = 6  # short, so that the whole script fits its 1,200 s limit
LOOP_MPC_DECIM = 10
LOOP_CONTROL_DECIM = 2
LOOP_PAYLOAD_N = 60.0  # payload 0-60 N on -z every cycle
LOOP_PUSH_N = 60.0     # a 0-60 N lateral push at a random heading
LOOP_PUSH_CYCLES = (3, 5)  # ... in cycles 3-4
LOOP_HEIGHT_BAND = 0.05    # m: every base within 5 cm of the nominal stance height
LOOP_CROSS_BATCH = 4
LOOP_CROSS_CYCLES = 2
# the card's f32 loop against the CPU's f64 loop at B = 4 after each of 2
# cycles, max abs over scenarios and coordinates (m and rad): twice, rounded
# up, the JAX package's own f32 loop's largest deviation from its f64 loop
# on the same inputs on the CPU (python3 tests/torch_parity.py loop-bars:
# base pose 8.5e-6 / 1.66e-4, joints 1.79e-4 / 4.94e-3 after cycles 1 / 2)
LOOP_CROSS_BARS = {"base_pose": 4e-4, "joint_q": 1e-2}


def loop_inputs(q0, batch, cycles):
    """tools/rollout_bench.py's domain randomization from seed 0, for the
    first `batch` of LOOP_BATCH scenarios: q0 (24,) (the nominal pose, feet
    on the ground) perturbed x 0.01, and the wrenches (cycles, batch, 6):
    the payload on -z every cycle, the push in LOOP_PUSH_CYCLES (clipped to
    the run). numpy float64."""
    rng = np.random.default_rng(0)
    q0b = np.asarray(q0)[None] + rng.normal(size=(LOOP_BATCH, 24)) * 0.01
    wr = np.zeros((cycles, LOOP_BATCH, 6))
    wr[:, :, 2] -= rng.uniform(0.0, LOOP_PAYLOAD_N, size=LOOP_BATCH)[None, :]
    heading = rng.uniform(0.0, 2 * np.pi, size=LOOP_BATCH)
    push = rng.uniform(0.0, LOOP_PUSH_N, size=LOOP_BATCH)
    lo, hi = min(LOOP_PUSH_CYCLES[0], cycles - 1), min(LOOP_PUSH_CYCLES[1], cycles)
    wr[lo:hi, :, 0] += (push * np.cos(heading))[None, :]
    wr[lo:hi, :, 1] += (push * np.sin(heading))[None, :]
    return q0b[:batch], wr[:, :batch]


def loop_problem(dev, dtype, batch, cycles):
    """(i)'s set-up on the port: AlienGo+Z1, default_config() with
    lin_chunk = 0, the trot from t = 0, N = 67; SimConfig() (flat, no
    walls); BatchedClosedLoop on bm_k1; the stages of `cycles` cycles, the
    initial carry and the wrenches of loop_inputs. Returns (loop, stages,
    carry, wrenches, z_nominal)."""
    import torch

    from qm_door_torch.config import default_config
    from qm_door_torch.models import centroidal, kinematics, spatial
    from qm_door_torch.models.model import aliengo_z1
    from qm_door_torch.ocp.gait import GAIT_LIBRARY, GaitSchedule
    from qm_door_torch.ocp.problem import make_ocp_config
    from qm_door_torch.ocp.reference import TargetTrajectories
    from qm_door_torch.sim.batched_rollout import BatchedClosedLoop, cycle_stage, stack_stages
    from qm_door_torch.sim.sim import SimConfig
    from qm_door_torch.solver.sqp import SqpSolver

    cfg = default_config()
    cfg.sqp.lin_chunk = 0
    model = aliengo_z1(dtype=dtype, device=dev)
    solver = SqpSolver(model, make_ocp_config(model, cfg), cfg)
    x0 = torch.tensor(cfg.initial_state(), dtype=dtype, device=dev)
    R_ee, p_ee = kinematics.ee_pose(model, x0[6:30])
    tstate = torch.cat([x0, p_ee, spatial.rot_to_quat(R_ee)])
    targets = TargetTrajectories.create(
        torch.tensor([0.0, 1e5], dtype=dtype, device=dev), torch.stack([tstate, tstate]),
        torch.zeros((2, 30), dtype=dtype, device=dev))
    sched = GaitSchedule()
    sched.insert_template(GAIT_LIBRARY["trot"], 0.0, 60.0)
    sim_cfg = SimConfig()
    loop = BatchedClosedLoop(model, cfg, solver, sim_cfg, LOOP_CONTROL_DECIM, LOOP_MPC_DECIM)
    stages = stack_stages(model, cfg, sched, targets, 0.0, cycles,
                          LOOP_MPC_DECIM * sim_cfg.dt, dtype)
    # the nominal pose with its feet on the ground, in f64 on the CPU for
    # every run alike
    m64 = aliengo_z1(dtype=torch.float64, device="cpu")
    q0 = centroidal.pinocchio_q(torch.tensor(cfg.initial_state(), dtype=torch.float64)).clone()
    q0[2] -= kinematics.contact_positions(m64, q0)[:, 2].mean()
    q0b, wr = loop_inputs(q0.numpy(), batch, cycles)
    carry = loop.init_carry(cycle_stage(stages, 0), torch.tensor(q0b, dtype=dtype, device=dev))
    return loop, stages, carry, torch.tensor(wr, dtype=dtype, device=dev), float(q0[2])


def loop_k1_expect(cycles, batch=LOOP_BATCH):
    """K1's launches in `cycles` cycles on bm_k1: a cycle's SQP step (1
    projection solve over B x 67 nodes, 67 gain solves) and its
    LOOP_MPC_DECIM / LOOP_CONTROL_DECIM WBC ticks (WBC_K1_SHAPES's nominal
    stack). Returns (total, by variant, by (batch, n, m))."""
    from qm_door_torch.ops.spd_solve import VARIANTS, k1_variant

    ticks = LOOP_MPC_DECIM // LOOP_CONTROL_DECIM
    shapes = [(batch * 67, 12, 49, 1), (batch, 30, 31, 67)]
    shapes += [(batch, n, m, calls * ticks) for n, m, calls in WBC_K1_SHAPES["batched"].values()]
    by_variant, by_shape = dict.fromkeys(VARIANTS, 0), {}
    for b, n, m, calls in shapes:
        by_variant[k1_variant(n, m)] += calls * cycles
        by_shape[(b, n, m)] = calls * cycles
    return sum(by_shape.values()), by_variant, by_shape


def loop_states(loop, stages, carry, wrenches, cycles):
    """Run `cycles` cycles one at a time; the base pose and joint positions
    after each, (cycles, B, 6) and (cycles, B, 18), in f64 on the CPU, and
    the final carry."""
    import torch

    from qm_door_torch.sim.batched_rollout import cycle_stage

    base, joints = [], []
    for i in range(cycles):
        carry, _ = loop.run(cycle_stage(stages, slice(i, i + 1)), carry, wrenches[i:i + 1])
        q = carry.sim.q.double().cpu()
        base.append(q[:, 0:6])
        joints.append(q[:, 6:24])
    return torch.stack(base), torch.stack(joints), carry


def loop_states_on(device_name, dtype_name):
    """(i)'s loop at B = LOOP_CROSS_BATCH for LOOP_CROSS_CYCLES cycles on
    `device_name` in `dtype_name`: the base pose and joint positions after
    each cycle and the alive flags. The CPU f64 run is a spawned worker's
    (phase_closed_loop starts it after its timings, two torch threads)."""
    import torch

    if device_name == "cpu":
        torch.set_num_threads(2)
    loop, stages, carry, wr, _ = loop_problem(torch.device(device_name),
                                              getattr(torch, dtype_name), LOOP_CROSS_BATCH,
                                              LOOP_CROSS_CYCLES)
    base, joints, carry = loop_states(loop, stages, carry, wr, LOOP_CROSS_CYCLES)
    return dict(base_pose=base.numpy(), joint_q=joints.numpy(), alive=carry.alive.cpu().tolist())


def loop_cross(dev, cpu_f64):
    """(i) at B = 4 and LOOP_CROSS_CYCLES cycles: the card's f32 loop against
    the port's f64 loop on the CPU (`cpu_f64`, a future of
    loop_states_on("cpu", "float64")), on the base pose and the joint
    positions after each cycle (LOOP_CROSS_BARS, max abs)."""
    out = {"gpu_f32": loop_states_on(str(dev), "float32"), "cpu_f64": cpu_f64.result()}
    row = {"batch": LOOP_CROSS_BATCH, "cycles": LOOP_CROSS_CYCLES, "bars": LOOP_CROSS_BARS,
           "alive": {k: v["alive"] for k, v in out.items()}}
    for key in ("base_pose", "joint_q"):
        dev_by_cycle = np.abs(out["gpu_f32"][key] - out["cpu_f64"][key]).max(axis=(1, 2))
        row[f"{key}_dev_by_cycle"] = dev_by_cycle.tolist()
    log("[i] cross " + json.dumps(row))
    ok = all(all(v["alive"]) for v in out.values()) and all(
        max(row[f"{key}_dev_by_cycle"]) <= bar for key, bar in LOOP_CROSS_BARS.items())
    if not ok:
        raise RuntimeError(f"closed loop cross precision: {row}")
    return row


def loop_kernel_row(calls, launches_by_shape, cycles):
    """K1 on (i)'s path: each of its five shapes timed on the first recorded
    call of that shape in a cycle (ms in chained calls, the plain version's
    and torch.linalg's ms, the bound), summed over a cycle's calls like (a)'s
    main-path row; the timed cycles' launches by shape."""
    import torch

    from qm_door_torch.ops.spd_solve import k1_variant, spd_solve, spd_solve_plain

    per_cycle = loop_k1_expect(1)[2]
    shapes, sums = [], dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bytes_ms=0.0, ops_ms=0.0,
                            bound_ms=0.0)
    for (batch, n, m), calls_a_cycle in per_cycle.items():
        A, Y, shift, X = next(c for c in calls if tuple(c[1].shape) == (batch, n, m))
        eye = torch.eye(n, dtype=A.dtype, device=A.device)
        nbytes = 4 * batch * (n * (n + 1) // 2 + 2 * n * m)
        flops = batch * (n ** 3 / 3.0 + 2.0 * n * n * m)
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOPS_PER_S * 1e3
        row = dict(shape=[batch, n, n, m], variant=k1_variant(n, m),
                   calls_per_cycle=calls_a_cycle,
                   launches=launches_by_shape[(batch, n, m)],
                   max_abs_err=(X - spd_solve_plain(A, Y, shift)).abs().max().item(),
                   ms=cuda_ms(lambda: spd_solve(A, Y, shift), reps=50),
                   plain_ms=cuda_ms(lambda: spd_solve_plain(A, Y, shift), reps=2, warmup=1),
                   library_ms=cuda_ms(lambda: torch.cholesky_solve(
                       Y, torch.linalg.cholesky_ex(A + shift * eye)[0]), reps=20),
                   bytes_ms=t_bytes, ops_ms=t_ops, bound_ms=max(t_bytes, t_ops),
                   bound_by="bytes" if t_bytes >= t_ops else "operations")
        for key in sums:
            sums[key] += row[key] * calls_a_cycle
        log("[i] K1 " + json.dumps(row))
        shapes.append(row)
    return {
        "name": "spd_solve", "route": "cuda", "source": "qm_door_torch/csrc/spd_solve.cu",
        "replaces": "qm_door_tpu/ops/pallas_chol.py:103", "path": "closed loop bm_k1",
        "launches": sum(launches_by_shape.values()),
        "launches_per_cycle": sum(launches_by_shape.values()) / cycles,
        "max_abs_err": max(r["max_abs_err"] for r in shapes),
        # one cycle's K1 work (the SQP step's 68 solves and 5 ticks' 505), in
        # chained-call events
        **{k: sums[k] for k in ("ms", "plain_ms", "library_ms", "bound_ms")},
        "bound_by": "bytes" if sums["bytes_ms"] >= sums["ops_ms"] else "operations",
        "shapes": shapes}


def phase_closed_loop(dev):
    """(i) the batched closed loop on the card, tools/rollout_bench.py's
    configuration: B = LOOP_BATCH, f32, bm_k1, one untimed cycle, then
    LOOP_CYCLES timed cycles from the same start with the launch counters
    set to 0 just before and read just after (K1 exactly loop_k1_expect's,
    by variant and by shape; every other counter 0); closed-loop sim-s per
    wall-s, MPC solves/s, the wall time; one more cycle with host timers
    around the solve, the WBC ticks and the physics steps (each ended by a
    synchronize) and one under torch.profiler (device busy ms, the card's
    idle share); every K1 call of one cycle counted by shape, those of its
    SQP step and first WBC tick held to f64 (check_wbc_k1_calls); every
    state finite, every scenario alive, every
    base height within LOOP_HEIGHT_BAND of the nominal stance; the cross
    check at B = 4 (loop_cross), its CPU f64 loop in a spawned process
    started once the timings are taken. Returns K1's row on this path."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    import torch

    from qm_door_torch.ops.spd_solve import spd_solve
    from qm_door_torch.sim.batched_rollout import cycle_stage
    from qm_door_torch.solver import riccati, transcription
    from qm_door_torch.wbc import hoqp, qp

    seconds, t0 = {}, time.time()
    loop, stages, carry0, wr, z_nominal = loop_problem(dev, torch.float32, LOOP_BATCH,
                                                       LOOP_CYCLES)
    seconds["setup"], t0 = time.time() - t0, time.time()
    loop.run(cycle_stage(stages, slice(0, 1)), carry0, wr[:1])  # warms the allocator, kernels
    torch.cuda.synchronize()
    seconds["warm_cycle"], t0 = time.time() - t0, time.time()

    reset_launches()
    torch.cuda.synchronize()
    t_run = time.time()
    carry, log_ = loop.run(stages, carry0, wr)
    torch.cuda.synchronize()
    wall = time.time() - t_run
    launches, by_variant = read_launches(), dict(spd_solve.launches_by_variant)
    by_shape = dict(spd_solve.launches_by_shape)
    total, want_variant, want_shape = loop_k1_expect(LOOP_CYCLES)
    want = {kid: total if kid == "K1" else 0 for kid in launches}
    if (launches, by_variant, by_shape) != (want, want_variant, want_shape):
        raise RuntimeError(f"closed loop ({LOOP_CYCLES} cycles): launches {launches}, K1 by "
                           f"variant {by_variant}, by shape {by_shape}; expected {want}, "
                           f"{want_variant}, {want_shape}")
    seconds["timed_cycles"], t0 = time.time() - t0, time.time()
    log(f"[i] {LOOP_CYCLES} cycles in {wall:.2f} s, K1 {by_variant} by variant, as expected")

    q = carry.sim.q
    finite = all(bool(torch.isfinite(t).all()) for t in (
        q, carry.sim.v, carry.X, carry.U, carry.command, log_.base_pose, log_.mpc_cost))
    alive = int(carry.alive.sum())
    height_dev = (log_.base_pose[:, :, 2] - z_nominal).abs().max().item()

    # host ms a cycle by part, each call ended by a synchronize
    split = {"solve": 0.0, "wbc_ticks": 0.0, "physics_steps": 0.0}

    def timed(fn, key):
        def call(*args):
            torch.cuda.synchronize()
            t = time.time()
            out = fn(*args)
            torch.cuda.synchronize()
            split[key] += 1e3 * (time.time() - t)
            return out
        return call

    last = cycle_stage(stages, slice(LOOP_CYCLES - 1, LOOP_CYCLES))
    loop._solve = timed(loop._solve, "solve")
    loop._control_tick = timed(loop._control_tick, "wbc_ticks")
    loop._physics_step = timed(loop._physics_step, "physics_steps")
    torch.cuda.synchronize()
    t = time.time()
    loop.run(last, carry, wr[-1:])
    torch.cuda.synchronize()
    split["cycle"] = 1e3 * (time.time() - t)
    split["other"] = split["cycle"] - sum(v for k, v in split.items() if k != "cycle")
    del loop._solve, loop._control_tick, loop._physics_step
    seconds["split_cycle"], t0 = time.time() - t0, time.time()
    with k1_calls(transcription, riccati, qp, hoqp) as calls:
        loop.run(last, carry, wr[-1:])
        torch.cuda.synchronize()
    recorded = {}
    for _, Y, _, _ in calls:
        recorded[tuple(Y.shape)] = recorded.get(tuple(Y.shape), 0) + 1
    if recorded != loop_k1_expect(1)[2]:
        raise RuntimeError(f"closed loop: K1 calls of the recorded cycle by shape {recorded}, "
                           f"expected {loop_k1_expect(1)[2]}")
    row = loop_kernel_row(calls, by_shape, LOOP_CYCLES)
    seconds["k1_row"], t0 = time.time() - t0, time.time()
    # no host time is taken from here on (the profile reads the card's
    # kernel time): the cross check's CPU f64 loop runs in a spawned worker
    # meanwhile
    with ProcessPoolExecutor(1, mp_context=multiprocessing.get_context("spawn")) as pool:
        cpu_f64 = pool.submit(loop_states_on, "cpu", "float64")
        prof = device_busy(lambda: loop.run(last, carry, wr[-1:]))
        seconds["profile"], t0 = time.time() - t0, time.time()
        # the SQP step's 68 calls and the first WBC tick's 101 held to f64
        # (the other four ticks' calls are of the same shapes; all 573 took
        # ~50 s)
        k1 = check_wbc_k1_calls(calls[:68 + 101],
                                "in a closed-loop cycle's solve and first tick")
        k1["calls_by_shape"] = shape_keys(k1["calls_by_shape"])
        del calls
        seconds["k1_calls"], t0 = time.time() - t0, time.time()
        cross = loop_cross(dev, cpu_f64)
    seconds["cross"] = time.time() - t0

    cycle_ms = 1e3 * wall / LOOP_CYCLES
    sim_s = LOOP_BATCH * LOOP_CYCLES * LOOP_MPC_DECIM * loop.sim_cfg.dt
    result = {
        "metric": "closed_loop_sim_s_per_wall_s", "value": sim_s / wall, "unit": "sim-s/s",
        "mpc_solves_per_s": LOOP_BATCH * LOOP_CYCLES / wall, "wall_s": wall,
        "batch": LOOP_BATCH, "cycles": LOOP_CYCLES, "mpc_decim": LOOP_MPC_DECIM,
        "control_decim": LOOP_CONTROL_DECIM, "backend": "bm_k1", "dtype": "float32",
        "host_ms_per_cycle": cycle_ms, "host_ms_by_part_one_cycle": split,
        "device_busy_ms_per_cycle": prof["kernel_ms"], "device_ops_per_cycle": prof["device_ops"],
        "device_idle_share": None if prof["kernel_ms"] is None
        else 1.0 - prof["kernel_ms"] / cycle_ms,
        "top_device_ms": prof["top_ms"],
        "k1_launches": launches["K1"], "k1_launches_per_cycle": launches["K1"] / LOOP_CYCLES,
        "k1_by_variant": by_variant, "k1_by_shape": shape_keys(by_shape),
        "k1_calls_against_f64": k1, "alive": alive, "finite": finite,
        "base_height_max_dev_m": height_dev, "height_band_m": LOOP_HEIGHT_BAND,
        "mpc_viol_mean_by_cycle": log_.mpc_viol.double().mean(dim=1).tolist(),
        "impl": "torch", "device": torch.cuda.get_device_name(0), "seconds": seconds}
    log("[i] " + json.dumps(result))
    if not (finite and alive == LOOP_BATCH and height_dev <= LOOP_HEIGHT_BAND):
        raise RuntimeError(f"closed loop: finite {finite}, alive {alive}/{LOOP_BATCH}, base "
                           f"height off the nominal by up to {height_dev:.4f} m "
                           f"(band {LOOP_HEIGHT_BAND})")
    return row, result, cross


# (j) one robot: the README's entry point (sim/closed_loop.py:
# ClosedLoopRunner) on tools/record_trace.py:canonical_trot_run's set-up,
# held to the golden trace's first rows
TROT_GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "docs", "artifacts",
                           "trot_2s_trace.jsonl")
# 100 physics steps, 50 ticks, 11 solves, short so that the whole script
# fits its 1,200 s limit (trot_2s.py runs all 2 s)
TROT_SECONDS = 0.1
SIDE_SECONDS = 0.01  # the separated and kalman runs: 5 ticks, the 2 solves at t = 0
# tests/test_trace_golden.py:49-57's bands
TROT_BANDS = {"t": 1e-9, "base_xyz": 5e-3, "base_rpy": 2e-2, "ee": 1e-2, "tau_p95": 1.0,
              "tau_max": 20.0}
# the bars the card's f32 run is held to: a band where the JAX package's own
# f32 run of the same window stays inside it on the CPU, twice JAX's f32
# deviation (rounded up) where it does not. python3 tests/torch_parity.py
# trot-bars 0.1: JAX's f32 run against the golden's first 50 rows: base
# xyz 5.06e-4 m, rpy 2.17e-4 rad, EE 1.89e-4 m, torques p95 0.635 Nm, max
# 22.08 Nm (past the 20 Nm band: single ticks of the f32 polish); its f64
# run: 1.44e-5 m, 8.08e-6 rad, 1.04e-5 m, 0.0196 Nm, 0.802 Nm
TROT_BARS = dict(TROT_BANDS, tau_max=44.2)
# K1's calls: a solve (the projection's node solves, then the gain solve of
# each of the 67 nodes), a tick by stack (93 Newton solves and two
# projectors' Gram solves, as WBC_K1_SHAPES at batch 1)
SOLVE_K1 = {(67, 12, 18): 1, (1, 30, 31): 67}
TICK_K1 = {"combined": {(1, 36, 1): 93, (1, 30, 36): 4, (1, 52, 36): 4},
           "separated": {(1, 36, 1): 93, (1, 30, 36): 4, (1, 48, 36): 4}}
PERIODS_MS = {"tick": 2.0, "solve": 10.0, "step": 1.0}  # the reference's control periods
# the side runs against the CPU's f64 run of the same window, by group
# (side_deviation): LOOP_CROSS_BARS where the JAX package's own f32 run
# stays inside them against its f64 run, twice its deviation (rounded up)
# where it does not. python3 tests/torch_parity.py side-bars 0.01: separated
# base pose 2.6e-8, legs 1.44e-7, arm 8.9e-8; kalman 2.6e-8, 1.32e-7,
# 1.30e-7: all inside. (Over 0.02 s the separated stack's arm leaves
# them, 0.0453: that stack pins the arm's accelerations with nothing but
# the cascade's regularization, and the f32 polish moves the arm within a
# few ticks.)
SIDE_BARS = {label: {"base_pose": LOOP_CROSS_BARS["base_pose"],
                     "leg_q": LOOP_CROSS_BARS["joint_q"], "arm_q": LOOP_CROSS_BARS["joint_q"]}
             for label in ("separated", "kalman")}
SIDE_PATHS = {"separated": {"separated": True},
              "kalman": {"estimator": "kalman", "sensor_noise": "default"}}


def trot_runner(dev, dtype, **runner_kw):
    """canonical_trot_run's set-up on the port: AlienGo+Z1, default_config()
    with the legs and the arm commanded from t = 0, targets held at the
    spawn pose (the EE pose appended), the trot template from 0 to 7 s.
    Returns (runner, targets)."""
    import torch

    from qm_door_torch.config import default_config
    from qm_door_torch.models import kinematics, spatial
    from qm_door_torch.models.model import aliengo_z1
    from qm_door_torch.ocp.gait import GAIT_LIBRARY, GaitSchedule
    from qm_door_torch.ocp.reference import TargetTrajectories
    from qm_door_torch.sim.closed_loop import ClosedLoopRunner

    cfg = default_config()
    cfg.controller.leg_pd_start_time = -1.0
    cfg.wbc.arm_init_time = -1.0
    model = aliengo_z1(dtype=dtype, device=dev)
    x0 = torch.tensor(cfg.initial_state(), dtype=dtype, device=dev)
    R_ee, p_ee = kinematics.ee_pose(model, x0[6:30])
    state = torch.cat([x0, p_ee, spatial.rot_to_quat(R_ee)])
    targets = TargetTrajectories.create(
        torch.tensor([0.0, 1e5], dtype=dtype, device=dev), torch.stack([state, state]),
        torch.zeros((2, 30), dtype=dtype, device=dev))
    sched = GaitSchedule()
    sched.insert_template(GAIT_LIBRARY["trot"], 0.0, 7.0)
    return ClosedLoopRunner(model, cfg, schedule=sched, **runner_kw), targets


def trot_k1_expect(solves, ticks, solve_k1, tick_k1):
    """K1's launches in `solves` solves of `solve_k1`'s calls and `ticks`
    ticks of `tick_k1`'s (each by (batch, n, m)): by variant, by (batch, n,
    m)."""
    from qm_door_torch.ops.spd_solve import VARIANTS, k1_variant

    by_variant, by_shape = dict.fromkeys(VARIANTS, 0), {}
    for calls, count in ((solve_k1, solves), (tick_k1, ticks)):
        for (b, n, m), c in calls.items():
            by_variant[k1_variant(n, m)] += c * count
            by_shape[(b, n, m)] = by_shape.get((b, n, m), 0) + c * count
    return by_variant, by_shape


def golden_deviation(run_log, rows):
    """The log's deviation from the golden's first len(run_log.t) rows, in
    tests/test_trace_golden.py's terms (tests/torch_parity.py trot-bars
    reads the JAX package's runs with it too)."""
    n = len(run_log.t)
    ref = {k: np.asarray([r[k] for r in rows[:n]]) for k in ("t", "base_pose", "tau", "ee_pos")}
    base = np.abs(np.stack(run_log.base_pose) - ref["base_pose"])
    tau = np.abs(np.stack(run_log.tau) - ref["tau"])
    ee = np.abs(np.stack(run_log.ee_pos) - ref["ee_pos"])
    by_row = {"base_xyz": base[:, 0:3].max(axis=1), "base_rpy": base[:, 3:6].max(axis=1),
              "ee": ee.max(axis=1), "tau_max": tau.max(axis=1)}
    return {"rows": n, "t": float(np.abs(np.asarray(run_log.t) - ref["t"]).max()),
            "base_xyz": float(base[:, 0:3].max()), "base_rpy": float(base[:, 3:6].max()),
            "ee": float(ee.max()), "tau_p95": float(np.percentile(tau, 95)),
            "tau_max": float(tau.max()),
            # the golden's t at each quantity's worst row
            "worst_t": {k: float(ref["t"][int(np.argmax(v))]) for k, v in by_row.items()}}


def run_timed(runner, run, step_at, profile_at=(5, 25), record_at=(6, 26)):
    """One run (`run()`, returning the runner's log) of a single-robot runner
    on the card with the launch counters set to 0 just before and read just
    after: host ms of every solve, tick and physics step (each call between
    two synchronizes; the step is the function `step_at` = (module, name)
    the runner's loop calls), the card's busy ms of the solve and the tick
    numbered `profile_at` (device_busy, the call itself), and K1's calls of
    the solve and the tick numbered `record_at` (k1_calls). Returns (log,
    result dict, recorded calls by "solve" / "tick", K1's launches by
    shape)."""
    import torch

    from qm_door_torch.ops.spd_solve import spd_solve
    from qm_door_torch.solver import projection, riccati
    from qm_door_torch.wbc import hoqp, qp

    host = {"solve": [], "tick": [], "step": []}
    busy, recorded = {}, {}

    def timed(kind, fn, modules):
        def call(*args, **kw):
            i = len(host[kind])
            torch.cuda.synchronize()
            t = time.time()
            if i == profile_at[kind == "tick"] and kind != "step":
                out = []
                busy[kind] = device_busy(lambda: out.append(fn(*args, **kw)))
                out = out[0]
            elif i == record_at[kind == "tick"] and kind != "step":
                with k1_calls(*modules) as calls:
                    out = fn(*args, **kw)
                    torch.cuda.synchronize()
                recorded[kind] = list(calls)
            else:
                out = fn(*args, **kw)
            torch.cuda.synchronize()
            host[kind].append(1e3 * (time.time() - t))
            return out
        return call

    step_module, step_name = step_at
    solve, tick, step = runner.solver.solve, runner.controller.tick, getattr(step_module,
                                                                             step_name)
    runner.solver.solve = timed("solve", solve, (riccati, projection))
    runner.controller.tick = timed("tick", tick, (qp, hoqp))
    setattr(step_module, step_name, timed("step", step, ()))
    try:
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.time()
        run_log = run()
        torch.cuda.synchronize()
        wall = time.time() - t0
        launches = read_launches()
        by_variant = dict(spd_solve.launches_by_variant)
        by_shape = dict(spd_solve.launches_by_shape)
    finally:
        setattr(step_module, step_name, step)
        del runner.solver.solve, runner.controller.tick
    # the profiled calls carry the profiler's cost: the shares use the
    # median unprofiled host time of their kind
    median = {k: float(np.median([ms for i, ms in enumerate(v)
                                  if i != profile_at[k == "tick"] or k == "step"]))
              for k, v in host.items()}
    result = {
        "wall_s": wall, "safe": run_log.safe, "ticks": len(host["tick"]),
        "solves": len(host["solve"]), "steps": len(host["step"]),
        "host_ms_median": median,
        "host_ms_mean": {k: float(np.mean(v)) for k, v in host.items()},
        "host_ms_max": {k: float(np.max(v)) for k, v in host.items()},
        "over_period": {k: median[k] / PERIODS_MS[k] for k in median},
        "device_busy_ms": {k: v["kernel_ms"] for k, v in busy.items()},
        "device_ops": {k: v["device_ops"] for k, v in busy.items()},
        "device_idle_share": {k: None if v["kernel_ms"] is None
                              else 1.0 - v["kernel_ms"] / median[k] for k, v in busy.items()},
        "top_device_ms": {k: v["top_ms"] for k, v in busy.items()},
        "launches": launches, "k1_by_variant": by_variant, "k1_by_shape": shape_keys(by_shape),
        "mpc_viol_max": max(run_log.mpc_viol) if run_log.mpc_viol else None}
    return run_log, result, recorded, by_shape


def check_trot_launches(result, by_shape, label, solve_k1=SOLVE_K1,
                        tick_k1=TICK_K1["combined"]):
    """K1 exactly `solve_k1` a solve and `tick_k1` a tick, by variant and
    shape, every other kernel 0."""
    want_variant, want_shape = trot_k1_expect(result["solves"], result["ticks"], solve_k1,
                                              tick_k1)
    total = sum(want_shape.values())
    want = {kid: total if kid == "K1" else 0 for kid in result["launches"]}
    if (result["launches"], result["k1_by_variant"], by_shape) != (want, want_variant,
                                                                  want_shape):
        raise RuntimeError(f"{label}: launches {result['launches']}, K1 by variant "
                           f"{result['k1_by_variant']}, by shape {by_shape}; expected {want}, "
                           f"{want_variant}, {want_shape}")


def period_kernel_row(recorded, by_shape, result, solve_k1, tick_k1, tag, path):
    """K1 on a single-robot path: each of the solve's and the tick's shapes
    (`solve_k1`, `tick_k1`: calls by (batch, n, m)) timed on its first
    recorded call (chained-call ms, the plain version's and torch.linalg's
    ms, the bound); summed over one MPC period's work (a solve and five
    ticks) like (i)'s row; the run's launches by shape."""
    import torch

    from qm_door_torch.ops.spd_solve import k1_variant, spd_solve, spd_solve_plain

    calls = recorded["solve"] + recorded["tick"]
    per_period = dict(solve_k1)
    for shape, c in tick_k1.items():
        per_period[shape] = per_period.get(shape, 0) + 5 * c
    shapes, sums = [], dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bytes_ms=0.0, ops_ms=0.0,
                            bound_ms=0.0)
    for (batch, n, m), per in per_period.items():
        A, Y, shift, X = next(c for c in calls if tuple(c[1].shape) == (batch, n, m))
        eye = torch.eye(n, dtype=A.dtype, device=A.device)
        nbytes = 4 * batch * (n * (n + 1) // 2 + 2 * n * m)
        flops = batch * (n ** 3 / 3.0 + 2.0 * n * n * m)
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOPS_PER_S * 1e3
        row = dict(shape=[batch, n, n, m], variant=k1_variant(n, m), calls_per_mpc_period=per,
                   launches=by_shape[(batch, n, m)],
                   max_abs_err=(X - spd_solve_plain(A, Y, shift)).abs().max().item(),
                   ms=cuda_ms(lambda: spd_solve(A, Y, shift), reps=50),
                   ms_graph=graph_ms(lambda: spd_solve(A, Y, shift)),
                   plain_ms=cuda_ms(lambda: spd_solve_plain(A, Y, shift), reps=3, warmup=1),
                   library_ms=cuda_ms(lambda: torch.cholesky_solve(
                       Y, torch.linalg.cholesky_ex(A + shift * eye)[0]), reps=20),
                   bytes_ms=t_bytes, ops_ms=t_ops, bound_ms=max(t_bytes, t_ops),
                   bound_by="bytes" if t_bytes >= t_ops else "operations")
        for key in sums:
            sums[key] += row[key] * per
        log(f"[{tag}] K1 " + json.dumps(row))
        shapes.append(row)
    return {
        "name": "spd_solve", "route": "cuda", "source": "qm_door_torch/csrc/spd_solve.cu",
        "replaces": "qm_door_tpu/ops/pallas_chol.py:103", "path": path,
        "launches": result["launches"]["K1"],
        "max_abs_err": max(r["max_abs_err"] for r in shapes),
        # one MPC period's K1 work (a solve and five ticks), in chained-call
        # events
        **{k: sums[k] for k in ("ms", "plain_ms", "library_ms", "bound_ms")},
        "bound_by": "bytes" if sums["bytes_ms"] >= sums["ops_ms"] else "operations",
        "shapes": shapes}


def side_reference(runner_kw):
    """The port's own f64 run of a side path on the CPU, for SIDE_SECONDS:
    (base poses, joint positions (the observation's [12:30]), safe), numpy.
    Runs in a worker process of phase_trot's, two torch threads."""
    import torch

    torch.set_num_threads(2)
    runner, targets = trot_runner(torch.device("cpu"), torch.float64, **runner_kw)
    ref = runner.run(targets, duration=SIDE_SECONDS)
    return np.stack(ref.base_pose), np.stack(ref.x_obs)[:, 12:30], ref.safe


def side_deviation(base, ref_base, joints, ref_joints):
    """Max abs difference over every tick of the base pose (m, rad), the leg
    joints' positions (the observation's [12:24]) and the arm joints'
    ([24:30]); `joints` hold the observation's [12:30]."""
    return {"base_pose": float(np.abs(base - ref_base).max()),
            "leg_q": float(np.abs(joints[:, :12] - ref_joints[:, :12]).max()),
            "arm_q": float(np.abs(joints[:, 12:] - ref_joints[:, 12:]).max())}


def side_run(dev, label, reference, **runner_kw):
    """One of (j)'s other paths for SIDE_SECONDS on the card in f32 with K1
    counted exactly, against the port's own f64 run of the same window on
    the CPU (`reference`, a future of side_reference's result): the base
    pose, the leg joints and the arm joints of every tick (side_deviation)
    within SIDE_BARS[label], both runs safe and finite. The reference runs
    on the host meanwhile, so the run's host times are printed, not
    reported."""
    import torch

    from qm_door_torch.sim import closed_loop

    runner, targets = trot_runner(dev, torch.float32, **runner_kw)
    run_log, result, _, by_shape = run_timed(
        runner, lambda: runner.run(targets, duration=SIDE_SECONDS),
        (closed_loop, "sim_step"), profile_at=(-1, -1), record_at=(-1, -1))
    result["seconds"] = SIDE_SECONDS
    stack = "separated" if runner_kw.get("separated") else "combined"
    check_trot_launches(result, by_shape, f"(j) {label}", tick_k1=TICK_K1[stack])
    ref_base, ref_joints, ref_safe = reference.result()
    base, joints = np.stack(run_log.base_pose), np.stack(run_log.x_obs)[:, 12:30]
    same_rows = base.shape == ref_base.shape
    bars = SIDE_BARS[label]
    dev_ = side_deviation(base, ref_base, joints, ref_joints) if same_rows else dict.fromkeys(
        bars)
    finite = all(np.isfinite(np.stack(getattr(run_log, k))).all()
                 for k in ("base_pose", "x_obs", "tau", "ee_pos"))
    result.update(label=label, cross_dev=dev_, bars=bars, finite=finite, cpu_refs_alongside=True,
                  cpu_f64_safe=bool(ref_safe), rows=len(run_log.t), cpu_rows=len(ref_base))
    log("[j] " + json.dumps(result))
    if not (run_log.safe and ref_safe and finite and same_rows
            and all(dev_[k] <= bar for k, bar in bars.items())):
        raise RuntimeError(f"(j) {label}: safe {run_log.safe} / {ref_safe}, finite {finite}, "
                           f"rows {len(run_log.t)} / {len(ref_base)}, card f32 off the CPU's "
                           f"f64 by {dev_} (bars {bars})")
    return result


def trot_check(run_log, rows, label, bars=TROT_BARS):
    """The run safe, finite, every tick's row present with t equal to the
    golden's, and each deviation within its bar; returns the deviations."""
    dev_ = golden_deviation(run_log, rows)
    finite = all(np.isfinite(np.stack(getattr(run_log, k))).all()
                 for k in ("base_pose", "x_obs", "tau", "ee_pos"))
    ok = run_log.safe and finite and dev_["rows"] == len(rows) and all(
        dev_[k] <= bar for k, bar in bars.items())
    line = {"label": label, "safe": run_log.safe, "finite": finite, "deviation": dev_,
                "bars": bars, "bands": TROT_BANDS}
    log(f"[j] {label} against the golden " + json.dumps(line))
    if not ok:
        raise RuntimeError(f"(j) {label} against the golden: {json.dumps(line)}")
    return line


def phase_trot(dev, seconds=TROT_SECONDS, side=True, bars=TROT_BARS, height_offset=0.0):
    """(j) the README's entry point on the card: ClosedLoopRunner on the
    canonical trot in f32 for `seconds`, the spawn raised by `height_offset`
    m (0 in (j); trot_2s.py --height-offset) (every solve, tick and step timed
    between synchronizes; one solve and one tick profiled and their K1
    calls held to f64), held to the golden's first rows (TROT_BARS), K1
    exactly SOLVE_K1 a solve and TICK_K1 a tick; then (side) the separated
    and kalman paths (side_run), their CPU f64 references computed
    meanwhile in two spawned processes (side_reference), started once the
    trot's timings are taken. Returns K1's row on this path, the trot's
    result and the side runs' results."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    rows = [json.loads(line) for line in open(TROT_GOLDEN)][:int(round(seconds / 0.002))]
    row, result = trot_main(dev, seconds, rows, bars, height_offset)
    if not side:
        return row, result, {}
    with ProcessPoolExecutor(2, mp_context=multiprocessing.get_context("spawn")) as pool:
        refs = {label: pool.submit(side_reference, kw) for label, kw in SIDE_PATHS.items()}
        sides = {label: side_run(dev, label, refs[label], **kw)
                 for label, kw in SIDE_PATHS.items()}
    return row, result, sides


def trot_main(dev, seconds, rows, bars, height_offset=0.0):
    """(j)'s trot window: the run, its launches, the golden, the K1 calls and
    K1's row. Returns (row, result)."""
    import torch

    from qm_door_torch.sim import closed_loop

    t0 = time.time()
    runner, targets = trot_runner(dev, torch.float32)
    log_, result, recorded, by_shape = run_timed(
        runner, lambda: runner.run(targets, duration=seconds, start_height_offset=height_offset),
        (closed_loop, "sim_step"))
    result.update(seconds=seconds, height_offset_m=height_offset)
    check_trot_launches(result, by_shape, "(j) trot")
    log("[j] trot host ms " + json.dumps({k: result[k] for k in (
        "wall_s", "ticks", "solves", "steps", "host_ms_median", "host_ms_mean",
        "device_idle_share")}))
    golden = trot_check(log_, rows, "trot", bars)
    k1 = {"solve": check_k1_calls(recorded["solve"], "in a (j) solve"),
          "tick": check_wbc_k1_calls(recorded["tick"], "in a (j) tick")}
    k1["tick"]["calls_by_shape"] = shape_keys(k1["tick"]["calls_by_shape"])
    row = period_kernel_row(recorded, by_shape, result, SOLVE_K1, TICK_K1["combined"], "j",
                            "one robot ClosedLoopRunner")
    result.update(golden=golden, k1_calls_against_f64=k1, impl="torch", dtype="float32",
                  device=torch.cuda.get_device_name(0), phase_s=time.time() - t0)
    log("[j] trot " + json.dumps(result))
    return row, result


# (k) the door: sim/door_loop.py:DoorOpeningRunner on the push door at full
# width, held to the JAX package's f64 trace of the same window
DOOR_TRACE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "docs", "artifacts",
                          "door_press_trace.jsonl")
# 40 coupled physics steps, 20 ticks, the solves at t = 0 (cold and warm) and
# at 10, 20 and 30 ms: the reach, then the press from t = 10 ms
DOOR_SECONDS = 0.04
# DoorScenario fields of (k)'s run: the press inside the window (the default
# reach lasts 0.5 s) and the grasp spring relaxed at the start (handle at
# the spawn EE position)
DOOR_SCENARIO = {"t_reach": 0.01, "handle_ahead": 0.0}
DOOR_TICK_FIELDS = ("t", "panel", "lever", "base_pose", "feet_z", "ee_pos", "ee_err",
                    "wrench_plan")
# a door solve is 2 SQP iterations (DoorOpeningRunner raises sqp_iterations
# to 2): twice SOLVE_K1's calls at nu = 36, the gains on reg64; a
# force-aware tick solves 93 Newton systems and two projectors' Grams
DOOR_SOLVE_K1 = {(67, 12, 18): 2, (1, 36, 31): 134}
DOOR_TICK_K1 = {(1, 42, 1): 93, (1, 36, 42): 4, (1, 58, 42): 4}
# the solve and the tick profiled (device_busy) and recorded (k1_calls): a
# press solve (t = 20 ms, 30 ms) and press ticks (t = 20 ms, 24 ms)
DOOR_PROFILE_AT = (3, 10)
DOOR_RECORD_AT = (4, 12)
# The bars the card's f32 run is held to against the f64 trace, by field
# (door_deviation): a band of TROT_BANDS where the JAX package's own f32 run
# of the same window stays inside it on the CPU (t and the solves' t, base
# xyz and rpy, EE), twice JAX's f32 deviation (rounded up) where the field
# has no band (panel, lever, feet z, EE error, wrench). python3
# tests/torch_parity.py door-bars 0.04: JAX's f32 run against its f64 run
# (which is the trace exactly): t 0, panel 0 (latched throughout), lever
# 1.811e-3 rad, base xyz 5.75e-4 m, rpy 3.04e-4 rad, feet z 5.48e-4 m, EE
# 2.21e-4 m, EE error 2.17e-4 m, wrench 0.498 N, solve times 0, violation
# 2.91e-10, the phases equal. The violation has no deviation bar: it is
# a sum of squared defects (1.23e-7 after the first press solve), and in
# f32 each defect rounds by ~0.5%, so the f32 runs land ~1e-9 from the f64
# value by rounding alone (the card 1.28e-9 in its first run, JAX 2.9e-10);
# each solve's violation is held to VIOLATION_MAX, as every f32 solve of
# this script is.
DOOR_BARS = {"t": TROT_BANDS["t"], "solve_t": TROT_BANDS["t"], "panel": 0.0, "lever": 3.63e-3,
             "base_xyz": TROT_BANDS["base_xyz"], "base_rpy": TROT_BANDS["base_rpy"],
             "feet_z": 1.10e-3, "ee": TROT_BANDS["ee"], "ee_err": 4.34e-4, "wrench": 0.997}


def door_runner(dev, dtype):
    """(k)'s set-up on the port: AlienGo+Z1, default_config() with the legs
    and the arm commanded from t = 0 (as scenarios.make_scenario sets them
    for the door), N = 67, the push door, DoorScenario(**DOOR_SCENARIO)."""
    from qm_door_torch.config import default_config
    from qm_door_torch.models.model import aliengo_z1
    from qm_door_torch.sim.door_loop import DoorOpeningRunner, DoorScenario

    cfg = default_config()
    cfg.controller.leg_pd_start_time = -1.0
    cfg.wbc.arm_init_time = -1.0
    return DoorOpeningRunner(aliengo_z1(dtype=dtype, device=dev), cfg,
                             scenario=DoorScenario(**DOOR_SCENARIO))


def door_rows(run_log):
    """A DoorLog as the trace's rows (JSON-ready): one a tick with the
    fields DOOR_TICK_FIELDS, then one a solve after t = 0 (its t, phase and
    violation), then whether every tick was safe."""
    rows = [dict(kind="tick", **{k: np.asarray(getattr(run_log, k)[i], dtype=np.float64)
                                 .tolist() for k in DOOR_TICK_FIELDS})
            for i in range(len(run_log.t))]
    rows += [dict(kind="solve", t=float(t), phase=phase, viol=float(viol))
             for t, phase, viol in zip(run_log.mpc_t, run_log.mpc_phase, run_log.mpc_viol)]
    return rows + [dict(kind="safe", safe=bool(run_log.safe))]


def _max_abs(rows, ref, key, sl=slice(None)):
    """Max abs difference of field `key` (its slice `sl`) over rows and ref
    rows of equal count; None when there are none."""
    if not rows:
        return None
    a, b = (np.asarray([np.atleast_1d(r[key])[sl] for r in rs], dtype=np.float64)
            for rs in (rows, ref))
    return float(np.abs(a - b).max())


# door_deviation's fields: name -> (DoorLog field, slice)
DOOR_DEVIATION_FIELDS = {
    "t": ("t", slice(None)), "panel": ("panel", slice(None)), "lever": ("lever", slice(None)),
    "base_xyz": ("base_pose", slice(0, 3)), "base_rpy": ("base_pose", slice(3, 6)),
    "feet_z": ("feet_z", slice(None)), "ee": ("ee_pos", slice(None)),
    "ee_err": ("ee_err", slice(None)), "wrench": ("wrench_plan", slice(None))}


def door_deviation(rows, ref):
    """Max abs difference by field (DOOR_DEVIATION_FIELDS; solve_t and viol
    of the solves) of two door_rows lists over the ticks and solves both
    have, the row counts, and whether the solves' phases agree."""
    ticks, ref_ticks = ([r for r in rs if r["kind"] == "tick"] for rs in (rows, ref))
    solves, ref_solves = ([r for r in rs if r["kind"] == "solve"] for rs in (rows, ref))
    n, m = min(len(ticks), len(ref_ticks)), min(len(solves), len(ref_solves))
    out = {"ticks": [len(ticks), len(ref_ticks)], "solves": [len(solves), len(ref_solves)]}
    for name, (key, sl) in DOOR_DEVIATION_FIELDS.items():
        out[name] = _max_abs(ticks[:n], ref_ticks[:n], key, sl)
    out["solve_t"] = _max_abs(solves[:m], ref_solves[:m], "t")
    out["viol"] = _max_abs(solves[:m], ref_solves[:m], "viol")
    out["phases_equal"] = [r["phase"] for r in solves[:m]] == [r["phase"] for r in ref_solves[:m]]
    return out


def door_check(rows, trace, bars):
    """(k)'s run (door_rows) against the trace: safe and finite, every tick
    and solve of the trace present with its t, the solves' phases the
    trace's (every one a press), the planned wrench exactly 0 on every
    reach tick (t < t_reach, before the first press solve) and non-zero on
    every tick after it, each field's deviation within its bar and each
    solve's violation within VIOLATION_MAX. Returns the deviations; raises
    on a miss."""
    dev_ = door_deviation(rows, trace)
    viol_max = max((r["viol"] for r in rows if r["kind"] == "solve"), default=None)
    ticks = [r for r in rows if r["kind"] == "tick"]
    finite = all(np.isfinite(np.asarray(r[k], dtype=np.float64)).all()
                 for r in ticks for k in DOOR_TICK_FIELDS)
    reach = [r for r in ticks if r["t"] < DOOR_SCENARIO["t_reach"] - 1e-9]
    after = [r for r in ticks if r["t"] >= DOOR_SCENARIO["t_reach"] - 1e-9]
    wrench = {"reach_ticks": len(reach), "press_ticks": len(after),
              "reach_max_abs": max((max(abs(w) for w in r["wrench_plan"]) for r in reach),
                                   default=None),
              "press_min_norm": min((float(np.linalg.norm(r["wrench_plan"])) for r in after),
                                    default=None)}
    press = [r["phase"] for r in trace if r["kind"] == "solve"]
    ok = (rows[-1]["safe"] and finite and dev_["ticks"][0] == dev_["ticks"][1]
          and dev_["solves"][0] == dev_["solves"][1] and dev_["phases_equal"]
          and press and set(press) == {"press"} and reach and after
          and wrench["reach_max_abs"] == 0.0 and wrench["press_min_norm"] > 0.0
          and all(dev_[k] <= bar for k, bar in bars.items()) and viol_max <= VIOLATION_MAX)
    line = {"safe": rows[-1]["safe"], "finite": finite, "deviation": dev_, "bars": bars,
            "viol_max": viol_max, "viol_bar": VIOLATION_MAX, "wrench": wrench,
            "phases": press}
    log("[k] door against the trace " + json.dumps(line))
    if not ok:
        raise RuntimeError(f"(k) the door against the trace: {json.dumps(line)}")
    return line


def phase_door(dev):
    """(k) the door on the card: DoorOpeningRunner on door_runner's set-up in
    f32 for DOOR_SECONDS (every coupled physics step, tick and solve timed
    between synchronizes; one solve and one tick profiled and their K1
    calls held to f64), K1 exactly DOOR_SOLVE_K1 a solve and DOOR_TICK_K1 a
    tick, held to the trace (door_check, DOOR_BARS). Returns K1's row on
    this path and the run's result."""
    import torch

    from qm_door_torch.sim import door_loop

    t0 = time.time()
    trace = [json.loads(line) for line in open(DOOR_TRACE)]
    runner = door_runner(dev, torch.float32)
    run_log, result, recorded, by_shape = run_timed(
        runner, lambda: runner.run(duration=DOOR_SECONDS), (door_loop, "coupled_step"),
        profile_at=DOOR_PROFILE_AT, record_at=DOOR_RECORD_AT)
    result["seconds"] = DOOR_SECONDS
    check_trot_launches(result, by_shape, "(k) door", DOOR_SOLVE_K1, DOOR_TICK_K1)
    log("[k] door host ms " + json.dumps({k: result[k] for k in (
        "wall_s", "ticks", "solves", "steps", "host_ms_median", "host_ms_mean",
        "device_idle_share")}))
    trace_check = door_check(door_rows(run_log), trace, DOOR_BARS)
    k1 = {"solve": check_k1_calls(recorded["solve"], "in a (k) solve"),
          "tick": check_wbc_k1_calls(recorded["tick"], "in a (k) tick")}
    k1["tick"]["calls_by_shape"] = shape_keys(k1["tick"]["calls_by_shape"])
    row = period_kernel_row(recorded, by_shape, result, DOOR_SOLVE_K1, DOOR_TICK_K1, "k",
                            "the door DoorOpeningRunner")
    result.update(trace=trace_check, k1_calls_against_f64=k1, impl="torch", dtype="float32",
                  device=torch.cuda.get_device_name(0), phase_s=time.time() - t0)
    log("[k] door " + json.dumps(result))
    return row, result


KERNELS = {  # id -> (name, source, TPU kernel it replaces)
    "K1-ll": ("spd_solve_ll", "qm_door_torch/csrc/spd_solve.cu",
              "qm_door_tpu/ops/pallas_chol.py:133"),
    "K2": ("riccati_backward_fused", "qm_door_torch/csrc/riccati_bwd.cu",
           "qm_door_tpu/ops/pallas_riccati.py:181"),
    "K3a": ("project_geom", "qm_door_torch/csrc/lq_project.cu",
            "qm_door_tpu/ops/pallas_lq.py:393"),
    "K3b": ("project_cost", "qm_door_torch/csrc/lq_project.cu",
            "qm_door_tpu/ops/pallas_lq.py:420"),
    "K3c": ("riccati_backward_ll", "qm_door_torch/csrc/riccati_bwd.cu",
            "qm_door_tpu/ops/pallas_lq.py:446"),
    "K3d": ("riccati_forward_ll", "qm_door_torch/csrc/lq_forward.cu",
            "qm_door_tpu/ops/pallas_lq.py:490"),
}


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

    seconds, t_phase = {}, time.time()

    def phase(name, fn, *args):  # runs one phase and keeps its seconds
        nonlocal t_phase
        out = fn(*args)
        seconds[name], t_phase = time.time() - t_phase, time.time()
        return out

    phase("build", build_all)
    rows = phase("a", phase_kernels, dev)
    main_path = phase("b", phase_main_path, dev)
    refs = {}  # the cross-precision checks' CPU f64 runs, by problem
    phase("c", phase_cross_precision, dev, refs)
    new_rows = phase("d", phase_new_kernels, dev, main_path)
    path_launches, sweep_by_variant, backend_runs = phase("e", phase_backends, dev, main_path,
                                                          refs)
    phase("f", phase_pairs, {"bm_k1": main_path["run"], **backend_runs})
    _, ft_rows = phase("g", phase_force_tracking, dev, refs)
    wbc_rows = phase("h", phase_wbc, dev)
    loop_row, _, _ = phase("i", phase_closed_loop, dev)
    trot_row, _, _ = phase("j", phase_trot, dev)
    door_row, _ = phase("k", phase_door, dev)

    on_path = [r for r in rows if r["calls_per_step"]]
    per_step = lambda key: sum(r[key] * r["calls_per_step"] for r in on_path)  # noqa: E731
    kernels = [{
        "name": "spd_solve",
        "route": "cuda",
        "source": "qm_door_torch/csrc/spd_solve.cu",
        "replaces": "qm_door_tpu/ops/pallas_chol.py:103",
        "launches": main_path["run"]["launches"]["K1"],
        "launches_by_variant": main_path["run"]["k1_variants"],
        "max_abs_err": max(r["max_abs_err"] for r in on_path),
        # one SQP step's K1 work: 1 projection solve + 67 gain solves, in
        # chained-call events (ms) and in a CUDA graph (ms_graph); the smem
        # kernel's time for the same work, timed in turns in (a)
        "ms": per_step("ms"),
        "ms_graph": per_step("ms_graph"),
        "ms_smem": per_step("ms_smem"),
        "ms_smem_graph": per_step("ms_smem_graph"),
        "plain_ms": per_step("plain_ms"),
        "bound_ms": per_step("bound_ms"),
        "bound_by": "bytes" if per_step("bytes_ms") >= per_step("ops_ms") else "operations",
        "library_ms": per_step("library_ms"),
        "shapes": rows,
    }]
    for kid, (name, source, replaces) in KERNELS.items():
        r = new_rows[kid]
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            # the launches of its backend's driven run in (e); K1-ll has no caller
            "launches": path_launches.get(kid, 0), "max_abs_err": r["max_abs_err"],
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r.get("library_ms"),
            "rel_err": r["rel_err"],
            "rel_err_plain_f32": r["rel_err_plain_f32"], "bytes": r["bytes"],
            "flops": r["flops"]})
        if kid in LQ_BUILDS:  # (d)'s measuring build in turns and both builds' clocks
            kernels[-1].update({k: r[k] for k in lq_turn_keys(kid)})
        if kid in sweep_by_variant:  # K2, K3c: the (e) run's launches by variant, and (d)'s
            kernels[-1].update({k: r[k] for k in (  # other variant and phase clocks
                "variant", "ms_smem", "ms_turns", "rel_err_smem", "phase_cycles_per_node",
                "phase_clock_build_spills")}, launches_by_variant=sweep_by_variant[kid])
    # (g)'s path, force tracking: K1's reg64 variant on bm_k1's gain solves and
    # K2's reg2 variant on bm_fused, with the launches of (g)'s driven runs
    for r, (name, source, replaces), path in (
            (ft_rows["K1_gain"], ("spd_solve", "qm_door_torch/csrc/spd_solve.cu",
                                  "qm_door_tpu/ops/pallas_chol.py:103"), "force_tracking bm_k1"),
            (ft_rows["K2_nu36"], KERNELS["K2"], "force_tracking bm_fused")):
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "variant": r["variant"], "path": path, "launches": r["launches"],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "rel_err": r["rel_err"], "bytes": r["bytes"], "flops": r["flops"],
            **{k: r[k] for k in ("ms_graph", "ms_smem_graph", "ms_smem", "ms_turns",
                                 "rel_err_smem", "rel_err_k3c", "phase_cycles_per_node",
                                 "blocks_per_sm") if k in r}})
    # (h)'s path, the whole-body cascade: K1 at each of its shapes, with the
    # launches of (h)'s chained ticks
    for r in wbc_rows:
        kernels.append({
            "name": "spd_solve", "route": "cuda", "source": "qm_door_torch/csrc/spd_solve.cu",
            "replaces": "qm_door_tpu/ops/pallas_chol.py:103", "variant": r["variant"],
            "path": f"wbc {r['stack']} {r['kind']}", "shape": r["shape"],
            **{k: r[k] for k in ("launches", "launches_per_tick", "max_abs_err", "ms",
                                 "ms_graph", "plain_ms", "bound_ms", "bound_by", "library_ms",
                                 "bytes", "flops")}})
    # (i)'s path, the batched closed loop: K1 a cycle, with the launches of
    # (i)'s timed cycles
    kernels.append(loop_row)
    # (j)'s path, one robot: K1 an MPC period (a solve and five ticks), with
    # the launches of (j)'s trot window
    kernels.append(trot_row)
    # (k)'s path, the door: K1 an MPC period (a 2-iteration solve and five
    # force-aware ticks), with the launches of (k)'s window
    kernels.append(door_row)
    log(f"total {time.time() - t_start:.1f} s; by phase " + json.dumps(
        {k: round(v, 1) for k, v in seconds.items()}))
    log(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
