#!/usr/bin/env python3
"""The door of the torch port on one NVIDIA GPU: scenarios.make_scenario's
push door (or pull door) at full width in f32, every part timed, held to
the assertions of tests/test_door_golden.py that the window reaches.

    python3 door_run.py [--duration S] [--pull]

Builds K1 (qm_door_torch/csrc/spd_solve.cu), then runs DoorOpeningRunner
(AlienGo+Z1, default_config() with the legs and the arm commanded from
t = 0, N = 67, DoorScenario() or PULL_SCENARIO) for S seconds (default
1.2: the push needs t >= 0.8 s and the latch released) with every coupled
physics step, tick and solve timed between synchronizes (chip_smoke.py's
run_timed) and K1 counted exactly (chip_smoke.DOOR_SOLVE_K1 a solve,
DOOR_TICK_K1 a tick). Held, as tests/test_door_golden.py holds its 11 s
window, as far as this window reaches: every tick safe and finite, the
attitude (roll, pitch) within 0.75 rad, the last tick's base height above
0.15 m (the lowest is printed), the median MPC violation under 1e-3 in
each of press and push that the window reaches, and the lever past the
latch once the push is reached. Prints the
phases reached, the lever and panel minima, host ms a step, a tick and a
solve, and the wall time the golden's 11 s window would take at those
times; then the card's name and power limit, then one JSON line with the
result. Exits non-zero on any failure.
"""
import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import chip_smoke  # noqa: E402

GOLDEN_SECONDS = 11.0  # tests/test_door_golden.py's window
ATTITUDE_MAX = 0.75    # rad, |roll|, |pitch| over the window
HEIGHT_MIN = 0.15      # m, the base height
PHASE_VIOLATION_MAX = 1e-3  # median MPC violation in press and in push


def door_checks(log_, latch_release):
    """The golden's assertions on the part of the run the window reached:
    {name: (value, bar, held)}, the phases reached in order with the time of
    the first solve in each, and the lever's, the panel's and the base
    height's minima."""
    base = np.stack(log_.base_pose)
    viol, phases = np.asarray(log_.mpc_viol), np.asarray(log_.mpc_phase)
    lever, panel = np.asarray(log_.lever), np.asarray(log_.panel)
    checks = {
        "safe": (bool(log_.safe), True, bool(log_.safe)),
        "finite": (bool(np.isfinite(base).all()), True, bool(np.isfinite(base).all())),
        "attitude_max_rad": (float(np.abs(base[:, 4:6]).max()), ATTITUDE_MAX,
                             bool(np.abs(base[:, 4:6]).max() < ATTITUDE_MAX)),
        "base_height_last_m": (float(base[-1, 2]), HEIGHT_MIN, bool(base[-1, 2] > HEIGHT_MIN)),
    }
    for ph in ("press", "push"):
        if (phases == ph).any():
            med = float(np.median(viol[phases == ph]))
            checks[f"median_violation_{ph}"] = (med, PHASE_VIOLATION_MAX,
                                                bool(med < PHASE_VIOLATION_MAX))
    if (phases == "push").any():
        checks["lever_min"] = (float(lever.min()), latch_release,
                               bool(lever.min() < latch_release))
    mpc_t = np.asarray(log_.mpc_t)
    reached = {str(ph): float(mpc_t[i]) for i, ph in enumerate(phases) if ph not in phases[:i]}
    return checks, reached, float(lever.min()), float(panel.min()), float(base[:, 2].min())


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--duration", type=float, default=1.2,
                        help="seconds of the scenario to run (default 1.2)")
    parser.add_argument("--pull", action="store_true", help="the pull door")
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("door_run: no CUDA device available", file=sys.stderr)
        return 2
    import qm_door_torch  # noqa: F401  (pins full-f32 matmuls)
    from qm_door_torch.models.model import aliengo_z1
    from qm_door_torch.ops import cuda_build
    from qm_door_torch.scenarios import make_scenario
    from qm_door_torch.sim import door_loop

    t0 = time.time()
    for line in cuda_build.build("spd_solve", ()).splitlines():
        chip_smoke.log(f"nvcc spd_solve: {line}")
    dev = torch.device("cuda", 0)
    name = "pull_door" if args.pull else "push_door"
    runner, _ = make_scenario(name, model=aliengo_z1(dtype=torch.float32, device=dev))
    log_, result, _, by_shape = chip_smoke.run_timed(
        runner, lambda: runner.run(duration=args.duration), (door_loop, "coupled_step"),
        profile_at=(-1, -1), record_at=(-1, -1))
    chip_smoke.check_trot_launches(result, by_shape, f"door_run {name}",
                                   chip_smoke.DOOR_SOLVE_K1, chip_smoke.DOOR_TICK_K1)
    checks, reached, lever_min, panel_min, height_min = door_checks(
        log_, runner.door_cfg.latch_release)
    med = result["host_ms_median"]
    # the golden's window: 11,000 physics steps, 5,500 ticks, 1,100 solves
    # after the two at t = 0
    steps = int(round(GOLDEN_SECONDS / runner.sim_cfg.dt))
    estimate_s = 1e-3 * (steps * med["step"] + steps // runner.control_decimation * med["tick"]
                         + (steps // runner.mpc_decimation + 1) * med["solve"])
    out = {"ok": all(held for _, _, held in checks.values()), "scenario": name,
           "duration_s": args.duration, "phases_reached": reached, "lever_min": lever_min,
           "panel_min": panel_min, "base_height_min_m": height_min,
           "latch_release": runner.door_cfg.latch_release,
           "checks": checks, "wall_s": result["wall_s"], "ticks": result["ticks"],
           "solves": result["solves"], "steps": result["steps"], "host_ms_median": med,
           "host_ms_mean": result["host_ms_mean"], "host_ms_max": result["host_ms_max"],
           "over_period": result["over_period"], "golden_11s_estimate_s": estimate_s,
           "k1_launches": result["launches"]["K1"], "k1_by_variant": result["k1_by_variant"],
           "k1_by_shape": result["k1_by_shape"], "mpc_viol_max": result["mpc_viol_max"],
           "device": torch.cuda.get_device_name(0)}
    chip_smoke.log(f"total {time.time() - t0:.1f} s")
    chip_smoke.log(chip_smoke.card_line())
    print(json.dumps(out))
    return 0 if out["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
