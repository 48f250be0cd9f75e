"""The comparison that decides ``correct``: what the timed path produced on a
sample of its solves against the plain reference (``reference/``) on the
same inputs.

For each sampled solve (one scenario of one window step) the reference
takes the inputs the program took (x_init, the warm iterate X, U, the ring
phase), works out the stage data again from the configuration, and
computes the step dX, dU, the baseline merit and the merit of every
linesearch candidate in float64. The numbers compared, each the largest
over the sample:

- ``du_rel``: the gap between the program's input step (U_out - U) and
  alpha times the reference's, as a share of the reference's (infinity
  norms), alpha the program's step size (the state step's gap, which the
  float32 control does not separate from the program's bf16 sweeps, is
  not compared: see PERF.md);
- ``cost_rel`` / ``viol_rel``: the gap between the merit the program
  reports (cost, violation) and the reference's merit of the program's
  own output trajectory, as a share of the cost's scale (the reference's
  cost with each barrier term by its absolute value: the barriers are
  negative far from their bounds and the cost can sum to near 0) and of
  the reference's violation (g_min its least denominator);
- ``alpha_bad``: solves whose step size the reference's filter linesearch
  refutes, its merit taken along the program's own step: a larger
  candidate it surely accepts, or the one taken that it surely rejects
  (where the program took no step, the candidates lie along the
  reference's step). "Surely" is outside the cost and violation limits,
  since a merit inside them cannot tell the decision.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from .reference import model as rb
from .reference import ocp as rocp
from .reference import solve as rsolve

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NUMBERS = ("du_rel", "cost_rel", "viol_rel", "alpha_bad")


class Reference:
    """The reference set up for one configuration: the model, the weights
    and the stage data of each ring phase, on ``device`` in ``dtype``."""

    def __init__(self, cfg, device, dtype=torch.float64):
        self.cfg, self.device, self.dtype = cfg, device, dtype
        self.model = rb.load(os.path.join(ROOT, cfg["model_file"]), dtype=dtype, device=device)
        self.weights = rocp.weights(cfg, self.model)
        self._stages = {}

    def stage(self, phase: int):
        if phase not in self._stages:
            g = self.cfg["gait"]
            t0 = g["ring_start_s"] + phase / self.cfg["mpc_frequency_hz"]
            self._stages[phase] = rocp.stage(self.cfg, self.model, t0)
        return self._stages[phase]

    def _stacked(self, phases):
        sts = [self.stage(int(p)) for p in phases]
        return {k: torch.stack([s[k] for s in sts]) for k in sts[0]}

    def _cast(self, t):
        return t.to(device=self.device, dtype=self.dtype)

    def iteration(self, phases, x_init, X, U, candidates=False):
        """rsolve.iteration on S scenarios at their ring phases (S,)."""
        return rsolve.iteration(self.model, self.weights, self.cfg, self._stacked(phases),
                                self._cast(x_init), self._cast(X), self._cast(U), candidates)

    def merit(self, phases, X, U, magnitude=False):
        """(cost, violation) of S trajectories at their ring phases."""
        return rsolve.merit(self.model, self.weights, self.cfg["sqp"]["dt"],
                            self._stacked(phases), self._cast(X), self._cast(U), magnitude)


def _lt(a, b, scale, tol):
    """a < b as True (1), False (0) or unknown (0.5): unknown within
    tol * scale of the boundary."""
    sure_true = a < b - tol * scale
    sure_false = a > b + tol * scale
    return torch.where(sure_true, 1.0, torch.where(sure_false, 0.0, 0.5))


def _and(p, q):
    return torch.minimum(p, q)


def _or(p, q):
    return torch.maximum(p, q)


def _pick(cond, p, q):
    """where(cond, p, q) for a three-valued cond: unknown is either."""
    return torch.where(cond == 1.0, p, torch.where(cond == 0.0, q,
                                                   torch.where(p == q, p, 0.5)))


def accepts(cfg, cost0, viol0, cost, viol, alpha, tc, tv, cost_scale=None):
    """The filter linesearch's acceptance of a trial, three-valued: an
    infeasible baseline (viol0 > g_max) needs a violation decrease, a
    feasible one (viol0 < g_min) a cost decrease with the violation below
    max(2 viol0, g_max), anything between either. Unknown within tc of
    ``cost_scale`` (|cost0| by default) and tv of viol0 of a boundary."""
    s = cfg["sqp"]
    g_max, g_min = s["g_max"], s["g_min"]
    dec_viol = _lt(viol, (1.0 - 1e-3) * viol0, viol0, tv)
    dec_cost = _lt(cost, cost0 - s["armijo_factor"] * alpha * torch.abs(cost0),
                   torch.abs(cost0) if cost_scale is None else cost_scale, tc)
    feasible = _and(dec_cost, _lt(viol, torch.clamp(2 * viol0, min=g_max), viol0, tv))
    ok = _pick(_lt(torch.full_like(viol0, g_max), viol0, viol0, tv), dec_viol,
               _pick(_lt(viol0, torch.full_like(viol0, g_min), viol0, tv), feasible,
                     _or(dec_cost, dec_viol)))
    finite = torch.isfinite(cost) & torch.isfinite(viol)
    return torch.where(finite, ok, 0.0)


def compare(cfg, limits, ref, r, out):
    """The numbers of one group of sampled solves: ``r`` the reference's
    iteration on their inputs, ``out`` the inputs and the program's
    outputs. Returns {number: largest value over the group}."""
    f64 = lambda t: t.to(device=r["dX"].device, dtype=torch.float64)  # noqa: E731
    X, U, Xo, Uo = (f64(out[k]) for k in ("X_in", "U_in", "X_out", "U_out"))
    alpha = f64(out["alpha"])
    cost, viol = f64(out["cost"]), f64(out["viol"])
    a = alpha[:, None, None]
    step = lambda d: torch.amax(torch.abs(d), dim=(1, 2))  # noqa: E731
    du = step(Uo - U - a * r["dU"]) / torch.clamp(alpha * step(r["dU"]), min=1e-9)
    # the merit the program reports against the reference's at the same
    # trajectory, and each candidate's trial along the program's own step
    # (the reference's where the program took none), in one evaluation
    taken = alpha > 0
    sx = torch.where(taken[:, None, None], (Xo - X) / torch.clamp(a, min=1e-30), r["dX"])
    su = torch.where(taken[:, None, None], (Uo - U) / torch.clamp(a, min=1e-30), r["dU"])
    L = len(r["alphas"])
    costs, viols = ref.merit(np.tile(out["phases"], L + 1),
                             torch.cat([Xo] + [X + ai * sx for ai in r["alphas"]]),
                             torch.cat([Uo] + [U + ai * su for ai in r["alphas"]]))
    costs, viols = costs.reshape(L + 1, -1), viols.reshape(L + 1, -1)
    scale, scale0 = ref.merit(np.tile(out["phases"], 2), torch.cat([Xo, X]), torch.cat([Uo, U]),
                              magnitude=True)[0].reshape(2, -1)
    g_min = cfg["sqp"]["g_min"]
    cost_rel = torch.abs(cost - costs[0]) / scale
    viol_rel = torch.abs(viol - viols[0]) / torch.clamp(viols[0], min=g_min)
    on_grid = alpha == 0
    bad = torch.zeros_like(taken)
    for i, ai in enumerate(r["alphas"]):
        at = torch.isclose(alpha, torch.full_like(alpha, ai))
        on_grid |= at
        acc = accepts(cfg, r["cost0"], r["viol0"], costs[i + 1], viols[i + 1], ai,
                      limits["cost_rel"], limits["viol_rel"], scale0)
        bad |= (alpha < ai) & (acc == 1.0)      # a larger step it surely accepts
        bad |= at & (acc == 0.0)                # the step taken, surely rejected
    bad |= ~on_grid
    vals = dict(du_rel=du, cost_rel=cost_rel, viol_rel=viol_rel)
    res = {k: float(torch.nan_to_num(v, nan=float("inf")).max()) for k, v in vals.items()}
    res["alpha_bad"] = float(bad.sum())
    return res


def judge(cfg, limits, samples, device, dtype=torch.float64):
    """Hold every group of ``samples`` (dicts of the sampled solves' inputs
    and outputs, one a window step) to the reference. Returns
    ({number: value}, correct)."""
    ref = Reference(cfg, device, dtype)
    worst = {k: 0.0 for k in NUMBERS}
    for group in samples:
        r = ref.iteration(group["phases"], group["x_init"], group["X_in"], group["U_in"])
        for k, v in compare(cfg, limits, ref, r, group).items():
            worst[k] = worst[k] + v if k == "alpha_bad" else max(worst[k], v)
    correct = all(worst[k] <= limits[k] for k in NUMBERS)
    return worst, correct
