"""The control of the comparison that decides ``correct``: the reference put
in the program's place and computed one precision below the configuration's
float32 (float32 with TF32 matmuls), on the inputs of the program's sampled
solves. ``readings.py`` holds it to the float64 reference, as a run holds
the program; the comparison has to find it not correct.
"""
from __future__ import annotations

import torch

from .correct import Reference, accepts


def outputs(cfg, groups, device):
    """The control's outputs on each group's inputs: the step taken with
    the largest candidate its own merit accepts, its cost and violation."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    torch.set_float32_matmul_precision("high")
    try:
        ref = Reference(cfg, device, torch.float32)
        out = []
        for g in groups:
            r = ref.iteration(g["phases"], g["x_init"], g["X_in"], g["U_in"], candidates=True)
            S = r["dX"].shape[0]
            alpha = torch.zeros(S, dtype=torch.float32, device=r["dX"].device)
            cost, viol = r["cost0"].clone(), r["viol0"].clone()
            for i in reversed(range(len(r["alphas"]))):
                ok = accepts(cfg, r["cost0"], r["viol0"], r["costs"][:, i], r["viols"][:, i],
                             r["alphas"][i], 0.0, 0.0) == 1.0
                alpha = torch.where(ok, r["alphas"][i], alpha)
                cost = torch.where(ok, r["costs"][:, i], cost)
                viol = torch.where(ok, r["viols"][:, i], viol)
            X = g["X_in"].to(r["dX"]) + alpha[:, None, None] * r["dX"]
            X[:, 0] = g["x_init"].to(X)
            U = g["U_in"].to(r["dU"]) + alpha[:, None, None] * r["dU"]
            out.append({**g, "X_out": X.cpu(), "U_out": U.cpu(), "cost": cost.cpu(),
                        "viol": viol.cpu(), "alpha": alpha.cpu()})
        return out
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved[0]
        torch.backends.cudnn.allow_tf32 = saved[1]
        torch.set_float32_matmul_precision(saved[2])
