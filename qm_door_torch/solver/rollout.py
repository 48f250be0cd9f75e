"""Nonlinear rollout integrators (port of qm_door_tpu/solver/rollout.py;
the TimeTriggeredRollout / ODE45 role).

The reference forward-simulates the centroidal flow map with an adaptive
RK45 integrator for MRT policy rollouts (qm_interface/src/QMInterface.cpp:137).
As in the JAX package: fixed-step RK4, and a fixed-step embedded
Dormand-Prince RK45 that reports its error estimate (no step rejection).
JAX's ``lax.scan`` over the intervals and substeps is a Python loop over
N x substeps. States and inputs may carry leading batch dims.
"""
from __future__ import annotations

import torch

from ..models import centroidal
from ..models.model import RobotModel

METHODS = ("rk4", "rk45")


def rk4_step(model: RobotModel, x, u, dt):
    def f(x_):
        return centroidal.flow_map(model, x_, u)

    k1 = f(x)
    k2 = f(x + 0.5 * dt * k1)
    k3 = f(x + 0.5 * dt * k2)
    k4 = f(x + dt * k3)
    return x + dt / 6.0 * (k1 + 2 * k2 + 2 * k3 + k4)


def rk45_step(model: RobotModel, x, u, dt):
    """One Dormand-Prince step; returns (x5, ||x5 - x4|| over the last axis)."""
    def f(x_):
        return centroidal.flow_map(model, x_, u)

    k1 = f(x)
    k2 = f(x + dt * (1 / 5) * k1)
    k3 = f(x + dt * (3 / 40 * k1 + 9 / 40 * k2))
    k4 = f(x + dt * (44 / 45 * k1 - 56 / 15 * k2 + 32 / 9 * k3))
    k5 = f(x + dt * (19372 / 6561 * k1 - 25360 / 2187 * k2 + 64448 / 6561 * k3
                     - 212 / 729 * k4))
    k6 = f(x + dt * (9017 / 3168 * k1 - 355 / 33 * k2 + 46732 / 5247 * k3 + 49 / 176 * k4
                     - 5103 / 18656 * k5))
    x5 = x + dt * (35 / 384 * k1 + 500 / 1113 * k3 + 125 / 192 * k4 - 2187 / 6784 * k5
                   + 11 / 84 * k6)
    k7 = f(x5)
    x4 = x + dt * (5179 / 57600 * k1 + 7571 / 16695 * k3 + 393 / 640 * k4
                   - 92097 / 339200 * k5 + 187 / 2100 * k6 + 1 / 40 * k7)
    return x5, torch.linalg.vector_norm(x5 - x4, dim=-1)


def rollout(model: RobotModel, x0, U, dt, substeps: int = 1, method: str = "rk4"):
    """Integrate x0 (..., 30) through the inputs U (..., N, 30), each held
    over its interval (zero-order hold), in N * substeps steps of dt /
    substeps. Returns X (..., N+1, 30)."""
    if method not in METHODS:
        raise ValueError(f"method={method!r}: expected one of {METHODS}")
    h = dt / substeps
    xs, x = [x0], x0
    for k in range(U.shape[-2]):
        u = U[..., k, :]
        for _ in range(substeps):
            x = rk4_step(model, x, u, h) if method == "rk4" else rk45_step(model, x, u, h)[0]
        xs.append(x)
    return torch.stack(xs, dim=-2)
