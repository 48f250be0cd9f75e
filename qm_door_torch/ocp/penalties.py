"""Penalty functions with closed-form first/second derivatives (port of
qm_door_tpu/ocp/penalties.py): ocs2 QuadraticPenalty / RelaxedBarrierPenalty.
"""
from __future__ import annotations

import math

import torch


def quadratic(h, mu):
    """p(h) = mu/2 h^2 (ocs2 QuadraticPenalty)."""
    return 0.5 * mu * h * h


def relaxed_barrier(h, mu, delta):
    """ocs2 RelaxedBarrierPenalty:
    p(h) = -mu ln(h)                     for h >= delta
         = mu [ -ln(delta) + 1/2 ((h-2d)/d)^2 - 1/2 ]   for h < delta
    """
    safe_h = torch.clamp(h, min=delta)
    log_branch = -mu * torch.log(safe_h)
    z = (h - 2.0 * delta) / delta
    quad_branch = mu * (-math.log(delta) + 0.5 * z * z - 0.5)
    return torch.where(h >= delta, log_branch, quad_branch)


def relaxed_barrier_d(h, mu, delta):
    safe_h = torch.clamp(h, min=delta)
    return torch.where(h >= delta, -mu / safe_h, mu * (h - 2.0 * delta) / (delta * delta))


def relaxed_barrier_dd(h, mu, delta):
    safe_h = torch.clamp(h, min=delta)
    return torch.where(h >= delta, mu / (safe_h * safe_h),
                       torch.full_like(h, mu / (delta * delta)))


def box_barrier(z, lower, upper, mu, delta):
    """Soft box: p(upper - z) + p(z - lower) with relaxed barriers
    (ocs2 StateInputSoftBoxConstraint)."""
    return relaxed_barrier(upper - z, mu, delta) + relaxed_barrier(z - lower, mu, delta)


def box_barrier_d(z, lower, upper, mu, delta):
    return -relaxed_barrier_d(upper - z, mu, delta) + relaxed_barrier_d(z - lower, mu, delta)


def box_barrier_dd(z, lower, upper, mu, delta):
    return relaxed_barrier_dd(upper - z, mu, delta) + relaxed_barrier_dd(z - lower, mu, delta)
