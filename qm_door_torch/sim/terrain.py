"""Terrain library for the simulation harness (port of
qm_door_tpu/sim/terrain.py).

Analytic height-field terrains z = h(x, y), selected by a static name; the
parameters are a tensor, so a batch can randomize them. Every function
takes x, y of any shape and broadcasts.
"""
from __future__ import annotations

import math
from functools import lru_cache

import torch


def flat(x, y, params):
    height = params[0]
    return torch.zeros_like(x) + height


def slope(x, y, params):
    """Inclined plane starting at x0: grade per meter in x."""
    x0, grade = params[0], params[1]
    return torch.clamp(x - x0, min=0.0) * grade


def step(x, y, params):
    """Single step of given height at x >= x0 (pallet edge)."""
    x0, height = params[0], params[1]
    return torch.where(x >= x0, height, torch.zeros_like(x))


def stairs(x, y, params):
    """Staircase from x0: rise per tread of depth `run`, up to n steps."""
    x0, run, rise, n = params[0], params[1], params[2], params[3]
    idx = torch.clamp(torch.floor((x - x0) / run) + 1.0, min=torch.zeros_like(n), max=n)
    return idx * rise


def wave(x, y, params):
    """Sinusoidal rubble field (SAR-terrain stand-in)."""
    amp, lx, ly = params[0], params[1], params[2]
    return amp * torch.sin(2 * math.pi * x / lx) * torch.cos(2 * math.pi * y / ly)


TERRAINS = {
    "flat": flat,
    "slope": slope,
    "step": step,
    "stairs": stairs,
    "wave": wave,
}


@lru_cache(maxsize=None)
def _params_on(params: tuple, dtype, device):
    return torch.tensor(params, dtype=dtype, device=device)


def params_tensor(params, like):
    """``params`` (a tuple or a tensor) as a tensor in ``like``'s dtype on its
    device; a tuple's tensor is built once and kept, so a physics step makes
    no host-to-device copy."""
    if isinstance(params, torch.Tensor):
        return params.to(dtype=like.dtype, device=like.device)
    return _params_on(tuple(float(p) for p in params), like.dtype, like.device)


def terrain_height(name: str, x, y, params):
    return TERRAINS[name](x, y, params_tensor(params, x))


def default_params(name: str):
    return {
        "flat": (0.0,),
        "slope": (0.5, 0.15),
        "step": (0.5, 0.1),
        "stairs": (0.5, 0.25, 0.08, 5.0),
        "wave": (0.03, 0.8, 0.9),
    }[name]
