"""Device choice for the port's entry points: CUDA unless the caller asks
for the CPU, and never a silent fallback to the CPU."""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> the current CUDA device; raises if CUDA is absent.

    An explicit ``"cpu"`` (or ``torch.device("cpu")``) is honoured; an
    explicit CUDA device is checked for availability.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "qm_door_torch runs on CUDA by default and no CUDA device is "
            "available; pass device='cpu' to run on the CPU")
    return dev


def resolve_precision(device=None):
    """(device, dtype) of an example run: CUDA in float32 unless the caller
    asks for the CPU, which runs in float64 (the JAX package's reference
    precision). Raises as :func:`resolve_device` does."""
    dev = resolve_device(device)
    return dev, torch.float64 if dev.type == "cpu" else torch.float32
