"""torch.func's differentiating transforms under one process-wide lock.

PyTorch keeps forward-mode AD levels process-global: ``torch.func.jvp`` (and
``jacfwd``, a vmap of it) enters a dual level on entry and leaves it on exit,
last in first out across every thread. Two threads inside such a transform
at once (the MPC thread's linearization beside the control thread's tick)
tear each other's levels ("no level exists"). Every ``jvp``, ``jacfwd`` and
``jacrev`` of the port goes through these wrappers, which hold one
re-entrant lock (:data:`LOCK`; ``vjp`` is taken under it directly) for the
duration of the call; one thread's transform then waits for the other's.
``vmap`` keeps its levels per thread and needs no lock.
"""
from __future__ import annotations

import threading

import torch

LOCK = threading.RLock()


def jvp(func, primals, tangents, **kwargs):
    """``torch.func.jvp`` under the lock."""
    with LOCK:
        return torch.func.jvp(func, primals, tangents, **kwargs)


def _locked(transform):
    def wrapper(func, *args, **kwargs):
        inner = transform(func, *args, **kwargs)

        def call(*a, **kw):
            with LOCK:
                return inner(*a, **kw)
        return call
    wrapper.__doc__ = f"``torch.func.{transform.__name__}`` whose calls hold the lock."
    return wrapper


jacfwd = _locked(torch.func.jacfwd)
jacrev = _locked(torch.func.jacrev)
