"""Asynchronous MPC / control execution, the reference's threading model
(port of qm_door_tpu/runtime/async_runner.py).

QMController spawns a dedicated MPC thread running advanceMpc at 100 Hz
while the 500 Hz ros_control update consumes the latest policy under a
mutex (QMController.cpp:310-335). Here:

- the MPC thread runs the solve and publishes each policy snapshot through
  the native seqlock ``Mailbox`` (wait-free for the solver), as host numpy
  copies: no device tensor crosses the threads;
- on CUDA the MPC thread issues all its device work on a stream of its own
  (``AsyncMpcLoop.stream``), so it does not serialize with the control
  thread's work on the default stream; K1's wrapper launches on the
  calling thread's current stream;
- the control thread paces itself with the native ``PeriodicTimer``, reads
  the newest policy (lock-free) and moves it onto its own device and dtype;
- both sides keep RepeatedTimer stats (the reference's shutdown report).

The solve and the tick are mostly host work (eager PyTorch ops), so the two
Python threads largely take turns on the GIL; ``realtime_run.py`` measures
the solve alone and beside the control thread.
"""
from __future__ import annotations

import contextlib
import pickle
import threading
from typing import Callable, Optional

import numpy as np
import torch

from ..native import Mailbox, PeriodicTimer
from .metrics import Metrics
from .mrt import PolicyStore


def _host(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


class PolicyMailbox:
    """Typed wrapper: PolicyStore snapshots over the byte mailbox."""

    def __init__(self, n_nodes: int, capacity: Optional[int] = None):
        # policy = times (N+1) + X (N+1, 30) + U (N, nu <= 36), 8 bytes at
        # most an element, + the pickle header
        capacity = capacity or (n_nodes * 70 * 8 + 4096)
        self._mb = Mailbox(capacity)

    @staticmethod
    def encode(policy: PolicyStore) -> bytes:
        """The blob of host copies of ``policy`` (device tensors are copied
        on the caller's current stream, which the copy waits for)."""
        return pickle.dumps((_host(policy.times), _host(policy.X), _host(policy.U)),
                            protocol=pickle.HIGHEST_PROTOCOL)

    @staticmethod
    def decode(blob: bytes) -> PolicyStore:
        times, X, U = pickle.loads(blob)
        return PolicyStore(times=times, X=X, U=U)

    def publish(self, policy: PolicyStore) -> int:
        """Publish ``policy`` (:meth:`encode`); returns the sequence number."""
        return self._mb.write(self.encode(policy))

    def latest(self):
        """(seq, PolicyStore of numpy arrays) of the newest publication;
        (0, None) before the first. The caller moves the arrays onto its
        own device and dtype."""
        seq, blob = self._mb.read()
        if seq == 0:
            return 0, None
        return seq, self.decode(blob)


class AsyncMpcLoop:
    """Background MPC thread: ``solve_fn() -> PolicyStore`` at ``mpc_hz``,
    each result published on ``mailbox``. With a CUDA ``device`` the solve
    runs under ``self.stream``, a stream of its own, and is finished
    (the stream synchronized) before it is published. An exception ends
    the thread and is kept in ``self.error``."""

    def __init__(self, solve_fn: Callable[[], PolicyStore], mpc_hz: float,
                 mailbox: PolicyMailbox, metrics: Optional[Metrics] = None, device=None):
        self.solve_fn = solve_fn
        self.mailbox = mailbox
        self.metrics = metrics or Metrics()
        self.period = 1.0 / mpc_hz
        dev = torch.device("cpu" if device is None else device)
        self.stream = torch.cuda.Stream(dev) if dev.type == "cuda" else None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.error: Optional[BaseException] = None

    def context(self):
        """The stream context the solves run in (nothing on the CPU); the
        caller may enter it for a solve made before :meth:`start`."""
        return torch.cuda.stream(self.stream) if self.stream is not None \
            else contextlib.nullcontext()

    def start(self):
        self._thread = threading.Thread(target=self._run, daemon=True, name="mpc")
        self._thread.start()

    def _run(self):
        timer = PeriodicTimer(self.period)
        t = self.metrics.timer("mpc_solve")
        try:
            with self.context():
                while not self._stop.is_set():
                    t.start()
                    policy = self.solve_fn()
                    if self.stream is not None:
                        self.stream.synchronize()
                    t.stop()
                    self.mailbox.publish(policy)
                    self.metrics.count("mpc_solves")
                    timer.wait()
        except BaseException as e:  # the reference's try/catch-and-halt
            self.error = e

    def stop(self, timeout: Optional[float] = None):
        """Ask the thread to stop and wait for it: a solve under way is
        finished and published first."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout)
