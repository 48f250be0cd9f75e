"""The port's host-runtime library (qm_door_torch/native), built from its
own copy of qm_native.cpp: where it is built, that it loads nothing of the
JAX package, the mailbox's round trip and sequence numbers against the JAX
package's mailbox, no torn reads, the timer's rate and its overrun rule,
the pure-Python twins held to the same contracts, and a failed build
raising."""
import os
import threading
import time

import pytest

from qm_door_torch import native
from qm_door_torch.utils import compile_cache

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MAILBOXES = {"native": native.Mailbox, "plain": native.MailboxPlain}
TIMERS = {"native": native.PeriodicTimer, "plain": native.PeriodicTimerPlain}


def test_library_is_built_from_the_ports_source_into_build():
    lib = native.load()
    path = native.library_path()
    assert os.path.exists(path) and lib._name == path
    assert path.startswith(os.path.join(ROOT, "build", "qm_door_torch", "libqm_native-"))
    assert native.SRC == os.path.join(ROOT, "qm_door_torch", "native", "src", "qm_native.cpp")
    with open(native.SRC, "rb") as ours, open(os.path.join(
            ROOT, "qm_door_tpu", "native", "src", "qm_native.cpp"), "rb") as theirs:
        assert ours.read() == theirs.read()


@pytest.mark.parametrize("kind", list(MAILBOXES))
def test_mailbox_round_trip(kind):
    mb = MAILBOXES[kind](256)
    assert mb.read() == (0, b"")
    s = mb.write(b"abc")
    assert s == 2 and mb.read() == (s, b"abc")
    s2 = mb.write(b"defg")
    assert s2 == s + 2 and mb.read() == (s2, b"defg")
    assert mb.write(b"") == s2 + 2 and mb.read() == (s2 + 2, b"")
    with pytest.raises(ValueError, match="capacity"):
        mb.write(bytes(257))


def test_mailbox_matches_the_jax_packages():
    from qm_door_tpu.native import Mailbox as JMailbox

    ours, theirs = native.Mailbox(4096), JMailbox(4096)
    assert ours.read() == theirs.read()
    for i in range(20):
        blob = bytes([i]) * (i * 37)
        assert ours.write(blob) == theirs.write(blob)
        assert ours.read() == theirs.read()


@pytest.mark.parametrize("kind", list(MAILBOXES))
def test_mailbox_no_torn_reads(kind):
    mb = MAILBOXES[kind](4096)
    payloads = [bytes([i % 256]) * (1024 + i) for i in range(500)]
    seqs = []

    def writer():
        for p in payloads:
            mb.write(p)

    t = threading.Thread(target=writer)
    t.start()
    while t.is_alive():
        seq, blob = mb.read()
        if seq:
            i = seq // 2 - 1
            assert blob == payloads[i], "torn read"
            seqs.append(seq)
    t.join()
    assert seqs == sorted(seqs)
    assert mb.read() == (2 * len(payloads), payloads[-1])


@pytest.mark.parametrize("kind", list(TIMERS))
def test_timer_rate(kind):
    pt = TIMERS[kind](0.002)
    t0 = time.monotonic()
    for _ in range(25):
        pt.wait()
    elapsed = time.monotonic() - t0
    assert 0.045 < elapsed < 0.30
    assert pt.ticks == 25


@pytest.mark.parametrize("kind", list(TIMERS))
def test_timer_skips_and_counts_overruns(kind):
    """A deadline missed by more than a period is skipped and counted; the
    clock then restarts from the late wake-up, so the next tick is on time."""
    pt = TIMERS[kind](0.005)
    pt.wait()
    time.sleep(0.02)                   # ~3 periods late
    lag = pt.wait()
    assert pt.overruns == 1 and lag > 0.005
    t0 = time.monotonic()
    pt.wait()                          # on the new grid: it sleeps about a period
    assert 0.004 < time.monotonic() - t0 < 0.1
    assert pt.overruns == 1 and pt.ticks == 3


def test_a_failed_build_raises(tmp_path, monkeypatch):
    bad = tmp_path / "qm_native.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SRC", str(bad))
    monkeypatch.setattr(compile_cache, "_dir", str(tmp_path / "build"))
    with pytest.raises(RuntimeError, match="g\\+\\+ exited"):
        native.build()
