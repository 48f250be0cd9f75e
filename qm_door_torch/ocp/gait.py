"""Gait schedule machinery: mode sequences, contact flags, timeline compiler.

Replaces ocs2_legged_robot's GaitSchedule / ModeSequenceTemplate /
SwitchedModelReferenceManager / MotionPhaseDefinition (reference call sites:
qm_interface/src/QMInterface.cpp:444-480, gait library data from
qm_controllers/config/gait.info).

Design: the schedule itself is a tiny host-side (numpy) object — gaits change
at command rate, not solve rate. Per MPC solve it is *compiled* into
fixed-shape per-node arrays (``ModeTimeline``) consumed by the jitted solver,
so gait switches never trigger recompilation (contact-dependent constraint
dimensions are handled with masks, not shape changes).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List

import numpy as np

# OCS2 legged-robot mode numbering: 4-bit stance flags in order (LF, RF, LH, RH)
# with LF the most-significant bit.
FLY = 0
STANCE = 15

_MODE_NAMES = {
    0: "FLY", 1: "RH", 2: "LH", 3: "LH_RH", 4: "RF", 5: "RF_RH", 6: "RF_LH",
    7: "RF_LH_RH", 8: "LF", 9: "LF_RH", 10: "LF_LH", 11: "LF_LH_RH",
    12: "LF_RF", 13: "LF_RF_RH", 14: "LF_RF_LH", 15: "STANCE",
}
MODE_BY_NAME = {v: k for k, v in _MODE_NAMES.items()}


def mode_to_flags(mode):
    """Mode number -> (LF, RF, LH, RH) contact flags. Works on arrays."""
    mode = np.asarray(mode)
    return np.stack(
        [(mode >> 3) & 1, (mode >> 2) & 1, (mode >> 1) & 1, mode & 1], axis=-1
    ).astype(np.float64)


def flags_to_mode(flags):
    f = np.asarray(flags).astype(int)
    return (f[..., 0] << 3) | (f[..., 1] << 2) | (f[..., 2] << 1) | f[..., 3]


@dataclass
class ModeSequenceTemplate:
    """A periodic gait: N modes with N+1 switching times (relative)."""

    modes: List[int]
    switching_times: List[float]

    @property
    def duration(self) -> float:
        return self.switching_times[-1] - self.switching_times[0]


# The 12-gait library (data mirror of qm_controllers/config/gait.info).
GAIT_LIBRARY = {
    "stance": ModeSequenceTemplate([STANCE], [0.0, 0.5]),
    "trot": ModeSequenceTemplate(
        [MODE_BY_NAME["LF_RH"], MODE_BY_NAME["RF_LH"]], [0.0, 0.35, 0.70]
    ),
    "standing_trot": ModeSequenceTemplate(
        [MODE_BY_NAME["LF_RH"], STANCE, MODE_BY_NAME["RF_LH"], STANCE],
        [0.0, 0.4, 0.5, 0.9, 1.0],
    ),
    "flying_trot": ModeSequenceTemplate(
        [MODE_BY_NAME["LF_RH"], FLY, MODE_BY_NAME["RF_LH"], FLY],
        [0.0, 0.25, 0.30, 0.55, 0.60],
    ),
    "pace": ModeSequenceTemplate(
        [MODE_BY_NAME["LF_LH"], FLY, MODE_BY_NAME["RF_RH"], FLY],
        [0.0, 0.28, 0.30, 0.58, 0.60],
    ),
    "standing_pace": ModeSequenceTemplate(
        [MODE_BY_NAME["LF_LH"], STANCE, MODE_BY_NAME["RF_RH"], STANCE],
        [0.0, 0.30, 0.35, 0.65, 0.70],
    ),
    "dynamic_walk": ModeSequenceTemplate(
        [
            MODE_BY_NAME["LF_RF_RH"], MODE_BY_NAME["RF_RH"], MODE_BY_NAME["RF_LH_RH"],
            MODE_BY_NAME["LF_RF_LH"], MODE_BY_NAME["LF_LH"], MODE_BY_NAME["LF_LH_RH"],
        ],
        [0.0, 0.2, 0.3, 0.5, 0.7, 0.8, 1.0],
    ),
    "static_walk": ModeSequenceTemplate(
        [
            MODE_BY_NAME["LF_RF_RH"], MODE_BY_NAME["RF_LH_RH"],
            MODE_BY_NAME["LF_RF_LH"], MODE_BY_NAME["LF_LH_RH"],
        ],
        [0.0, 0.3, 0.6, 0.9, 1.2],
    ),
    "amble": ModeSequenceTemplate(
        [
            MODE_BY_NAME["RF_LH"], MODE_BY_NAME["LF_LH"],
            MODE_BY_NAME["LF_RH"], MODE_BY_NAME["RF_RH"],
        ],
        [0.0, 0.15, 0.40, 0.55, 0.80],
    ),
    "lindyhop": ModeSequenceTemplate(
        [
            MODE_BY_NAME["LF_RH"], STANCE, MODE_BY_NAME["RF_LH"], STANCE,
            MODE_BY_NAME["LF_LH"], MODE_BY_NAME["RF_RH"], MODE_BY_NAME["LF_LH"],
            STANCE, MODE_BY_NAME["RF_RH"], MODE_BY_NAME["LF_LH"],
            MODE_BY_NAME["RF_RH"], STANCE,
        ],
        [0.0, 0.35, 0.45, 0.80, 0.90, 1.125, 1.35, 1.70, 1.80, 2.025, 2.25, 2.60, 2.70],
    ),
    "skipping": ModeSequenceTemplate(
        [
            MODE_BY_NAME["LF_RH"], FLY, MODE_BY_NAME["LF_RH"], FLY,
            MODE_BY_NAME["RF_LH"], FLY, MODE_BY_NAME["RF_LH"], FLY,
        ],
        [0.0, 0.27, 0.30, 0.57, 0.60, 0.87, 0.90, 1.17, 1.20],
    ),
    "pawup": ModeSequenceTemplate([MODE_BY_NAME["RF_LH_RH"]], [0.0, 2.0]),
}


@dataclass
class ModeTimeline:
    """Fixed-shape per-solve arrays (leading dim = nodes N+1)."""

    times: np.ndarray          # (N+1,)
    modes: np.ndarray          # (N+1,) int
    contact_flags: np.ndarray  # (N+1, 4) float 0/1


@dataclass
class GaitSchedule:
    """Event-time / mode-sequence schedule with template insertion.

    Mirrors ocs2 GaitSchedule semantics: a stored mode schedule extended on
    demand by tiling the current template; ``insert_template`` trims the
    future schedule and (when switching between different gaits) inserts a
    STANCE phase of ``phase_transition_stance_time``.
    """

    event_times: List[float] = field(default_factory=lambda: [0.4])
    modes: List[int] = field(default_factory=lambda: [STANCE, STANCE])
    template: ModeSequenceTemplate = field(
        default_factory=lambda: ModeSequenceTemplate([STANCE], [0.0, 1.0])
    )
    phase_transition_stance_time: float = 0.1
    _template_applied_up_to: float = field(default=0.0, init=False)

    def _extend_to(self, final_time: float) -> None:
        """Tile the current template until the schedule covers final_time."""
        while (not self.event_times) or self.event_times[-1] < final_time:
            t0 = self.event_times[-1] if self.event_times else 0.0
            st = self.template.switching_times
            for k, mode in enumerate(self.template.modes):
                self.modes.append(mode)
                self.event_times.append(t0 + (st[k + 1] - st[0]))
            # Guard against zero-duration templates.
            if self.template.duration <= 0:
                self.event_times.append(t0 + 1.0)
                break

    def insert_template(
        self, template: ModeSequenceTemplate, start_time: float, final_time: float
    ) -> None:
        """Replace the schedule after ``start_time`` with the new template
        (GaitSchedule::insertModeSequenceTemplate equivalent)."""
        # Trim events strictly after start_time.
        keep = [i for i, t in enumerate(self.event_times) if t <= start_time]
        n = len(keep)
        self.event_times = self.event_times[:n]
        self.modes = self.modes[: n + 1]

        t0 = start_time
        last_mode = self.modes[-1]
        if (
            self.phase_transition_stance_time > 0
            and last_mode != STANCE
            and template.modes[0] != last_mode
        ):
            self.event_times.append(t0)
            self.modes.append(STANCE)
            t0 += self.phase_transition_stance_time
            self.event_times.append(t0)
        else:
            self.event_times.append(t0)
        st = template.switching_times
        for k, mode in enumerate(template.modes):
            self.modes.append(mode)
            self.event_times.append(t0 + (st[k + 1] - st[0]))
        self.template = template
        self._extend_to(final_time)

    def mode_at(self, t: float) -> int:
        self._extend_to(t + 1e-9)
        idx = int(np.searchsorted(np.asarray(self.event_times), t, side="right"))
        return self.modes[min(idx, len(self.modes) - 1)]

    def contact_flags_at(self, t: float) -> np.ndarray:
        return mode_to_flags(self.mode_at(t))

    def compile_timeline(self, t0: float, horizon: float, dt: float) -> ModeTimeline:
        """Sample the schedule on the solver grid -> fixed-shape arrays."""
        n = int(round(horizon / dt))
        times = t0 + dt * np.arange(n + 1)
        self._extend_to(times[-1] + 1e-9)
        ev = np.asarray(self.event_times)
        idx = np.minimum(np.searchsorted(ev, times, side="right"), len(self.modes) - 1)
        modes = np.asarray(self.modes)[idx]
        return ModeTimeline(times=times, modes=modes, contact_flags=mode_to_flags(modes))

    def contact_phases(self, foot: int, t_start: float, t_end: float):
        """List of (t0, t1, in_contact) phases for one foot over a window.

        Used by the swing-trajectory planner; phases are clipped to the window
        except that the final touchdown is extended past t_end so splines have
        a well-defined landing (cf. ``touchdownAfterHorizon``).
        """
        self._extend_to(t_end + 1e-9)
        ev = [t for t in self.event_times]
        bounds = [-np.inf] + ev + [np.inf]
        phases = []
        for i, mode in enumerate(self.modes):
            flag = bool(mode_to_flags(mode)[foot])
            lo, hi = bounds[i], bounds[i + 1]
            if hi <= t_start or lo >= t_end:
                # still record adjacency for merging below
                pass
            if phases and phases[-1][2] == flag:
                phases[-1] = (phases[-1][0], hi, flag)
            else:
                phases.append((lo, hi, flag))
        return phases
