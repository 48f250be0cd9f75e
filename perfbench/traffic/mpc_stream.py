"""Traffic kind ``mpc_stream``: the 100 Hz re-solve stream of a scenario
farm, the MPC half of a batched closed loop without the physics.

Every step re-solves all B scenarios in lock-step:

1. the stage moves one MPC period forward (the next phase of the ring of
   stage data the system built in set-up; per scenario, phase
   (k + stride * s) mod L when ``scenario_phase_stride`` is not 0);
2. the previous solution is shifted onto the new grid (``warm_start``);
3. x_init = the shifted prediction's first node + Gaussian noise with the
   standard deviation ``state_noise`` (a number, or a list of one a state
   row): how far the measured state lies from the prediction one period
   on, in a closed loop under the farm's disturbances;
4. the system solves (one SQP iteration).

The first step starts cold from the configuration's initial state with a
spread of ``initial_spread`` a row. All randomness comes from one
generator on the system's device, seeded with the run's seed.
"""
from __future__ import annotations

import torch


class Stream:
    def __init__(self, system, cfg, params, seed):
        self.system = system
        self.B = cfg["batch"]
        self.L = cfg["gait"]["ring_length"]
        self.stride = params["scenario_phase_stride"]
        dev, dtype = system.device, system.dtype
        # one standard deviation for every row, or one a state row
        self.noise = torch.as_tensor(params["state_noise"], dtype=dtype, device=dev)
        self.gen = torch.Generator(device=dev)
        self.gen.manual_seed(seed)
        self.scenario = torch.arange(self.B, device=dev)
        self.k = 0
        x0 = torch.tensor(cfg["initial_state"], dtype=dtype, device=dev)
        self._x_first = x0 + cfg["initial_spread"] * self._randn()

    def _randn(self):
        return torch.randn((self.B, 30), generator=self.gen, device=self.system.device,
                           dtype=self.system.dtype)

    def phases(self):
        """The ring phase of the current step: an int shared by every
        scenario, or (B,) per scenario."""
        if self.stride == 0:
            return self.k % self.L
        return (self.k + self.stride * self.scenario) % self.L

    def first(self):
        """(phases, x_init, X, U) of the cold first step."""
        phases = self.phases()
        stage = self.system.stage_for(phases)
        X, U = self.system.cold_start(stage, self._x_first)
        return phases, self._x_first, X, U

    def next(self, X, U):
        """(phases, x_init, X, U) of the next step from the last solution."""
        self.k += 1
        Xw, Uw = self.system.warm_start(X, U)
        x_init = Xw[:, 0] + self.noise * self._randn()
        Xw[:, 0] = x_init
        return self.phases(), x_init, Xw, Uw
