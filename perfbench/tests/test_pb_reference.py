"""The plain reference against the port's CPU path in float64, with the
exact linearization (``analytic``): the stage data of every ring phase and
three steps of the stream at B = 4, for both configurations."""
import json
import os

import pytest
import torch

from perfbench import harness
from perfbench.correct import Reference
from perfbench.system import System

CONFIGS = ("aliengo-z1-trot", "aliengo-z1-door-press")


def config(name):
    with open(os.path.join(harness.ROOT, "perfbench", "configs", f"{name}.json")) as f:
        cfg = json.load(f)
    cfg["sqp"]["lin_tangents"] = "analytic"  # exact tangents: the f64 semantics
    cfg["batch"] = 4
    return cfg


@pytest.mark.parametrize("name", CONFIGS)
def test_stage_data_of_every_ring_phase(name):
    cfg = config(name)
    system = System(cfg, torch.device("cpu"), torch.float64)
    ref = Reference(cfg, "cpu")
    for phase, stage in enumerate(system.ring):
        st = ref.stage(phase)
        assert torch.equal(st["flags"], stage.contact_flags)
        torch.testing.assert_close(st["z_vel"], stage.z_vel_ref, rtol=0, atol=1e-12)
        torch.testing.assert_close(st["u_nom"], stage.u_nom, rtol=0, atol=1e-9)
        torch.testing.assert_close(st["ee_pos"].expand_as(stage.ee_pos_ref), stage.ee_pos_ref,
                                   rtol=0, atol=1e-12)


@pytest.mark.parametrize("name", CONFIGS)
def test_three_stream_steps(name):
    cfg = config(name)
    traffic = harness.load_json("perfbench/traffic/mpc_stream.json")
    system = System(cfg, torch.device("cpu"), torch.float64)
    stream = harness.generator(traffic["kind"]).Stream(system, cfg, traffic, 2 ** 31 + 11)
    ref = Reference(cfg, "cpu")
    phases, x_init, X, U = stream.first()
    for _ in range(3):
        Xo, Uo, (cost, viol, alpha) = system.step(system.stage_for(phases), x_init, X, U)
        r = ref.iteration([phases] * 4, x_init, X, U, candidates=True)
        a = alpha[:, None, None]
        for out, inp, d in ((Xo, X, r["dX"]), (Uo, U, r["dU"])):
            gap = torch.amax(torch.abs(out - inp - a * d), dim=(1, 2))
            assert torch.all(gap <= 1e-8 * torch.amax(torch.abs(d), dim=(1, 2))), gap
        assert torch.all(alpha == 1.0)
        torch.testing.assert_close(cost, r["costs"][:, 0], rtol=1e-9, atol=0)
        torch.testing.assert_close(viol, r["viols"][:, 0], rtol=1e-7, atol=1e-14)
        phases, x_init, X, U = stream.next(Xo, Uo)
