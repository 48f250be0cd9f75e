"""The control on the card: the reference in the program's place, in
float32 with TF32 matmuls, must come out not correct. At B = 128 (the
cells run B = 1024; ``readings.py`` reads the control at that size)."""
import pytest

from perfbench import control, correct, harness


@pytest.mark.gpu
def test_the_control_is_not_correct(cuda_device):
    for seed in (2 ** 31 + 21, 2 ** 31 + 22, 2 ** 31 + 23):
        res = harness.run("trot-farm-b1024", seed, 2.0, False, device=cuda_device, batch=128)
        assert res["correct"], res["checks"]
        ctl = control.outputs(res["cfg"], res["samples"], cuda_device)
        _, ok = correct.judge(res["cfg"], res["cfg"]["limits"], ctl, cuda_device)
        assert not ok
