"""qm_door_torch — the PyTorch/CUDA port of qm_door_tpu.

The same centroidal NMPC for the AlienGo + Z1 quadruped manipulator, on an
NVIDIA H100: plain tensor code in PyTorch, and every kernel that qm_door_tpu
writes in Pallas written by hand for Hopper (``csrc/``). Module names mirror
qm_door_tpu's so each counterpart is easy to find; qm_door_tpu stays the
reference that ``tests/test_torch_*.py`` hold this package against.

- ``models``   : RobotModel, spatial algebra, kinematics, CMM, centroidal flow map.
- ``ocp``      : costs, penalties, constraints, gait/swing, stage data.
- ``solver``   : batched SQP iteration (linearize -> project -> Riccati -> linesearch).
- ``parallel`` : BatchedMpc, B scenarios in lock-step.
- ``ops``      : hand-written CUDA kernels with their plain torch versions.
- ``convert``  : JAX-package objects (as numpy) -> this package's objects.

Importing the package pins full-f32 matmuls (no TF32): reduced-precision
operands break the Riccati/Cholesky chain, as in qm_door_tpu/__init__.py.
"""
import torch

__version__ = "0.1.0"


def set_full_f32_matmuls() -> None:
    """Run every f32 matmul and convolution in true f32 (TF32 off)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


set_full_f32_matmuls()
