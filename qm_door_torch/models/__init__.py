from .model import (
    RobotModel,
    load_model,
    aliengo_z1,
    JOINT_NAMES,
    CONTACT_FRAMES,
    NUM_JOINTS,
    NUM_CONTACTS,
    NQ,
    NV,
    STATE_DIM,
    INPUT_DIM,
    GRAVITY,
)
from . import spatial
