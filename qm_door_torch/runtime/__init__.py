from .mrt import PolicyStore, evaluate_policy
from .safety import safety_check
from .targets import (
    ee_goal_to_target_trajectories,
    cmd_vel_to_target_trajectories,
    ee_cmd_vel_to_target_trajectories,
    initial_target,
)
from .controller import QmController, ControllerConfig
