from .mrt import PolicyStore, evaluate_policy
from .safety import safety_check
from .controller import QmController, ControllerConfig
