"""Shared set-up of the torch-port parity tests (tests/test_torch_*.py): the
same short-horizon trot problem built in both packages, in float64 on the
CPU, with the JAX objects carried across through qm_door_torch.convert."""
import dataclasses

import numpy as np
import torch

CPU = torch.device("cpu")
F64 = torch.float64
HORIZON = 0.15  # N = 10 nodes at dt 0.015


def as_numpy_fields(obj):
    """A JAX dataclass as a mapping of field name -> numpy array / value."""
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        out[f.name] = v if v is None or isinstance(v, (bool, int, float, str, tuple)) \
            else np.asarray(v)
    return out


def to_np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def configs(lin_tangents="analytic"):
    from qm_door_torch.config import default_config as t_default
    from qm_door_tpu.config import default_config as j_default

    out = []
    for make in (j_default, t_default):
        cfg = make()
        cfg.mpc.time_horizon = HORIZON
        cfg.sqp.linesearch_steps = 2
        cfg.sqp.lin_tangents = lin_tangents
        cfg.sqp.sensitivity = "frozen"
        out.append(cfg)
    return out


class Problem:
    """Both packages' model, OCP config, stage data and a perturbed batch."""

    def __init__(self, B=3, seed=3, lin_tangents="analytic", x_scale=0.03):
        import jax.numpy as jnp
        from qm_door_tpu.models import aliengo_z1, kinematics, spatial
        from qm_door_tpu.ocp.gait import GAIT_LIBRARY, GaitSchedule
        from qm_door_tpu.ocp.problem import build_stage_data, make_ocp_config
        from qm_door_tpu.ocp.reference import TargetTrajectories
        from qm_door_torch import convert
        from qm_door_torch.models.model import aliengo_z1 as t_aliengo_z1
        from qm_door_torch.ocp.problem import make_ocp_config as t_make_ocp_config

        self.jcfg, self.tcfg = configs(lin_tangents)
        self.jmodel = aliengo_z1(dtype=jnp.float64)
        self.jocp = make_ocp_config(self.jmodel, self.jcfg)
        x0 = jnp.asarray(self.jcfg.initial_state())
        R_ee, p_ee = kinematics.ee_pose(self.jmodel, x0[6:30])
        tstate = jnp.concatenate([x0, p_ee, spatial.rot_to_quat(R_ee)])
        self.jtargets = TargetTrajectories.create(
            jnp.array([0.0, 1e5]), jnp.stack([tstate, tstate]), jnp.zeros((2, 30)))
        sched = GaitSchedule()
        sched.insert_template(GAIT_LIBRARY["trot"], 0.0, 5.0)
        self.jstage = build_stage_data(self.jmodel, self.jcfg, sched, self.jtargets, 0.0)

        self.tmodel = t_aliengo_z1(dtype=F64, device="cpu")
        self.tocp = t_make_ocp_config(self.tmodel, self.tcfg)
        self.tstage = convert.stage_data_from_numpy(as_numpy_fields(self.jstage), device="cpu")
        self.ttargets = convert.target_trajectories_from_numpy(
            as_numpy_fields(self.jtargets), device="cpu")

        rng = np.random.default_rng(seed)
        self.N = int(round(HORIZON / self.jcfg.sqp.dt))
        self.xb = np.asarray(x0)[None] + rng.normal(size=(B, 30)) * x_scale
        self.X = np.tile(self.xb[:, None, :], (1, self.N + 1, 1))
        self.U = np.broadcast_to(np.asarray(self.jstage.u_nom[:self.N]), (B, self.N, 30)).copy()

    def t(self, a):
        return torch.tensor(np.asarray(a), dtype=F64)
