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


def configs(lin_tangents="analytic", quad_only=False):
    from qm_door_torch import config as t_config
    from qm_door_tpu import config as j_config

    name = "quad_only_config" if quad_only else "default_config"
    out = []
    for make in (getattr(j_config, name), getattr(t_config, name)):
        cfg = make()
        cfg.mpc.time_horizon = HORIZON
        cfg.sqp.linesearch_steps = 2
        cfg.sqp.lin_tangents = lin_tangents
        cfg.sqp.sensitivity = "frozen"
        out.append(cfg)
    return out


class Problem:
    """Both packages' model, OCP config, stage data and a perturbed batch."""

    def __init__(self, B=3, seed=3, lin_tangents="analytic", x_scale=0.03, quad_only=False):
        import jax.numpy as jnp
        from qm_door_tpu.models import aliengo_z1, kinematics, spatial
        from qm_door_tpu.ocp.gait import GAIT_LIBRARY, GaitSchedule
        from qm_door_tpu.ocp.problem import build_stage_data, make_ocp_config
        from qm_door_tpu.ocp.reference import TargetTrajectories
        from qm_door_torch import convert
        from qm_door_torch.models.model import aliengo_z1 as t_aliengo_z1
        from qm_door_torch.ocp.problem import make_ocp_config as t_make_ocp_config

        self.jcfg, self.tcfg = configs(lin_tangents, quad_only)
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


GRASP_FROM = 0.06  # s: the short horizon's later nodes grasp
WRENCH_REF = (4.0, 0.0, -9.0, 0.0, 0.0, 0.4)


class ProblemFT(Problem):
    """The force-tracking problem (nu = 36) in both packages: the trot stage
    widened with a grasp from GRASP_FROM on and the wrench reference
    WRENCH_REF, the widened R, and inputs with zero wrench (each package's
    own ocp/force.py builds its side)."""

    def __init__(self, B=2, seed=5, lin_tangents="analytic", x_scale=0.03):
        from qm_door_torch.ocp import force as t_force
        from qm_door_tpu.ocp import force as j_force

        super().__init__(B=B, seed=seed, lin_tangents=lin_tangents, x_scale=x_scale)
        times = np.asarray(self.jstage.times)
        self.grasp = (times >= GRASP_FROM).astype(float)
        self.wref = np.tile(np.asarray(WRENCH_REF), (times.shape[0], 1))
        self.jocp = j_force.make_ocp_config_ft(self.jmodel, self.jcfg)
        self.jstage = j_force.widen_stage_data(self.jstage, self.grasp, self.wref)
        self.tocp = t_force.make_ocp_config_ft(self.tmodel, self.tcfg)
        self.tstage = t_force.widen_stage_data(self.tstage, self.grasp, self.wref)
        self.U = np.concatenate([self.U, np.zeros(self.U.shape[:-1] + (6,))], axis=-1)
