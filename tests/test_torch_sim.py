"""The simulation harness and the policy bridge, torch port against the JAX
package, float64 on the CPU: the five terrains (sim/terrain.py) at 1e-12;
sim_step over 10 chained steps at B = 3 (sim/sim.py: contacts on and off,
the stiction anchor, an external wrench and tau_gen_extra, the 9 ms delay
ring full and wrapping) at 1e-9 (rtol = atol) on q, v, the ring and the
anchors; the wall-contact query (sim/world.py) on a maze mesh at 1e-9 (and sim_step's
wall term against it, port against port);
evaluate_policy (runtime/mrt.py) inside the horizon and past both ends,
and safety_check (runtime/safety.py) on both sides of +-pi/2, exactly or
at 1e-12; and the convert.py carriers of SimConfig, SimState and
WorldMesh."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qm_door_torch import convert
from qm_door_torch.models.model import aliengo_z1 as t_aliengo_z1
from qm_door_torch.runtime import mrt as t_mrt
from qm_door_torch.runtime import safety as t_safety
from qm_door_torch.sim import sim as t_sim
from qm_door_torch.sim import terrain as t_terrain
from qm_door_torch.sim import world as t_world
from qm_door_tpu.config import default_config
from qm_door_tpu.models import aliengo_z1 as j_aliengo_z1
from qm_door_tpu.models import centroidal as j_cen
from qm_door_tpu.models import kinematics as j_kin
from qm_door_tpu.runtime import mrt as j_mrt
from qm_door_tpu.runtime import safety as j_safety
from qm_door_tpu.sim import sim as j_sim
from qm_door_tpu.sim import terrain as j_terrain
from qm_door_tpu.sim import world as j_world
from torch_parity import F64, as_numpy_fields, to_np
from torch_parity import release_jax_executables  # noqa: F401 (autouse, module scope)

EXACT = dict(rtol=1e-12, atol=1e-12)
STEP_TOL = dict(rtol=1e-9, atol=1e-9)
STEPS = 10  # > delay_steps + 1: the ring fills and wraps


@pytest.fixture(scope="module")
def models():
    return j_aliengo_z1(dtype=jnp.float64), t_aliengo_z1(dtype=F64, device="cpu")


@pytest.mark.parametrize("name", sorted(j_terrain.TERRAINS))
def test_terrain_height_matches_jax(name):
    rng = np.random.default_rng(len(name))
    x = rng.uniform(-1.0, 3.0, size=(7, 5))
    y = rng.uniform(-1.0, 1.0, size=(7, 5))
    params = j_terrain.default_params(name)
    assert t_terrain.default_params(name) == params
    ref = np.asarray(j_terrain.terrain_height(name, jnp.asarray(x), jnp.asarray(y), params))
    out = t_terrain.terrain_height(name, torch.as_tensor(x), torch.as_tensor(y), params)
    np.testing.assert_allclose(to_np(out), ref, **EXACT)
    # the parameters as a tensor give the same heights
    out_t = t_terrain.terrain_height(name, torch.as_tensor(x), torch.as_tensor(y),
                                     torch.tensor(params, dtype=F64))
    np.testing.assert_array_equal(to_np(out_t), to_np(out))
    assert sorted(t_terrain.TERRAINS) == sorted(j_terrain.TERRAINS)


def _grounded_q0(jm, B, seed):
    """B standing poses: the nominal pose with its feet on z = 0, perturbed."""
    x0 = jnp.asarray(default_config().initial_state())
    q0 = j_cen.pinocchio_q(x0)
    q0 = q0.at[2].add(-float(jnp.mean(j_kin.contact_positions(jm, q0)[:, 2])))
    rng = np.random.default_rng(seed)
    return np.asarray(q0)[None] + rng.normal(size=(B, 24)) * 0.01


# case -> (SimConfig overrides, base height offsets a scenario, with wrench and
# tau_gen_extra): scenario 1 starts 5 cm up, its feet out of contact
SIM_CASES = {
    "stiction": (dict(tangential_stiffness=3000.0), (-0.003, 0.05, -0.001), False),
    "wrench_and_extra": (dict(), (-0.002, 0.05, 0.0), True),
}


def _sim_inputs(jm, case):
    overrides, lift, forced = SIM_CASES[case]
    B = 3
    q0 = _grounded_q0(jm, B, seed=len(case))
    q0[:, 2] += np.asarray(lift)
    rng = np.random.default_rng(7)
    v0 = rng.normal(size=(B, 24)) * 0.2
    # commands a step: PD about the start pose with random feed-forward
    cmds = np.zeros((STEPS, B, 5, 18))
    cmds[:, :, 0] = q0[None, :, 6:24] + rng.normal(size=(STEPS, B, 18)) * 0.02
    cmds[:, :, 1] = rng.normal(size=(STEPS, B, 18)) * 0.1
    cmds[:, :, 2] = 60.0
    cmds[:, :, 3] = 3.0
    cmds[:, :, 4] = rng.normal(size=(STEPS, B, 18)) * 5.0
    wrench = rng.normal(size=(STEPS, B, 6)) * np.array([30, 30, 30, 3, 3, 3]) if forced else None
    extra = rng.normal(size=(STEPS, B, 24)) * 2.0 if forced else None
    return j_sim.SimConfig(**overrides), q0, v0, cmds, wrench, extra


def _state_fields(s):
    return {k: np.asarray(v) for k, v in as_numpy_fields(s).items()}


@pytest.mark.parametrize("case", list(SIM_CASES))
def test_sim_step_matches_jax(models, case):
    jm, tm = models
    cfg, q0, v0, cmds, wrench, extra = _sim_inputs(jm, case)
    tcfg = convert.sim_config_from_numpy(cfg)
    assert tcfg == t_sim.SimConfig(**cfg._asdict())

    j_state = jax.vmap(lambda q, v: j_sim.sim_init(jm, q, v, cfg))(jnp.asarray(q0),
                                                                   jnp.asarray(v0))
    t_state = t_sim.sim_init(tm, torch.as_tensor(q0), torch.as_tensor(v0), tcfg)
    np.testing.assert_allclose(to_np(t_state.anchor), np.asarray(j_state.anchor), **EXACT)
    np.testing.assert_array_equal(to_np(t_state.cmd_buffer), np.asarray(j_state.cmd_buffer))

    step = jax.jit(jax.vmap(lambda s, c, w, e: j_sim.sim_step(
        jm, cfg, s, c, external_wrench=w, tau_gen_extra=e)))
    step_free = jax.jit(jax.vmap(lambda s, c: j_sim.sim_step(jm, cfg, s, c)))
    contact_seen = np.zeros(2, dtype=bool)  # some foot in contact / out of contact
    for k in range(STEPS):
        if wrench is None:
            j_state = step_free(j_state, jnp.asarray(cmds[k]))
            t_state = t_sim.sim_step(tm, tcfg, t_state, torch.as_tensor(cmds[k]))
        else:
            j_state = step(j_state, jnp.asarray(cmds[k]), jnp.asarray(wrench[k]),
                           jnp.asarray(extra[k]))
            t_state = t_sim.sim_step(tm, tcfg, t_state, torch.as_tensor(cmds[k]),
                                     external_wrench=torch.as_tensor(wrench[k]),
                                     tau_gen_extra=torch.as_tensor(extra[k]))
        flags = to_np(t_sim.contact_flags_from_sim(tm, t_state.q, threshold=0.0))
        contact_seen |= np.array([flags.any(), (flags == 0).any()])
        ref = _state_fields(j_state)
        for name in ("q", "v", "t", "cmd_buffer", "anchor"):
            np.testing.assert_allclose(to_np(getattr(t_state, name)), ref[name],
                                       err_msg=f"step {k}: {name}", **STEP_TOL)
        np.testing.assert_array_equal(to_np(t_state.buf_head), ref["buf_head"])
    assert contact_seen.all()
    assert int(t_state.buf_head[0]) == STEPS % (cfg.delay_steps + 1)
    # the carrier brings JAX's state across as it is
    carried = convert.sim_state_from_numpy(_state_fields(j_state), device="cpu")
    assert carried.buf_head.dtype == torch.int64
    for name, ref in _state_fields(j_state).items():
        np.testing.assert_array_equal(to_np(getattr(carried, name)), ref)


def test_sim_step_without_disturbances_is_the_zero_disturbance_step(models):
    """No wrench and no tau_gen_extra (the None path) is the step with both
    zero, bit for bit, over the chained steps; the disturbed path is held
    to JAX above."""
    jm, tm = models
    cfg, q0, v0, cmds, wrench, extra = _sim_inputs(jm, "wrench_and_extra")
    tcfg = convert.sim_config_from_numpy(cfg)
    free = zero = t_sim.sim_init(tm, torch.as_tensor(q0), torch.as_tensor(v0), tcfg)
    for k in range(STEPS):
        cmd = torch.as_tensor(cmds[k])
        free = t_sim.sim_step(tm, tcfg, free, cmd)
        zero = t_sim.sim_step(tm, tcfg, zero, cmd, external_wrench=torch.zeros(3, 6, dtype=F64),
                              tau_gen_extra=torch.zeros(3, 24, dtype=F64))
    for name in ("q", "v", "cmd_buffer", "anchor"):
        np.testing.assert_array_equal(to_np(getattr(free, name)), to_np(getattr(zero, name)))


def test_contact_forces_take_the_stiction_branch(models):
    """With an anchor away from a stance foot, the spring pulls it back and
    the Coulomb clamp drags the anchor, as in JAX."""
    jm, tm = models
    cfg = j_sim.SimConfig(tangential_stiffness=3000.0)
    q0 = _grounded_q0(jm, 2, seed=1)
    q0[:, 2] -= 0.003
    anchor = np.asarray(jax.vmap(lambda q: j_kin.contact_positions(jm, q))(
        jnp.asarray(q0)))[..., :2] + np.array([[0.001], [0.05]])[:, None, :]
    v = np.random.default_rng(2).normal(size=(2, 24)) * 0.1
    ref = jax.vmap(lambda q, vv, a: j_sim._contact_forces(jm, cfg, q, vv, a))(
        jnp.asarray(q0), jnp.asarray(v), jnp.asarray(anchor))
    out = t_sim._contact_forces(tm, convert.sim_config_from_numpy(cfg), torch.as_tensor(q0),
                                torch.as_tensor(v), torch.as_tensor(anchor))
    for name, a, b in zip(("F", "J", "in_contact", "anchor"), out, ref):
        np.testing.assert_allclose(to_np(a), np.asarray(b), err_msg=name, **STEP_TOL)
    moved = np.abs(to_np(out[3]) - anchor).max(axis=-1)
    in_contact = to_np(out[2])
    assert in_contact.any() and (moved[1][in_contact[1]] > 1e-6).any()  # scenario 1 slides


@pytest.mark.parametrize("terrain", ["flat", "stairs"])
def test_contact_flags_match_jax(models, terrain):
    jm, tm = models
    q0 = _grounded_q0(jm, 4, seed=4)
    q0[:, 2] += np.array([-0.001, 0.0015, 0.01, 0.0])
    q0[:, 0] += np.array([0.0, 0.0, 0.0, 0.6])  # on the stairs' first tread
    cfg = j_sim.SimConfig(terrain=terrain, terrain_params=j_terrain.default_params(terrain))
    ref = np.stack([np.asarray(j_sim.contact_flags_from_sim(jm, jnp.asarray(q), cfg=cfg))
                    for q in q0])
    out = t_sim.contact_flags_from_sim(tm, torch.as_tensor(q0),
                                       cfg=convert.sim_config_from_numpy(cfg))
    np.testing.assert_array_equal(to_np(out), ref)
    assert 0 < ref.sum() < ref.size


@pytest.fixture(scope="module")
def maze():
    name = "maze1" if "maze1" in j_world.world_names() else j_world.world_names()[0]
    return name, j_world.load_world(name)


def test_world_library_is_the_same(maze):
    name, jmesh = maze
    assert t_world.world_names() == j_world.world_names()
    tmesh = t_world.load_world(name, device="cpu")
    for field in t_world.WorldMesh._fields:
        np.testing.assert_allclose(to_np(getattr(tmesh, field)), np.asarray(getattr(jmesh, field)),
                                   **EXACT)
    offset = (0.5, -0.25, 0.0)
    np.testing.assert_allclose(to_np(t_world.load_world(name, offset, device="cpu").v0),
                               np.asarray(j_world.load_world(name, offset).v0), **EXACT)


def _against_a_wall(jm, mesh, B=3):
    """B poses, each with its first trunk sphere 6 cm off a wall triangle's
    centroid (overlapping it) and random velocities."""
    rng = np.random.default_rng(11)
    n = np.asarray(mesh.n)
    walls = np.where(np.abs(n[:, 2]) < 0.1)[0]
    q = _grounded_q0(jm, B, seed=9)
    for b in range(B):
        tri = walls[rng.integers(len(walls))]
        c = np.asarray(mesh.v0[tri]) + (np.asarray(mesh.e1[tri]) + np.asarray(mesh.e2[tri])) / 3
        R = np.asarray(j_kin.spatial.zyx_to_rot(jnp.asarray(q[b, 3:6])))
        q[b, 0:3] = c + 0.06 * n[tri] - R @ j_world.TRUNK_POINTS[0]
    v = rng.normal(size=(B, 24)) * 0.3
    return q, v


def test_world_generalized_forces_match_jax(models, maze):
    """JAX's maze mesh fed to the port's query through the carrier; the feet
    and the trunk spheres in one broadcast against JAX's loops."""
    jm, tm = models
    _, jmesh = maze
    q, v = _against_a_wall(jm, jmesh)
    ref = np.stack([np.asarray(j_world.world_generalized_forces(
        jm, jmesh, jnp.asarray(qb), jnp.asarray(vb))) for qb, vb in zip(q, v)])
    tmesh = convert.world_mesh_from_numpy(jmesh, device="cpu")
    out = t_world.world_generalized_forces(tm, tmesh, torch.as_tensor(q), torch.as_tensor(v))
    np.testing.assert_allclose(to_np(out), ref, **STEP_TOL)
    assert (np.abs(ref).max(axis=-1) > 1.0).all()  # every pose is pushed


def test_sphere_mesh_force_matches_jax(maze):
    _, jmesh = maze
    rng = np.random.default_rng(5)
    tri = rng.integers(jmesh.v0.shape[0], size=16)
    c = np.asarray(jmesh.v0)[tri] + 0.3 * (np.asarray(jmesh.e1)[tri] + np.asarray(jmesh.e2)[tri])
    p = c + np.asarray(jmesh.n)[tri] * rng.uniform(-0.15, 0.15, size=(16, 1))
    vp = rng.normal(size=(16, 3))
    ref = np.stack([np.asarray(j_world.sphere_mesh_force(jmesh, jnp.asarray(a), jnp.asarray(b),
                                                         0.12, 2e4, 300.0))
                    for a, b in zip(p, vp)])
    out = t_world.sphere_mesh_force(convert.world_mesh_from_numpy(jmesh, device="cpu"),
                                    torch.as_tensor(p), torch.as_tensor(vp), 0.12, 2e4, 300.0)
    np.testing.assert_allclose(to_np(out), ref, **STEP_TOL)
    assert (np.abs(ref).max(axis=-1) > 0).sum() >= 8


def test_sim_step_with_walls_adds_the_wall_forces(models, maze):
    """One step with the world query on is the step without it plus the wall
    forces (held to JAX above) as tau_gen_extra: the wall term enters
    tau_gen once, from the port's own copy of the mesh."""
    jm, tm = models
    name, jmesh = maze
    q, v = (torch.as_tensor(a) for a in _against_a_wall(jm, jmesh, B=2))
    cfg = t_sim.SimConfig(world=name)
    cmd = torch.zeros(2, 5, 18, dtype=F64)
    cmd[:, 0] = q[:, 6:24]
    walls = t_sim.sim_step(tm, cfg, t_sim.sim_init(tm, q, v, cfg), cmd)
    tau = t_world.world_generalized_forces(tm, t_world.load_world(name, device="cpu"), q, v)
    free = t_sim.sim_step(tm, cfg._replace(world="none"), t_sim.sim_init(tm, q, v, cfg), cmd,
                          tau_gen_extra=tau)
    for field in ("q", "v", "anchor"):
        np.testing.assert_allclose(to_np(getattr(walls, field)), to_np(getattr(free, field)),
                                   rtol=1e-12, atol=1e-12, err_msg=field)
    assert float(tau.abs().max()) > 1.0


@pytest.fixture(scope="module")
def policy():
    rng = np.random.default_rng(3)
    N = 10
    times = np.linspace(0.0, 0.15, N + 1) + 0.02
    return times, rng.normal(size=(3, N + 1, 30)), rng.normal(size=(3, N, 36))


@pytest.mark.parametrize("t", [0.02, 0.0613, 0.1, 0.155, 0.17, -0.5, 0.4],
                         ids=["start", "inside", "node", "last_interval", "end", "before",
                              "after"])
def test_evaluate_policy_matches_jax(policy, t):
    times, X, U = policy
    ref = jax.vmap(lambda Xi, Ui: j_mrt.evaluate_policy(
        j_mrt.PolicyStore(times=jnp.asarray(times), X=Xi, U=Ui), t))(jnp.asarray(X),
                                                                      jnp.asarray(U))
    store = t_mrt.PolicyStore(times=torch.as_tensor(times), X=torch.as_tensor(X),
                              U=torch.as_tensor(U))
    for name, a, b in zip("xu", t_mrt.evaluate_policy(store, t), ref):
        np.testing.assert_allclose(to_np(a), np.asarray(b), err_msg=name, **EXACT)
    # a 0-d tensor time and a single scenario give the same
    one = t_mrt.evaluate_policy(t_mrt.PolicyStore(store.times, store.X[1], store.U[1]),
                                torch.tensor(t, dtype=F64))
    for a, b in zip(one, ref):
        np.testing.assert_allclose(to_np(a), np.asarray(b)[1], **EXACT)


def test_safety_check_matches_jax():
    half = math.pi / 2
    angles = np.array([0.0, half - 1e-9, half, half + 1e-9, -half + 1e-9, -half, -3.0, 1.0])
    x = np.zeros((angles.size * 2, 30))
    x[:angles.size, 10] = angles   # pitch
    x[angles.size:, 11] = angles   # roll
    ref = np.stack([np.asarray(j_safety.safety_check(jnp.asarray(xi))) for xi in x])
    out = to_np(t_safety.safety_check(torch.as_tensor(x)))
    np.testing.assert_array_equal(out, ref)
    assert out.dtype == bool and 0 < out.sum() < out.size
    np.testing.assert_array_equal(out[:angles.size], np.abs(angles) < half)


# measured_rbd's blocks, by name: (the rbd slice, what it holds)
RBD_BLOCKS = {"omega": slice(24, 27), "p_ee": slice(48, 51), "quat": slice(51, 55)}


def test_measured_rbd_in_float32_is_as_accurate_as_jax():
    """The rbd state the closed loop reads each step (measured_rbd) in f32,
    the port's and the JAX package's, against the port's f64 on the same
    f32 states (100 seeded poses and velocities about the trot's): the
    copied blocks exact in both, and the computed ones (world angular
    velocity, EE position and quaternion) no further from f64 than twice
    JAX's own f32 error. (JAX's f32 canonical trot with this function taken
    from the port, tests/torch_parity.py trot-swap rbd 2.0 1e-5, leaves two
    golden bands where its own does not: with this error that is the f32
    trot's rounding split, not a fault of the port's rbd.)"""
    jm32 = j_aliengo_z1(dtype=jnp.float32)
    tm32, tm64 = t_aliengo_z1(dtype=torch.float32, device="cpu"), t_aliengo_z1(dtype=F64,
                                                                               device="cpu")
    rng = np.random.default_rng(11)
    x0 = default_config().initial_state()
    q = (x0[6:30] + rng.normal(size=(100, 24)) * 0.05).astype(np.float32)
    q[:, 0:2] += rng.normal(size=(100, 2)).astype(np.float32) * 0.3
    v = (rng.normal(size=(100, 24)) * 0.5).astype(np.float32)
    ref = to_np(t_sim.measured_rbd(tm64, t_sim.SimState(torch.tensor(q, dtype=F64),
                                                         torch.tensor(v, dtype=F64), *[None] * 4)))
    port = to_np(t_sim.measured_rbd(tm32, t_sim.SimState(torch.tensor(q), torch.tensor(v),
                                                          *[None] * 4))).astype(np.float64)
    jax_rbd = np.stack([np.asarray(j_sim.measured_rbd(jm32, j_sim.SimState(
        q=jnp.asarray(q[i]), v=jnp.asarray(v[i]), t=None, cmd_buffer=None, buf_head=None,
        anchor=None))) for i in range(100)])
    assert jax_rbd.dtype == np.float32
    jax_rbd = jax_rbd.astype(np.float64)
    computed = np.zeros(55, dtype=bool)
    for sl in RBD_BLOCKS.values():
        computed[sl] = True
    np.testing.assert_array_equal(port[:, ~computed], ref[:, ~computed])
    np.testing.assert_array_equal(jax_rbd[:, ~computed], ref[:, ~computed])
    for name, sl in RBD_BLOCKS.items():
        port_err = np.abs(port[:, sl] - ref[:, sl]).max()
        jax_err = np.abs(jax_rbd[:, sl] - ref[:, sl]).max()
        assert 0.0 < jax_err < 1e-6 and port_err <= 2.0 * jax_err, (name, port_err, jax_err)


FD_STATES = 6  # JAX's f32 forward dynamics runs eagerly, ~1-2 s a state


def test_forward_dynamics_in_float32_is_as_accurate_as_jax():
    """The physics step's forward dynamics in f32 (zero applied force), the
    port's and the JAX package's, against the port's f64 on the same f32
    states (FD_STATES seeded poses and velocities about the trot's): the port no
    further from f64 than twice JAX's own f32 error. (JAX's f32 canonical
    trot with the port's physics step and JAX's contact forces,
    tests/torch_parity.py trot-swap sim_dynamics 2.0 1e-5, leaves two
    golden bands, while with the port's whole step, forward dynamics and
    contacts, it stays inside them: the rounding split, not a fault.)"""
    from qm_door_torch.models import dynamics as t_dyn
    from qm_door_tpu.models import dynamics as j_dyn

    jm32 = j_aliengo_z1(dtype=jnp.float32)
    tm32, tm64 = t_aliengo_z1(dtype=torch.float32, device="cpu"), t_aliengo_z1(dtype=F64,
                                                                               device="cpu")
    rng = np.random.default_rng(12)
    x0 = default_config().initial_state()
    q = (x0[6:30] + rng.normal(size=(FD_STATES, 24)) * 0.05).astype(np.float32)
    v = (rng.normal(size=(FD_STATES, 24)) * 0.5).astype(np.float32)
    ref = to_np(t_dyn.forward_dynamics(tm64, torch.tensor(q, dtype=F64), torch.tensor(v, dtype=F64),
                                       torch.zeros(FD_STATES, 24, dtype=F64)))
    port = to_np(t_dyn.forward_dynamics(tm32, torch.tensor(q), torch.tensor(v),
                                        torch.zeros(FD_STATES, 24))).astype(np.float64)
    jax_a = np.stack([np.asarray(j_dyn.forward_dynamics(jm32, jnp.asarray(q[i]), jnp.asarray(
        v[i]), jnp.zeros(24, jnp.float32))) for i in range(FD_STATES)])
    assert jax_a.dtype == np.float32
    port_err = np.abs(port - ref).max()
    jax_err = np.abs(jax_a.astype(np.float64) - ref).max()
    assert 0.0 < jax_err < 1e-2 and port_err <= 2.0 * jax_err, (port_err, jax_err)


def test_load_world_runs_on_cuda_unless_asked_for_the_cpu(monkeypatch, maze):
    """load_world's default device is CUDA, as every entry point of the
    port's: without a CUDA device it raises instead of falling back."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    name, _ = maze
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_world.load_world(name, (0.25, 0.0, 0.0))
    assert t_world.load_world(name, (0.25, 0.0, 0.0), device="cpu").v0.device.type == "cpu"
