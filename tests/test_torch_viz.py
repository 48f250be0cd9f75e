"""The port's plots and flight report (qm_door_torch/utils/viz.py,
utils/dashboard.py) against the JAX package's on tests/test_aux.py's inputs
(and seeded logs), in float64 on the CPU: every array each figure draws —
the data of every line, collection and patch, recorded as the figure is
saved — equal at 1e-9, and contact_cop at 1e-12."""
import numpy as np
import pytest
import torch

from qm_door_torch.models import kinematics as t_kin
from qm_door_torch.models.model import aliengo_z1 as t_aliengo_z1
from qm_door_torch.utils import dashboard as t_dashboard
from qm_door_torch.utils import viz as t_viz
from qm_door_tpu.config import default_config
from qm_door_tpu.models import aliengo_z1 as j_aliengo_z1
from qm_door_tpu.models import kinematics as j_kin
from qm_door_tpu.utils import dashboard as j_dashboard
from qm_door_tpu.utils import viz as j_viz
from torch_parity import F64, to_np
from torch_parity import release_jax_executables  # noqa: F401 (autouse, module scope)

PLOTTED = dict(rtol=0.0, atol=1e-9)


def _figure_arrays(fig):
    """Every array a figure draws, in drawing order: each axes' lines (3-D
    lines by their 3-D data), collections (offsets, 3-D offsets, quiver
    vectors, polygon vertices) and patches (polygon vertices)."""
    out = []
    for ax in fig.axes:
        for line in ax.lines:
            data = line.get_data_3d() if hasattr(line, "get_data_3d") else line.get_data()
            out += [np.asarray(d, dtype=float) for d in data]
        for coll in ax.collections:
            if hasattr(coll, "_offsets3d"):
                out += [np.asarray(d, dtype=float) for d in coll._offsets3d]
            else:
                out.append(np.asarray(coll.get_offsets(), dtype=float))
            if hasattr(coll, "U"):  # a quiver's arrows
                out += [np.asarray(coll.U, dtype=float), np.asarray(coll.V, dtype=float)]
            out += [np.asarray(p.vertices, dtype=float) for p in coll.get_paths()
                    if not hasattr(coll, "U")]
        for patch in ax.patches:
            out.append(np.asarray(patch.get_xy() if hasattr(patch, "get_xy")
                                  else patch.get_path().vertices, dtype=float))
    return out


@pytest.fixture
def drawn(monkeypatch):
    """The arrays of every figure saved while the fixture is live, in order."""
    from matplotlib.figure import Figure

    figures, save = [], Figure.savefig

    def record(fig, *args, **kw):
        figures.append(_figure_arrays(fig))
        return save(fig, *args, **kw)

    monkeypatch.setattr(Figure, "savefig", record)
    return figures


@pytest.fixture(scope="module")
def models():
    return j_aliengo_z1(), t_aliengo_z1(dtype=F64, device="cpu")


@pytest.fixture(scope="module")
def inputs():
    """tests/test_aux.py:test_viz_renders's inputs."""
    times = np.linspace(0, 1, 11)
    X = np.zeros((11, 30))
    X[:, 8] = 0.4
    U = np.zeros((10, 30))
    U[:, 2] = 68.0
    q = np.tile(np.asarray(default_config().initial_state())[6:30], (8, 1))
    q[:, 0] = np.linspace(0, 0.5, 8)
    flags = np.ones((8, 4))
    flags[::2, 1] = 0
    u = np.zeros(36)
    u[2] = u[5] = u[8] = u[11] = 68.0
    u[30] = 25.0
    return dict(times=times, X=X, U=U, q=q, flags=flags, u=u)


class _Log:
    pass


def _log(seed, T=20, mpc=5):
    """A seeded ClosedLoopLog-like record (host numpy rows)."""
    rng = np.random.default_rng(seed)
    log = _Log()
    log.t = list(np.linspace(0, 1, T))
    log.x_obs = list(rng.normal(size=(T, 30)))
    log.base_pose = list(rng.normal(size=(T, 6)))
    log.ee_pos = list(rng.normal(size=(T, 3)))
    log.tau = list(rng.normal(size=(T, 18)))
    log.mpc_viol = list(10.0 ** rng.uniform(-8, -3, size=mpc))
    return log


CHANNELS = {
    "solution": lambda pkg, m, d, path: pkg[0].plot_solution(d["times"], d["X"], d["U"], path),
    "support": lambda pkg, m, d, path: pkg[0].plot_support_and_footholds(
        m, d["q"], d["flags"], path),
    "force_arrows": lambda pkg, m, d, path: pkg[0].plot_force_arrows(m, d["q"][0], d["u"], path),
    "force_arrows_30": lambda pkg, m, d, path: pkg[0].plot_force_arrows(
        m, d["q"][3], d["u"][:30], path),
    "skeleton": lambda pkg, m, d, path: pkg[0].plot_skeleton(m, d["q"][0], path),
    "closed_loop": lambda pkg, m, d, path: pkg[0].plot_closed_loop(_log(1), path),
    "flight_report": lambda pkg, m, d, path: pkg[1].flight_report(_log(2), path),
    "flight_report_one_row": lambda pkg, m, d, path: pkg[1].flight_report(
        _log(3, T=1, mpc=0), path),
}


@pytest.mark.parametrize("channel", CHANNELS)
def test_every_plotted_array_matches_jax(channel, drawn, models, inputs, tmp_path):
    jm, tm = models
    draw = CHANNELS[channel]
    paths = [str(tmp_path / f"{side}.png") for side in ("jax", "torch")]
    assert draw((j_viz, j_dashboard), jm, inputs, paths[0]) == paths[0]
    t_inputs = dict(inputs, q=torch.tensor(inputs["q"], dtype=F64))  # a tensor trajectory too
    assert draw((t_viz, t_dashboard), tm, t_inputs, paths[1]) == paths[1]
    assert len(drawn) == 2
    ref, ours = drawn
    assert [a.shape for a in ours] == [a.shape for a in ref]
    assert len(ref) > 0
    for i, (a, b) in enumerate(zip(ours, ref)):
        np.testing.assert_allclose(a, b, err_msg=f"array {i}", **PLOTTED)
    for p in paths:
        assert (tmp_path / p).stat().st_size > 0


def test_contact_cop_matches_jax(models, inputs):
    jm, tm = models
    q = inputs["q"][0]
    p_feet = np.asarray(j_kin.contact_positions(jm, q))
    np.testing.assert_allclose(to_np(t_kin.contact_positions(tm, torch.tensor(q, dtype=F64))),
                               p_feet, rtol=0.0, atol=1e-12)
    rng = np.random.default_rng(4)
    for forces in (inputs["u"][:12].reshape(4, 3), rng.normal(size=(4, 3)) * 50.0,
                   np.zeros((4, 3))):
        ref = j_viz.contact_cop(p_feet, forces)
        np.testing.assert_allclose(t_viz.contact_cop(torch.tensor(p_feet), torch.tensor(forces)),
                                   ref, rtol=0.0, atol=1e-12)
        np.testing.assert_allclose(t_viz.contact_cop(p_feet, forces), ref, rtol=0.0, atol=1e-12)


def test_plots_read_the_model_where_it_lives(drawn, models, inputs, tmp_path):
    """A float32 model: the trajectory goes to the model's dtype and device
    for the kinematics, and the feet drawn are its float32 feet."""
    tm32 = t_aliengo_z1(dtype=torch.float32, device="cpu")
    t_viz.plot_support_and_footholds(tm32, inputs["q"], inputs["flags"],
                                     str(tmp_path / "sup.png"))
    feet = to_np(t_kin.contact_positions(tm32, torch.tensor(inputs["q"], dtype=torch.float32)))
    stance = inputs["flags"][:, 0] > 0.5
    lf = drawn[0][2]  # base path x, y, then LF's stance offsets
    np.testing.assert_array_equal(lf, feet[stance, 0, :2].astype(float))
