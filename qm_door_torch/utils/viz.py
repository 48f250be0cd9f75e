"""Headless trajectory visualization (QmVisualizer / rqt_multiplot role;
port of qm_door_tpu/utils/viz.py).

The reference publishes RViz markers (feet, force arrows, CoP, support
polygon, optimized trajectories, TF) and rqt_multiplot dashboards
(qm_interface/src/visualization/qm_visualization.cpp,
qm_controllers/config/rqt_multiplot.xml). The TPU-native stack is headless:
this module renders the same channels from a ClosedLoopLog / recorded arrays
into matplotlib figures.

The functions that take a ``model`` run the port's kinematics
(models/kinematics.py) on the model's device, card or CPU, in its dtype;
tensors come to the host as numpy only to be drawn. Each plot returns the
path it wrote. The kinematic channels' data are functions of their own
(``support_data``, ``force_arrows_data``, ``skeleton_data``): drawing needs
matplotlib, computing the data does not.
"""
from __future__ import annotations

import numpy as np
import torch


def _host(a):
    """``a`` (a tensor on any device, or array-like) as a numpy array."""
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _on_model(model, a):
    """``a`` as a tensor on the model's device in its dtype."""
    return torch.as_tensor(a, dtype=model.dtype, device=model.device)


def plot_closed_loop(log, path="closed_loop.png", title="qm_door_torch closed loop"):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    t = np.asarray(log.t)
    base = np.stack(log.base_pose)
    x_obs = np.stack(log.x_obs)
    tau = np.stack(log.tau)

    fig, axes = plt.subplots(2, 2, figsize=(12, 8))
    ax = axes[0, 0]
    ax.plot(t, base[:, 0], label="x")
    ax.plot(t, base[:, 1], label="y")
    ax.plot(t, base[:, 2], label="z")
    ax.set_title("base position [m]")
    ax.legend()

    ax = axes[0, 1]
    ax.plot(t, base[:, 3], label="yaw")
    ax.plot(t, base[:, 4], label="pitch")
    ax.plot(t, base[:, 5], label="roll")
    ax.set_title("base orientation [rad]")
    ax.legend()

    ax = axes[1, 0]
    ax.plot(t, x_obs[:, 0], label="vcom_x")
    ax.plot(t, x_obs[:, 1], label="vcom_y")
    ax.plot(t, x_obs[:, 2], label="vcom_z")
    ax.set_title("normalized momentum (linear)")
    ax.legend()

    ax = axes[1, 1]
    ax.plot(t, np.abs(tau).max(axis=1), label="|tau|_max")
    ax.plot(t, np.abs(tau).mean(axis=1), label="|tau|_mean")
    ax.set_title("joint torques [Nm]")
    ax.legend()

    fig.suptitle(title)
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)
    return path


def support_data(model, q_traj, flags_traj):
    """What plot_support_and_footholds draws, as host numpy arrays: the feet
    (T, 4, 3) by the model's kinematics on its device, the contact flags
    (T, 4) and the base path (T, 2)."""
    from ..models import kinematics

    q_traj = _on_model(model, q_traj)
    feet = torch.func.vmap(lambda q: kinematics.contact_positions(model, q))(q_traj)
    return {"feet": _host(feet), "flags": _host(flags_traj), "base": _host(q_traj[:, 0:2])}


def plot_support_and_footholds(model, q_traj, flags_traj, path="support.png"):
    """Top-down view: foot positions colored by contact, base path, support
    polygons at sampled instants (QmVisualizer support-polygon/foothold role)."""
    d = support_data(model, q_traj, flags_traj)
    feet, flags, base = d["feet"], d["flags"], d["base"]
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(7, 7))
    ax.plot(base[:, 0], base[:, 1], "k-", lw=1.5, label="base path")
    colors = ["tab:blue", "tab:orange", "tab:green", "tab:red"]
    names = ["LF", "RF", "LH", "RH"]
    for i in range(4):
        stance = flags[:, i] > 0.5
        ax.scatter(feet[stance, i, 0], feet[stance, i, 1], s=6, c=colors[i],
                   label=f"{names[i]} stance")
        ax.scatter(feet[~stance, i, 0], feet[~stance, i, 1], s=3, c=colors[i],
                   alpha=0.2)
    # support polygons at a few instants
    for t in range(0, len(feet), max(1, len(feet) // 6)):
        pts = feet[t, flags[t] > 0.5][:, :2]
        if len(pts) >= 3:
            hull = pts[np.argsort(np.arctan2(*(pts - pts.mean(0)).T[::-1]))]
            ax.fill(hull[:, 0], hull[:, 1], alpha=0.08, color="gray")
    ax.set_aspect("equal")
    ax.legend(fontsize=8)
    ax.set_title("footholds + support polygons")
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)
    return path


def plot_solution(times, X, U, path="mpc_solution.png"):
    """Plot one MPC solution: optimized base trajectory + contact forces
    (QmVisualizer::publishOptimizedStateTrajectory role)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    times = _host(times)
    X = _host(X)
    U = _host(U)

    fig, axes = plt.subplots(1, 3, figsize=(15, 4))
    axes[0].plot(times, X[:, 6:9])
    axes[0].set_title("base position plan")
    axes[0].legend(["x", "y", "z"])
    axes[1].plot(times, X[:, 0:3])
    axes[1].set_title("vcom plan")
    for foot, name in enumerate(["LF", "RF", "LH", "RH"]):
        axes[2].plot(times[:-1], U[:, 3 * foot + 2], label=name)
    axes[2].set_title("vertical contact forces")
    axes[2].legend()
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)
    return path


def contact_cop(p_feet, forces, eps=1e-6):
    """Center of pressure from foot positions (4,3) and forces (4,3)
    (QmVisualizer CoP marker math: fz-weighted mean of the contact points)."""
    p_feet = _host(p_feet)
    forces = _host(forces)
    fz = np.clip(forces[:, 2], 0.0, None)
    w = fz / max(fz.sum(), eps)
    return (w[:, None] * p_feet).sum(axis=0)


def force_arrows_data(model, q, u, ee_wrench=None):
    """What plot_force_arrows draws, as host numpy arrays: q, the foot
    forces F (4, 3), the feet p (4, 3) by the model's kinematics on its
    device, their CoP, and the EE wrench (``ee_wrench``, else u[30:36] of a
    36-wide input, else None) with the EE position it acts at."""
    from ..models import kinematics

    q_dev = _on_model(model, q)
    u = _host(u)
    F = u[:12].reshape(4, 3)
    p = _host(kinematics.contact_positions(model, q_dev))
    if ee_wrench is None and u.shape[0] >= 36:
        ee_wrench = u[30:36]
    p_ee = None if ee_wrench is None else _host(kinematics.ee_pose(model, q_dev)[1])
    return {"q": _host(q_dev), "F": F, "p": p, "cop": contact_cop(p, F), "p_ee": p_ee,
            "ee_wrench": None if ee_wrench is None else _host(ee_wrench)}


def plot_force_arrows(model, q, u, path="forces.png", ee_wrench=None):
    """Contact-force arrows + CoP at one instant, top-down and side views
    (QmVisualizer::publishOptimizedForceTrajectory / CoP marker role).

    ``u``: MPC input vector — first 12 entries are the foot forces; a
    36-wide force-tracking input's EE wrench can be passed via ``ee_wrench``
    or is read from u[30:36]."""
    d = force_arrows_data(model, q, u, ee_wrench)
    q, F, p, cop = d["q"], d["F"], d["p"], d["cop"]
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, axes = plt.subplots(1, 2, figsize=(11, 5))
    scale = 1.0 / max(np.abs(F).max(), 1.0)

    ax = axes[0]
    ax.quiver(p[:, 0], p[:, 1], F[:, 0] * scale, F[:, 1] * scale,
              color="tab:red", angles="xy", scale_units="xy", scale=1.0,
              width=0.008, label="foot force (xy)")
    order = [0, 1, 3, 2, 0]
    ax.plot(p[order, 0], p[order, 1], "k--", lw=0.8, label="support polygon")
    ax.plot(*cop[:2], "b*", ms=12, label="CoP")
    ax.plot(q[0], q[1], "g^", ms=8, label="base")
    ax.set_title("top-down: tangential forces + CoP")
    ax.set_aspect("equal")
    ax.legend(fontsize=8)

    ax = axes[1]
    ax.quiver(p[:, 0], p[:, 2], F[:, 0] * scale, F[:, 2] * scale,
              color="tab:red", angles="xy", scale_units="xy", scale=1.0,
              width=0.008)
    ax.plot(p[:, 0], p[:, 2], "ko", ms=4)
    if d["ee_wrench"] is not None:
        p_ee, w = d["p_ee"], d["ee_wrench"]
        ax.quiver(p_ee[0], p_ee[2], w[0] * scale, w[2] * scale,
                  color="tab:purple", angles="xy", scale_units="xy",
                  scale=1.0, width=0.008, label="EE wrench")
        ax.legend(fontsize=8)
    ax.set_title("side view: sagittal forces")
    ax.set_aspect("equal")
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)
    return path


def skeleton_data(model, q):
    """What plot_skeleton draws, as host numpy arrays: q, every body's
    position (19, 3) by the model's FK on its device, the feet (4, 3) and
    the EE position."""
    from ..models import kinematics

    q_dev = _on_model(model, q)
    return {"q": _host(q_dev), "bodies": _host(kinematics.fk(model, q_dev)[1]),
            "feet": _host(kinematics.contact_positions(model, q_dev)),
            "p_ee": _host(kinematics.ee_pose(model, q_dev)[1])}


def plot_skeleton(model, q, path="skeleton.png"):
    """Kinematic stick figure from FK (the TF-tree channel of the
    reference's RViz view): every joint body connected to its parent, feet
    and EE highlighted."""
    d = skeleton_data(model, q)
    q, p, feet, p_ee = d["q"], d["bodies"], d["feet"], d["p_ee"]
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig = plt.figure(figsize=(7, 6))
    ax = fig.add_subplot(111, projection="3d")
    for j in range(model.nj):
        par = model.joint_parent[j]
        child = j + 1  # body index of joint j's child
        seg = np.stack([p[par], p[child]])
        ax.plot(seg[:, 0], seg[:, 1], seg[:, 2], "o-", color="tab:gray",
                ms=2, lw=1.2)
    ax.scatter(feet[:, 0], feet[:, 1], feet[:, 2], c="tab:red", s=25,
               label="feet")
    ax.scatter(*p_ee, c="tab:purple", s=40, label="EE")
    ax.scatter(*q[0:3], c="tab:green", s=40, label="base")
    ax.legend(fontsize=8)
    ax.set_box_aspect((1, 1, 0.8))
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)
    return path
