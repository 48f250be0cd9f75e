"""Flight-report dashboard: the rqt_multiplot role, headless (port of
qm_door_tpu/utils/dashboard.py).

The reference ships an rqt_multiplot layout (qm_controllers/config/
rqt_multiplot.xml) with panels for centroidal momentum (linear + angular),
EE position, base velocity, and arm joint pos/vel. ``flight_report``
renders the same panel set (plus solver-health panels the reference shows
in its terminal) from a ClosedLoopLog into one figure — the dashboard a
run leaves behind instead of a live GUI. The log's rows are host numpy
arrays (sim/closed_loop.py:ClosedLoopLog), so nothing here touches a
device.
"""
from __future__ import annotations

import numpy as np


def flight_report(log, path="flight_report.png", title="qm_door_torch run"):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    t = np.asarray(log.t)
    x = np.stack(log.x_obs)              # (T, 30)
    base = np.stack(log.base_pose)       # (T, 6)
    ee = np.stack(log.ee_pos)
    tau = np.stack(log.tau)

    fig, axes = plt.subplots(3, 3, figsize=(16, 10))
    fig.suptitle(title)

    ax = axes[0, 0]
    ax.plot(t, x[:, 0:3])
    ax.set_title("normalized momentum linear")  # rqt: 'moment linear'
    ax.legend(["x", "y", "z"], fontsize=7)

    ax = axes[0, 1]
    ax.plot(t, x[:, 3:6])
    ax.set_title("normalized momentum angular")

    ax = axes[0, 2]
    ax.plot(t, ee)
    ax.set_title("ee position")
    ax.legend(["x", "y", "z"], fontsize=7)

    ax = axes[1, 0]
    if len(t) > 1:
        dt = np.diff(t).mean()
        ax.plot(t[1:], np.diff(base[:, 0:3], axis=0) / dt)
    ax.set_title("base vel")

    ax = axes[1, 1]
    ax.plot(t, x[:, 24:30])
    ax.set_title("arm joint pos")
    ax.legend([f"j{i+1}" for i in range(6)], fontsize=6)

    ax = axes[1, 2]
    if len(t) > 1:
        dt = np.diff(t).mean()
        ax.plot(t[1:], np.diff(x[:, 24:30], axis=0) / dt)
    ax.set_title("arm joint vel")

    ax = axes[2, 0]
    ax.plot(t, base[:, 3:6])
    ax.set_title("base attitude (zyx)")
    ax.legend(["yaw", "pitch", "roll"], fontsize=7)

    ax = axes[2, 1]
    ax.plot(t, tau[:, 12:18])
    ax.set_title("arm torques (ff)")

    ax = axes[2, 2]
    if getattr(log, "mpc_viol", None):
        n = len(log.mpc_viol)
        tm = np.linspace(t[0], t[-1], n) if len(t) else np.arange(n)
        ax.semilogy(tm, np.maximum(np.asarray(log.mpc_viol), 1e-12))
        ax.set_title("MPC constraint violation")
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)
    return path
