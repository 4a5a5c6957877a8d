"""Plotting and animation for simulations (reference racing/offboard.py:133-623).

Headless-friendly: every function takes/creates matplotlib figures and can
save to a path instead of showing.  The racing-game animation renders the
two-pane view (full track + ego-centered zoom with planner overlays) like
offboard.py:268-623 at full overlay fidelity: LMPC / CBF predictions in
the track pane, and in the zoom pane EVERY branch's Bezier spline and
candidate trajectory with the selected branch highlighted on top.
"""

from __future__ import annotations

import numpy as np

from ..ops import track as track_ops


def _mpl():
    """matplotlib on first use (headless Agg), so importing this module
    costs nothing where nothing is plotted."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.animation as anim
    import matplotlib.patches as patches
    import matplotlib.pyplot as plt

    return plt, anim, patches


def plot_track(ax, track, center_line=True, points_per_meter=100):
    """Draw the track boundaries (reference racing_env.py:286-318)."""
    inner, center, outer = track_ops.sample_boundaries(track, points_per_meter)
    if center_line:
        ax.plot(center[:, 0], center[:, 1], "--r")
    ax.plot(inner[:, 0], inner[:, 1], "-b", linewidth=2)
    ax.plot(outer[:, 0], outer[:, 1], "-b", linewidth=2)


def plot_state(sim, name, save_path=None):
    """4-pane state history (vx, vy, epsi, ey) (offboard.py:133-181)."""
    plt = _mpl()[0]
    traj = sim.full_trajectory(name, kind="xcurv")
    time = np.arange(len(traj)) * sim.timestep
    fig, axs = plt.subplots(4, figsize=(8, 10))
    labels = [("$v_x$ [m/s]", 0), ("$v_y$ [m/s]", 1), (r"$e_{\psi}$ [rad]", 3), ("$e_y$ [m]", 5)]
    for ax, (lab, idx) in zip(axs, labels):
        ax.plot(time, traj[:, idx], "-o", linewidth=1, markersize=1)
        ax.set_xlabel("time [s]", fontsize=14)
        ax.set_ylabel(lab, fontsize=14)
    fig.tight_layout()
    if save_path:
        fig.savefig(save_path, dpi=80)
        plt.close(fig)
    return fig


def plot_input(sim, name, save_path=None):
    """Steering/acceleration history (offboard.py:188-225)."""
    plt = _mpl()[0]
    veh = sim.vehicles[name]
    u = np.asarray([u for lap in veh.inputs for u in lap] + list(veh.lap_inputs))
    time = np.arange(len(u)) * sim.timestep
    fig, axs = plt.subplots(2, figsize=(8, 6))
    axs[0].plot(time, u[:, 0], "-o", linewidth=1, markersize=1)
    axs[0].set_ylabel(r"$\delta$ [rad]", fontsize=14)
    axs[1].plot(time, u[:, 1], "-o", linewidth=1, markersize=1)
    axs[1].set_ylabel("$a$ [m/s$^2$]", fontsize=14)
    for ax in axs:
        ax.set_xlabel("time [s]", fontsize=14)
    fig.tight_layout()
    if save_path:
        fig.savefig(save_path, dpi=80)
        plt.close(fig)
    return fig


def plot_simulation(sim, save_path=None):
    """Global trajectories of every vehicle over the track (offboard.py:232-266)."""
    plt = _mpl()[0]
    fig, ax = plt.subplots()
    plot_track(ax, sim.track)
    for name in sim.vehicles:
        traj = sim.full_trajectory(name, kind="xglob")
        if len(traj):
            ax.plot(traj[:, 4], traj[:, 5], label=name)
    ax.axis("equal")
    ax.legend()
    if save_path:
        fig.savefig(save_path, dpi=80)
        plt.close(fig)
    return fig


def _vehicle_vertices(x, y, psi, l, w):
    c, s = np.cos(psi), np.sin(psi)
    return np.array(
        [
            [x + l * c - w * s, y + l * s + w * c],
            [x + l * c + w * s, y + l * s - w * c],
            [x - l * c + w * s, y - l * s - w * c],
            [x - l * c - w * s, y - l * s + w * c],
        ]
    )


def _branch_count(ego, n_frames):
    """Max branch count across the logged all-branch planner artifacts."""
    n_br = 0
    for arr in list(ego.all_splines[-n_frames:]) + list(ego.all_local_trajs[-n_frames:]):
        if arr is not None:
            n_br = max(n_br, np.asarray(arr).shape[0])
    return n_br


def build_animation(sim, ani_time=400, racing_game=False):
    """Build the animation figure + per-frame update function (split from
    :func:`animate` so tests can drive frames and inspect the artists).

    Racing-game mode renders the reference's two-pane view
    (offboard.py:268-623) INCLUDING the all-branch overlays: every
    corridor's Bezier spline and candidate trajectory (logged in
    ``ego.all_splines`` / ``ego.all_local_trajs``) is drawn in the zoom
    pane with the selected branch highlighted by the thick orange
    trajectory / black spline on top — matching the reference's
    ``all_local_spline`` / ``all_local_traj`` artist lists.

    Returns (fig, update, n_frames, artists) where artists maps
    'branch_splines'/'branch_trajs' to the per-branch Line2D lists."""
    plt, _, patches = _mpl()
    ego = sim.vehicles["ego"]
    n_frames = min(ani_time, len(ego.xglob_log))
    artists = {}

    if racing_game:
        fig = plt.figure(figsize=(10, 4))
        ax = fig.add_axes([0.05, 0.07, 0.56, 0.9])
        ax1 = fig.add_axes([0.63, 0.07, 0.36, 0.9])
        ax1.set_xticks([])
        ax1.set_yticks([])
        plot_track(ax1, sim.track, center_line=False)
        # every branch's spline + candidate trajectory (reference
        # offboard.py:288-296 builds one artist pair per vehicle+1)
        n_br = _branch_count(ego, n_frames)
        cmap = plt.get_cmap("tab10")
        branch_splines, branch_trajs = [], []
        for br in range(n_br):
            (bs,) = ax1.plot([], [], "-.", color=cmap(br % 10), linewidth=0.8,
                             alpha=0.7, zorder=4)
            (bt,) = ax1.plot([], [], "-", color=cmap(br % 10), linewidth=1.0,
                             alpha=0.7, zorder=5)
            branch_splines.append(bs)
            branch_trajs.append(bt)
        (local_line,) = ax1.plot([], [], color="orange", linewidth=4, zorder=6)
        (spline_line,) = ax1.plot([], [], "-.", color="black", linewidth=1.5, zorder=7)
        (lmpc_line,) = ax.plot([], [], color="purple", linewidth=2)
        (cbf_line,) = ax.plot([], [], color="slategray", linewidth=2)
        artists = {
            "branch_splines": branch_splines,
            "branch_trajs": branch_trajs,
            "selected_traj": local_line,
            "selected_spline": spline_line,
        }
    else:
        fig, ax = plt.subplots()
    plot_track(ax, sim.track, center_line=False)

    polys = {}
    polys1 = {}
    trajs = {}
    for name, veh in sim.vehicles.items():
        fc = "red" if name == "ego" else "blue"
        poly = patches.Polygon(np.zeros((4, 2)), closed=True, fc=fc, zorder=10)
        ax.add_patch(poly)
        polys[name] = poly
        if racing_game:
            poly1 = patches.Polygon(np.zeros((4, 2)), closed=True, fc=fc, zorder=10)
            ax1.add_patch(poly1)
            polys1[name] = poly1
        log = np.asarray(veh.xglob_log[-n_frames:])
        trajs[name] = log
    ax.axis("equal")

    ego_arts = {
        "local": [x for x in ego.local_trajs[-n_frames:]],
        "spline": [x for x in ego.splines[-n_frames:]],
        "lmpc": [x for x in ego.lmpc_prediction[-n_frames:]],
        "cbf": [x for x in ego.mpc_cbf_prediction[-n_frames:]],
        "all_splines": [x for x in ego.all_splines[-n_frames:]],
        "all_trajs": [x for x in ego.all_local_trajs[-n_frames:]],
    } if racing_game else None

    def set_line(line, arr):
        line.set_data(*(arr[:, 4], arr[:, 5]) if arr is not None else ([], []))

    def update(i):
        for name, poly in polys.items():
            log = trajs[name]
            if i >= len(log):
                continue
            x, y, psi = log[i, 4], log[i, 5], log[i, 3]
            veh = sim.vehicles[name]
            verts = _vehicle_vertices(x, y, psi, float(veh.param.length) / 2, float(veh.param.width) / 2)
            poly.set_xy(verts)
            if racing_game:
                polys1[name].set_xy(verts)
        if racing_game and i < len(trajs["ego"]):
            ax1.set_xlim(trajs["ego"][i, 4] - 2, trajs["ego"][i, 4] + 2)
            ax1.set_ylim(trajs["ego"][i, 5] - 2, trajs["ego"][i, 5] + 2)
            pad = len(trajs["ego"]) - len(ego_arts["local"])
            j = i - pad
            if 0 <= j < len(ego_arts["local"]):
                set_line(local_line, ego_arts["local"][j])
                set_line(spline_line, ego_arts["spline"][j])
                set_line(lmpc_line, ego_arts["lmpc"][j])
                set_line(cbf_line, ego_arts["cbf"][j])
                alls = ego_arts["all_splines"][j]
                allt = ego_arts["all_trajs"][j]
                for br, (bs, bt) in enumerate(zip(branch_splines, branch_trajs)):
                    set_line(bs, alls[br] if alls is not None and br < len(alls) else None)
                    set_line(bt, allt[br] if allt is not None and br < len(allt) else None)
        return list(polys.values())

    return fig, update, n_frames, artists


def animate(sim, filename="simulation", ani_time=400, racing_game=False,
            save_dir="media/animation", fps=10):
    """Render an animation gif of the last ``ani_time`` steps (reference
    offboard.py:268-623, incl. the all-branch spline/trajectory overlays)."""
    plt, anim, _ = _mpl()
    import os

    os.makedirs(save_dir, exist_ok=True)
    fig, update, n_frames, _ = build_animation(sim, ani_time, racing_game)
    media = anim.FuncAnimation(fig, update, frames=n_frames, interval=1000 // fps)
    out_path = os.path.join(save_dir, filename + ".gif")
    media.save(out_path, dpi=80, writer=anim.PillowWriter(fps=fps))
    plt.close(fig)
    return out_path
