"""Headless plotting/animation smoke tests."""

import os

import numpy as np

from car_racing_tpu.ops import track as track_ops
from car_racing_tpu.racing import plotting, policies, simulator, vehicles
from car_racing_tpu.utils import params
from car_racing_tpu.utils.constants import X_DIM


def _short_sim():
    spec = np.genfromtxt("data/track_layout/l_shape.csv", delimiter=",")
    track = track_ops.build_track(spec, width=0.8)
    ego = vehicles.DynamicBicycleModel(name="ego", system_param=params.SystemParam.default())
    ego.set_zero_noise()
    ego.set_state_curvilinear(np.zeros(X_DIM))
    ego.set_state_global(np.zeros(X_DIM))
    ego.start_logging()
    sim = simulator.CarRacingSim()
    sim.set_timestep(0.1)
    sim.set_track(track)
    sim.add_vehicle(ego)
    pid = policies.PIDTracking(vt=0.8)
    pid.set_timestep(0.1)
    pid.set_track(track)
    pid.set_racing_sim(sim)
    ego.set_ctrl_policy(pid)
    sim.sim(sim_time=3.0)
    return sim


def test_plots_and_animation(tmp_path):
    sim = _short_sim()
    p1 = tmp_path / "state.png"
    p2 = tmp_path / "input.png"
    p3 = tmp_path / "traj.png"
    plotting.plot_state(sim, "ego", save_path=str(p1))
    plotting.plot_input(sim, "ego", save_path=str(p2))
    plotting.plot_simulation(sim, save_path=str(p3))
    for p in (p1, p2, p3):
        assert p.exists() and p.stat().st_size > 1000
    gif = plotting.animate(sim, filename="t", ani_time=10, save_dir=str(tmp_path))
    assert os.path.exists(gif) and os.path.getsize(gif) > 1000


def test_racing_game_animation_draws_all_branches(tmp_path):
    """The racing-game zoom pane must render EVERY branch's spline and
    candidate trajectory (reference offboard.py:288-296 creates one artist
    pair per vehicle+1), with the selected branch highlighted on top."""
    sim = _short_sim()
    ego = sim.vehicles["ego"]
    n = len(ego.xglob_log)
    n_br, H = 4, 10
    rng = np.random.default_rng(0)

    # inject planner artifacts for the last 3 steps (earlier steps keep the
    # policy's None entries, exercising the no-overtake frames too)
    def fake(shape):
        a = np.zeros(shape)
        a[..., 4] = rng.uniform(0, 5, shape[:-1])
        a[..., 5] = rng.uniform(-1, 1, shape[:-1])
        return a

    for k in range(3):
        i = len(ego.local_trajs) - 1 - k
        ego.local_trajs[i] = fake((H + 1, X_DIM))
        ego.splines[i] = fake((H + 1, X_DIM))
        ego.lmpc_prediction[i] = fake((13, X_DIM))
        ego.mpc_cbf_prediction[i] = fake((11, X_DIM))
        ego.all_splines[i] = fake((n_br, H + 1, X_DIM))
        ego.all_local_trajs[i] = fake((n_br, H + 1, X_DIM))

    fig, update, n_frames, artists = plotting.build_animation(
        sim, ani_time=n, racing_game=True
    )
    assert len(artists["branch_splines"]) == n_br
    assert len(artists["branch_trajs"]) == n_br

    update(n_frames - 1)  # an overtake frame
    for br in range(n_br):
        xs, ys = artists["branch_splines"][br].get_data()
        assert len(xs) == H + 1, f"branch {br} spline not drawn"
        xs, ys = artists["branch_trajs"][br].get_data()
        assert len(xs) == H + 1, f"branch {br} trajectory not drawn"
    # selected branch stays highlighted on top
    xs, _ = artists["selected_traj"].get_data()
    assert len(xs) == H + 1
    assert artists["selected_traj"].get_zorder() > max(
        l.get_zorder() for l in artists["branch_trajs"]
    )

    update(0)  # a no-overtake frame clears the overlays
    for br in range(n_br):
        assert len(artists["branch_splines"][br].get_data()[0]) == 0

    import matplotlib.pyplot as plt

    plt.close(fig)

    # and the full gif render with overlays still works end to end
    gif = plotting.animate(
        sim, filename="rg", ani_time=n, racing_game=True, save_dir=str(tmp_path)
    )
    assert os.path.exists(gif) and os.path.getsize(gif) > 1000
