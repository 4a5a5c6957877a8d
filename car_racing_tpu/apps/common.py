"""Shared wiring for the CLI drivers (reference car_racing/tests/*.py)."""

from __future__ import annotations

import os

import numpy as np

from ..ops import track as track_ops
from ..racing import simulator, vehicles
from ..utils import params
from ..utils.constants import X_DIM


def build_track(track_layout: str, width: float = 0.8):
    spec = np.genfromtxt(f"data/track_layout/{track_layout}.csv", delimiter=",")
    return track_ops.build_track(spec, width=width)


def build_ego(track, timestep=0.1, zero_noise=True, seed=0):
    ego = vehicles.DynamicBicycleModel(
        name="ego", system_param=params.SystemParam.default(), seed=seed
    )
    if zero_noise:
        ego.set_zero_noise()
    ego.set_timestep(timestep)
    ego.set_state_curvilinear(np.zeros(X_DIM))
    ego.set_state_global(np.zeros(X_DIM))
    ego.start_logging()
    ego.set_track(track)
    return ego


def build_sim(track, timestep=0.1):
    sim = simulator.CarRacingSim()
    sim.set_timestep(timestep)
    sim.set_track(track)
    return sim


def attach_policy(ego, sim, policy, timestep=0.1):
    policy.set_timestep(timestep)
    policy.set_track(sim.track)
    policy.set_racing_sim(sim)
    ego.set_ctrl_policy(policy)
    return policy


def save_sim(sim, path):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    sim.save(path)


def load_sim(path):
    return simulator.CarRacingSim.load(path)


def finish(sim, args, name_prefix, racing_game=False):
    """Post-run plotting/animation per the reference driver flags, plus the
    solve-latency table (the reference prints per-solve wall time around
    every solver call, control.py:24,60,...)."""
    from ..utils.profiling import GLOBAL_TIMER

    report = GLOBAL_TIMER.report()
    if report:
        print("solver latency (host wall-clock, incl. dispatch):")
        print(report)
    if racing_game:
        # per-branch solver effort of the last planner dispatch — REAL
        # Newton counts on both the single-chip and mesh paths (recorded
        # branch wall times are batch-uniform since all branches solve as
        # one fused batch)
        pol = getattr(sim.vehicles.get("ego"), "ctrl_policy", None)
        planner = getattr(pol, "overtake_planner", None)
        iters = getattr(planner, "last_branch_iterations", None)
        if iters is not None:
            print(
                "last planner dispatch per-branch Newton iters: "
                f"{[int(v) for v in iters]}"
            )
    if args.get("plotting") or args.get("animation"):
        from ..racing import plotting  # matplotlib only when asked for
    if args.get("plotting"):
        os.makedirs("media/plots", exist_ok=True)
        plotting.plot_simulation(sim, save_path=f"media/plots/{name_prefix}_traj.png")
        plotting.plot_state(sim, "ego", save_path=f"media/plots/{name_prefix}_state.png")
        plotting.plot_input(sim, "ego", save_path=f"media/plots/{name_prefix}_input.png")
    if args.get("animation"):
        plotting.animate(sim, filename=name_prefix, racing_game=racing_game)
