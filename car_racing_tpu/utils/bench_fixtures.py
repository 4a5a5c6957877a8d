"""Deterministic bench fixtures.

The LMPC bench metric measures the fused learning-lap rollout
(racing/fused.rollout_lmpc_lap), which needs two seed laps of safe-set
data (the reference's PID lap -> MPC lap protocol, lmpc_test.py:58-87).
Running that host protocol at bench time would cost hundreds of host
round trips, so the seed laps are generated once
(zero noise, CPU f64 — fully deterministic) and committed as an npz that
``bench.py`` loads and casts to the device dtype.

Regenerate with:  python -m car_racing_tpu.utils.bench_fixtures
"""

from __future__ import annotations

import os

import numpy as np

FIXTURE_PATH = "data/bench/lmpc_seed_l_shape.npz"


def seed_path(track_name: str) -> str:
    return f"data/bench/lmpc_seed_{track_name}.npz"


def generate(path: str | None = None, trim: int = 700, track_name: str = "l_shape"):
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)

    from ..ops import track as track_ops
    from ..racing import policies, simulator, vehicles
    from . import params
    from .constants import X_DIM

    path = path or seed_path(track_name)
    timestep = 0.1
    spec = np.genfromtxt(f"data/track_layout/{track_name}.csv", delimiter=",")
    track = track_ops.build_track(spec, width=1.0)
    opti_xc = np.genfromtxt(f"data/optimal_traj/xcurv_{track_name}.csv", delimiter=",")
    opti_xg = np.genfromtxt(f"data/optimal_traj/xglob_{track_name}.csv", delimiter=",")

    ego = vehicles.DynamicBicycleModel(name="ego", system_param=params.SystemParam.default())
    ego.set_timestep(timestep)
    ego.set_zero_noise()
    ego.set_state_curvilinear(np.zeros(X_DIM))
    ego.set_state_global(np.zeros(X_DIM))
    ego.start_logging()

    pid = policies.PIDTracking(vt=0.7)
    pid.set_timestep(timestep)
    pid.set_track(track)
    ego.set_ctrl_policy(pid)
    mpc = policies.MPCTracking(params.MPCParam.default(vt=0.7), params.SystemParam.default())
    mpc.set_timestep(timestep)
    mpc.set_track(track)
    lmpc = policies.LMPCRacingGame(
        params.LMPCParam.default(),
        racing_game_param=params.RacingGameParam.default(alpha=0.8),
        system_param=params.SystemParam.default(),
        timestep=timestep,
        lap_number=4,
        time_lmpc=1000.0,
    )
    lmpc.set_track(track)
    lmpc.set_timestep(timestep)
    lmpc.set_opti_traj(opti_xc, opti_xg)

    sim = simulator.CarRacingSim()
    sim.set_timestep(timestep)
    sim.set_track(track)
    sim.add_vehicle(ego)
    sim.set_opti_traj(opti_xg)
    for pol in (pid, mpc, lmpc):
        pol.set_racing_sim(sim)
    lmpc.set_vehicles_track()

    sim.sim(sim_time=90, one_lap=True, one_lap_name="ego")
    ego.set_ctrl_policy(mpc)
    sim.sim(sim_time=90, one_lap=True, one_lap_name="ego")
    lmpc.add_trajectory(ego, 0)
    lmpc.add_trajectory(ego, 1)

    P = trim
    N = lmpc.lmpc_param.num_horizon
    v1 = np.zeros(P, bool)
    v1[: max(lmpc.time_ss[1] - 1, 0)] = True
    v2 = np.zeros(P, bool)
    v2[: max(lmpc.time_ss[0] - 1, 0)] = True
    os.makedirs(os.path.dirname(path), exist_ok=True)
    np.savez_compressed(
        path,
        ss1=lmpc.ss_xcurv[:P, :, 1],
        q1=lmpc.Qfun[:P, 1],
        ss2=lmpc.ss_xcurv[:P, :, 0],
        q2=lmpc.Qfun[:P, 0],
        u1=lmpc.u_ss[:P, :, 1],
        u2=lmpc.u_ss[:P, :, 0],
        valid1=v1,
        valid2=v2,
        counter=np.int32(lmpc.time_ss[1]),
        lin_points0=lmpc.ss_xcurv[1 : N + 2, :, 0],
        lin_input0=lmpc.u_ss[1 : N + 1, :, 0],
        xcurv0=np.asarray(ego.xcurv),
        xglob0=np.asarray(ego.xglob),
        pid_lap_steps=np.int32(lmpc.time_ss[0]),
    )
    print(f"wrote {path}: PID lap {lmpc.time_ss[0]} steps, MPC lap {lmpc.time_ss[1]} steps")
    return path


if __name__ == "__main__":
    import sys

    generate(track_name=sys.argv[1] if len(sys.argv) > 1 else "l_shape")
