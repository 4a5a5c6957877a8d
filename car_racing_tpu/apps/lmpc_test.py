"""LMPC multi-lap learning driver (reference car_racing/tests/lmpc_test.py).

Protocol: lap 0 PID, lap 1 MPC-LTI (data collection), laps 2+ LMPC.
Supports --direct-lmpc restart from a pickled multi-lap ego, and
--save-trajectory to export the learned raceline CSVs.

    python -m car_racing_tpu.apps.lmpc_test --track-layout l_shape \
        --lap-number 7 --simulation --zero-noise --plotting
"""

import argparse
import os
import pickle

import numpy as np

from . import common
from ..racing import policies
from ..utils import compile_cache, params


def fused_protocol(args):
    """--fused-protocol: the whole learning protocol as fused on-device
    rollouts (racing/protocol.py) — no reference analog.  Prints the same
    lap-time report as the host protocol (lmpc_test.py:148-155)."""
    from ..racing import protocol

    layout = args["track_layout"]
    lap_number = args["lap_number"] or 7
    timestep = 0.1
    track = common.build_track(layout, width=1.0)
    out = protocol.run_learning_protocol(
        track, n_laps=max(lap_number - 2, 1),
        n_steps_learn=args.get("n_steps_learn"),
    )
    for i, steps in enumerate(out["lap_steps"]):
        print(f"lap time at iteration {i} is {steps * timestep:.2f} s")
    if args.get("save_trajectory"):
        best = protocol.export_learned_raceline(out, track, layout)
        print(f"exported learned raceline from iteration {best}")


def lmpc_racing(args):
    layout = args["track_layout"]
    lap_number = args["lap_number"] or 7
    timestep = 0.1
    if args.get("fused_protocol"):
        fused_protocol(args)
        return
    if args["simulation"]:
        track = common.build_track(layout, width=1.0)
        opti_traj_xcurv = np.genfromtxt(f"data/optimal_traj/xcurv_{layout}.csv", delimiter=",")
        opti_traj_xglob = np.genfromtxt(f"data/optimal_traj/xglob_{layout}.csv", delimiter=",")
        if args["direct_lmpc"]:
            with open(f"data/ego/ego_{layout}_multi_laps.obj", "rb") as fh:
                ego = pickle.load(fh)
        else:
            ego = common.build_ego(track, timestep, zero_noise=args["zero_noise"])
        sim = common.build_sim(track, timestep)
        sim.add_vehicle(ego)
        sim.set_opti_traj(opti_traj_xglob)

        pid = policies.PIDTracking(vt=0.7)
        common.attach_policy(ego, sim, pid, timestep)
        mpc = policies.MPCTracking(params.MPCParam.default(vt=0.7))
        mpc.set_timestep(timestep)
        mpc.set_track(track)
        mpc.set_racing_sim(sim)
        lmpc = policies.LMPCRacingGame(
            params.LMPCParam.default(),
            racing_game_param=params.RacingGameParam.default(alpha=0.8),
            timestep=timestep,
            lap_number=lap_number,
            time_lmpc=10000 * timestep,
        )
        lmpc.set_track(track)
        lmpc.set_timestep(timestep)
        lmpc.set_opti_traj(opti_traj_xcurv, opti_traj_xglob)
        lmpc.openloop_prediction = policies.LMPCPrediction(lap_number=lap_number)
        lmpc.set_racing_sim(sim)
        lmpc.set_vehicles_track()

        for it in range(lap_number):
            if it == 0:
                sim.sim(sim_time=90, one_lap=True, one_lap_name="ego")
            elif it == 1:
                ego.set_ctrl_policy(mpc)
                sim.sim(sim_time=90, one_lap=True, one_lap_name="ego")
            elif it == 2:
                lmpc.add_trajectory(ego, 0)
                lmpc.add_trajectory(ego, 1)
                ego.set_ctrl_policy(lmpc)
                sim.sim(sim_time=1000, one_lap=True, one_lap_name="ego")
                lmpc.add_trajectory(ego, 2)
            else:
                if it == 5:  # mid-protocol checkpoint for --direct-lmpc
                    os.makedirs("data/ego", exist_ok=True)
                    with open(f"data/ego/ego_{layout}_multi_laps.obj", "wb") as fh:
                        pickle.dump(ego, fh, protocol=pickle.HIGHEST_PROTOCOL)
                sim.sim(sim_time=1000, one_lap=True, one_lap_name="ego")
                lmpc.add_trajectory(ego, it)
        for i in range(lmpc.iter):
            print(f"lap time at iteration {i} is {lmpc.Qfun[0, i] * timestep:.2f} s")
        common.save_sim(sim, f"data/simulator/lmpc_racing_{layout}.obj")
        if args["save_trajectory"]:
            # export the fastest learned lap as the new optimal raceline
            best = int(np.argmin([lmpc.Qfun[0, i] for i in range(2, lmpc.iter)])) + 2
            T = lmpc.time_ss[best]
            np.savetxt(
                f"data/optimal_traj/xcurv_{layout}_learned.csv",
                lmpc.ss_xcurv[: T + 1, :, best], delimiter=",",
            )
            np.savetxt(
                f"data/optimal_traj/xglob_{layout}_learned.csv",
                lmpc.ss_glob[: T + 1, :, best], delimiter=",",
            )
    else:
        sim = common.load_sim(f"data/simulator/lmpc_racing_{layout}.obj")
    common.finish(sim, args, f"lmpc_racing_{layout}")


def main():
    compile_cache.enable()
    parser = argparse.ArgumentParser()
    parser.add_argument("--track-layout", type=str, default="l_shape")
    parser.add_argument("--lap-number", type=int, default=7)
    parser.add_argument("--simulation", action="store_true")
    parser.add_argument("--plotting", action="store_true")
    parser.add_argument("--animation", action="store_true")
    parser.add_argument("--direct-lmpc", action="store_true")
    parser.add_argument("--zero-noise", action="store_true")
    parser.add_argument("--save-trajectory", action="store_true")
    # not in the reference driver: run the whole protocol as fused
    # on-device rollouts (racing/protocol.py)
    parser.add_argument("--fused-protocol", action="store_true")
    parser.add_argument("--n-steps-learn", type=int, default=None)
    lmpc_racing(vars(parser.parse_args()))


if __name__ == "__main__":
    main()
