"""Racing-game overtake driver (reference car_racing/tests/overtake_planner_test.py).

Full pipeline: PID lap -> MPC lap -> LMPC laps; prescribed/random other
vehicles appear on the final lap and the overtake planner + multi-agent
CBF tracker take over near traffic.

    python -m car_racing_tpu.apps.overtake_planner_test --track-layout l_shape \
        --lap-number 4 --simulation --zero-noise --number-other-agents 2
"""

import argparse
import pickle
import random

import numpy as np

from . import common
from ..racing import policies, vehicles
from ..utils import compile_cache, params


def racing_overtake(args):
    layout = args["track_layout"]
    lap_number = args["lap_number"] or 4
    num_veh = args["number_other_agents"] or 2
    timestep = 0.1
    alphas = [1.0, 0.9, 0.8, 0.7, 0.6, 0.5] if args["diff_alpha"] else [0.8]
    runs = 100 if args["multi_tests"] else 1
    for alpha in alphas:
        for run in range(runs):
            if not args["simulation"]:
                sim = common.load_sim(f"data/simulator/racing_game_{layout}.obj")
                common.finish(sim, args, f"racing_game_{layout}", racing_game=True)
                return
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
            mesh = None
            if args.get("mesh_planner"):
                # opt-in multi-chip planner dispatch: corridor QPs +
                # fallback + selection shard over all local devices
                from ..parallel import mesh as mesh_mod

                mesh = mesh_mod.make_branch_mesh()
            import dataclasses as _dc

            rg_param = params.RacingGameParam.default(alpha=alpha)
            if args.get("corridor_hold") is not None:
                rg_param = _dc.replace(
                    rg_param, corridor_hold=float(args["corridor_hold"])
                )
            lmpc = policies.LMPCRacingGame(
                params.LMPCParam.default(),
                racing_game_param=rg_param,
                timestep=timestep,
                lap_number=lap_number,
                time_lmpc=10000 * timestep,
                path_planner=args.get("path_planner", False),
                mesh=mesh,
            )
            lmpc.set_track(track)
            lmpc.set_timestep(timestep)
            lmpc.set_opti_traj(opti_traj_xcurv, opti_traj_xglob)
            lmpc.openloop_prediction = policies.LMPCPrediction(lap_number=lap_number)
            lmpc.set_racing_sim(sim)
            lmpc.set_vehicles_track()

            # --sim-replay reuses the other vehicles' initial conditions from
            # the previously saved run (reference overtake_planner_test.py:61-74)
            replay_inits = None
            if args["sim_replay"]:
                saved = common.load_sim(f"data/simulator/racing_game_{layout}.obj")
                replay_inits = []
                for i in range(len(saved.vehicles) - 1):
                    car = saved.vehicles[f"car{i+1}"]
                    # completed-lap log if the car finished one, else the
                    # in-progress lap log (prescribed cars rarely lap)
                    xc0 = np.asarray(car.xcurvs[0][0] if car.xcurvs else car.lap_xcurvs[0])
                    replay_inits.append((float(xc0[0]), float(xc0[4]), float(xc0[5])))
                num_veh = len(replay_inits)

            others = []
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
                    if it == 5 and args["save_trajectory"]:
                        # mid-protocol multi-lap ego checkpoint for --direct-lmpc
                        # restarts (reference overtake_planner_test.py:140-146)
                        import os

                        os.makedirs("data/ego", exist_ok=True)
                        with open(f"data/ego/ego_{layout}_multi_laps.obj", "wb") as fh:
                            pickle.dump(ego, fh, protocol=pickle.HIGHEST_PROTOCOL)
                    if it == lap_number - 1:
                        for i in range(num_veh):
                            car = vehicles.NoDynamicsModel(name=f"car{i+1}")
                            car.set_track(track)
                            if replay_inits is not None:
                                v, s0, ey0 = replay_inits[i]
                            elif args["random_other_agents"] or args["multi_tests"]:
                                v = random.uniform(0.4, 0.8)
                                s0 = random.uniform(2.0, 10.0)
                                ey0 = random.uniform(-0.6, 0.6)
                            else:
                                v, s0, ey0 = 0.7 + i * 0.02, 5.5 + i * 2.0, -0.5 + i * 0.3
                            car.set_state_curvilinear_func([v, s0], [0.0, ey0])
                            car.start_logging()
                            sim.add_vehicle(car)
                            others.append(car)
                    sim.sim(sim_time=1000, one_lap=True, one_lap_name="ego")
                    lmpc.add_trajectory(ego, it)
            for i in range(lmpc.iter):
                print(f"lap time at iteration {i} is {lmpc.Qfun[0, i] * timestep:.2f} s")
            common.save_sim(sim, f"data/simulator/racing_game_{layout}.obj")
            common.finish(sim, args, f"racing_game_{layout}", racing_game=True)


def main():
    compile_cache.enable()
    parser = argparse.ArgumentParser()
    parser.add_argument("--track-layout", type=str, default="l_shape")
    parser.add_argument("--lap-number", type=int, default=4)
    parser.add_argument("--simulation", action="store_true")
    parser.add_argument("--plotting", action="store_true")
    parser.add_argument("--animation", action="store_true")
    parser.add_argument("--direct-lmpc", action="store_true")
    parser.add_argument("--sim-replay", action="store_true")
    parser.add_argument("--zero-noise", action="store_true")
    parser.add_argument("--diff-alpha", action="store_true")
    parser.add_argument("--random-other-agents", action="store_true")
    parser.add_argument("--number-other-agents", type=int, default=2)
    parser.add_argument("--save-trajectory", action="store_true")
    parser.add_argument("--multi-tests", action="store_true")
    parser.add_argument(
        "--mesh-planner", action="store_true",
        help="shard the overtake planner's corridor QPs over all local "
             "devices (parallel/mesh.corridor_sweep)",
    )
    parser.add_argument(
        "--corridor-hold", type=float, default=None,
        help="hold the planner's corridor no-overlap rows while "
             "|s_pred - obs_s| <= vehicle_length + HOLD metres "
             "(default 0.15 = reference behavior; larger values prevent "
             "cutting back across a car still alongside — see PARITY.md)",
    )
    parser.add_argument(
        "--path-planner", action="store_true",
        help="use the path-based overtake planner (ey-profile corridor "
             "QPs, planning/overtake.OvertakePathPlanner) instead of the "
             "trajectory planner — the dispatch the reference hardcodes "
             "off (base.py:414)",
    )
    racing_overtake(vars(parser.parse_args()))


if __name__ == "__main__":
    main()
