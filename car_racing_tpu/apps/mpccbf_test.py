"""MPC-CBF racing demo driver (reference car_racing/tests/mpccbf_test.py).

    python -m car_racing_tpu.apps.mpccbf_test --track-layout l_shape \
        --simulation --plotting --animation
"""

import argparse

from . import common
from ..racing import policies, vehicles
from ..utils import compile_cache, params


def racing(args):
    layout = args["track_layout"]
    if args["simulation"]:
        track = common.build_track(layout, width=1.0)
        ego = common.build_ego(track, zero_noise=args.get("zero_noise", False))
        sim = common.build_sim(track)
        sim.add_vehicle(ego)
        policy = policies.MPCCBFRacing(params.MPCCBFParam.default(vt=0.8))
        common.attach_policy(ego, sim, policy)
        for i, (s_coef, ey_coef) in enumerate((([0.2, 4.0], [0.0, 0.1]), ([0.2, 10.0], [0.0, -0.1]))):
            car = vehicles.NoDynamicsModel(name=f"car{i+1}")
            car.set_track(track)
            car.set_state_curvilinear_func(s_coef, ey_coef)
            car.start_logging()
            sim.add_vehicle(car)
        sim.sim(sim_time=50.0)
        common.save_sim(sim, f"data/simulator/mpccbf_{layout}.obj")
    else:
        sim = common.load_sim(f"data/simulator/mpccbf_{layout}.obj")
    common.finish(sim, args, f"mpccbf_{layout}")


def main():
    compile_cache.enable()
    parser = argparse.ArgumentParser()
    parser.add_argument("--simulation", action="store_true")
    parser.add_argument("--plotting", action="store_true")
    parser.add_argument("--animation", action="store_true")
    parser.add_argument("--zero-noise", action="store_true")
    parser.add_argument("--track-layout", type=str, default="l_shape")
    racing(vars(parser.parse_args()))


if __name__ == "__main__":
    main()
