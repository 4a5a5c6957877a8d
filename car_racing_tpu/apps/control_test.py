"""Tracking-controller demo driver (reference car_racing/tests/control_test.py).

    python -m car_racing_tpu.apps.control_test --ctrl-policy mpc-lti \
        --track-layout l_shape --simulation --plotting --animation
"""

import argparse

from . import common
from ..racing import policies
from ..utils import compile_cache, params


def tracking(args):
    layout = args["track_layout"]
    if args["simulation"]:
        track = common.build_track(layout)
        ego = common.build_ego(track, zero_noise=args.get("zero_noise", False))
        sim = common.build_sim(track)
        sim.add_vehicle(ego)
        if args["ctrl_policy"] == "pid":
            policy = policies.PIDTracking(vt=0.8)
        elif args["ctrl_policy"] == "mpc-lti":
            policy = policies.MPCTracking(params.MPCParam.default(vt=0.8))
        elif args["ctrl_policy"] == "lqr":
            policy = policies.LQRTracking(params.LQRParam.default(vt=0.8))
        else:
            raise ValueError(f"unknown ctrl policy {args['ctrl_policy']}")
        common.attach_policy(ego, sim, policy)
        sim.sim(sim_time=90.0)
        common.save_sim(sim, f"data/simulator/{args['ctrl_policy']}_{layout}.obj")
    else:
        sim = common.load_sim(f"data/simulator/{args['ctrl_policy']}_{layout}.obj")
    common.finish(sim, args, f"{args['ctrl_policy']}_{layout}")


def main():
    compile_cache.enable()
    parser = argparse.ArgumentParser()
    parser.add_argument("--ctrl-policy", type=str, default="mpc-lti")
    parser.add_argument("--simulation", action="store_true")
    parser.add_argument("--plotting", action="store_true")
    parser.add_argument("--animation", action="store_true")
    parser.add_argument("--zero-noise", action="store_true")
    parser.add_argument("--track-layout", type=str, default="l_shape")
    tracking(vars(parser.parse_args()))


if __name__ == "__main__":
    main()
