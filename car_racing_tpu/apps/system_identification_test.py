"""LTI system identification driver
(reference car_racing/tests/system_identification_test.py:9-48): run a PID
lap to collect data, ridge-fit (A, B), write data/sys/LTI CSVs."""

import argparse

import numpy as np

from . import common
from ..models import system_identification as sysid
from ..racing import policies
from ..utils import compile_cache


def linear_time_invariant(args):
    track = common.build_track(args["track_layout"])
    ego = common.build_ego(track, zero_noise=False)
    sim = common.build_sim(track)
    sim.add_vehicle(ego)
    policy = policies.PIDTracking(vt=0.5)
    common.attach_policy(ego, sim, policy)
    sim.sim(sim_time=500.0)
    xdata = sysid.get_xdata(ego)
    udata = sysid.get_udata(ego)
    A, B, error = sysid.linear_regression(xdata, udata, lamb=1e-9)
    print("A=\n", np.round(A, 4))
    print("B=\n", np.round(B, 4))
    print("residual max/min per channel:\n", np.round(error, 5))
    if args.get("save"):
        sysid.save_lti(A, B)


def main():
    compile_cache.enable()
    parser = argparse.ArgumentParser()
    parser.add_argument("--track-layout", type=str, default="l_shape")
    parser.add_argument("--save", action="store_true")
    linear_time_invariant(vars(parser.parse_args()))


if __name__ == "__main__":
    main()
