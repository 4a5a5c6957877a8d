"""Launch the realtime node graph (replaces launch/car_racing_sim.launch).

    python -m car_racing_tpu.realtime.launch --track-layout l_shape \
        --duration 10 --ctrl-policy pid
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from ..ops import track as track_ops
from ..racing import policies
from ..utils import params
from . import bus as bus_mod
from .nodes import (
    CBFControllerNode,
    ControllerNode,
    SimulatorNode,
    StagedControllerNode,
    VehicleNode,
    VisualizationNode,
)


def run(args):
    # realtime nodes tick at host rates (10-100 Hz) from multiple threads
    # on single-vehicle solves; the node graph runs on the platform
    # --platform names (CPU by default).
    import jax

    try:
        jax.config.update("jax_platforms", args.get("platform") or "cpu")
    except RuntimeError:
        pass  # backend already initialized by the embedding process
    spec = np.genfromtxt(f"data/track_layout/{args['track_layout']}.csv", delimiter=",")
    track = track_ops.build_track(spec, width=0.8)
    broker = bus_mod.spawn_broker(args["port"])
    nodes = []
    try:
        sim = SimulatorNode(track, port=args["port"]).start()
        sim.register("ego")
        nodes.append(sim)
        nodes.append(VehicleNode("ego", track, port=args["port"]).start())
        # controller modes mirror the reference's realtime controller
        # (realtime/controller.py:25-73): pid | mpc-lti | mpc-cbf | lmpc
        if args["ctrl_policy"] == "pid":
            ctrl = ControllerNode(
                "ego", track, policy=policies.PIDTracking(vt=0.6), port=args["port"]
            )
        elif args["ctrl_policy"] == "mpc-lti":
            ctrl = ControllerNode(
                "ego", track,
                policy=policies.MPCTracking(params.MPCParam.default(vt=0.6)),
                port=args["port"],
            )
        elif args["ctrl_policy"] == "mpc-cbf":
            ctrl = CBFControllerNode("ego", track, port=args["port"], vt=0.6)
        elif args["ctrl_policy"] == "lmpc":
            ctrl = StagedControllerNode("ego", track, port=args["port"], vt=0.6)
        else:
            raise ValueError(args["ctrl_policy"])
        nodes.append(ctrl.start())
        viz = VisualizationNode(
            port=args["port"], render_dir=args.get("render_dir"), track=track
        ).start()
        nodes.append(viz)
        t0 = time.time()
        while time.time() - t0 < args["duration"]:
            time.sleep(0.5)
            if "ego" in viz.latest:
                _, state = viz.latest["ego"]
                print(
                    f"t={time.time()-t0:5.1f}s ego vx={state[0]:.3f} "
                    f"s={state[4]:.2f} ey={state[5]:+.3f}"
                )
    finally:
        for n in nodes:
            n.stop()
        broker.kill()


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--track-layout", type=str, default="l_shape")
    parser.add_argument("--ctrl-policy", type=str, default="pid")
    parser.add_argument("--duration", type=float, default=10.0)
    parser.add_argument("--port", type=int, default=9123)
    parser.add_argument("--platform", type=str, default="cpu")
    parser.add_argument("--render-dir", type=str, default=None,
                        help="render live frames (PNG per tick) into this directory")
    run(vars(parser.parse_args()))
    # Exit without interpreter-shutdown unwinding: the staged controller's
    # prewarm daemon thread may still be inside an XLA compile (native
    # code), and tearing the interpreter down through it aborts with
    # "FATAL: exception not rethrown".  All nodes/broker are already
    # stopped by run()'s finally; nothing is left to flush.
    import os
    import sys

    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(0)


if __name__ == "__main__":
    main()
