"""The measurements behind the GPU tier's behavioural bounds, on one GPU.

    python tools/gate_study.py [--only=laps,fleets] [--fleets=8] [--lanes=64] [--no-restart]
                               [--out=DIR]

laps    Every step of the seed-fixture LMPC lap run by a reference (the
        same f32 program on the CPU; the scan on the GPU), run again from
        the reference's carries on the GPU with the integrator kernel, the
        scan, default (TF32) matmul precision and half the integrator
        substeps, and on the CPU itself (``device_checks.lmpc_replay_error``
        and ``check_replay``); the closed laps' step counts beside them.
fleets  N 64-lane racing-game fleets (starts from seeds 0..N-1) at default
        XLA settings, every lane gated as in ``chip_smoke.py``.  Each
        controller solve's state, input, convergence flag, KKT residual and
        iteration count is recorded through a host callback, so a lane that
        fails the gate can be traced to the solve that let it go; those
        lanes, with their records, go to ``OUT/fleet_failures.npz``.
        Per fleet it also counts the overtake steps whose tracker solve
        failed (residual above ``controllers.WARM_RES_MAX``) and the longest
        run of them in one lane.  ``--no-restart`` lets a failed solve seed
        the next one, as before that bound existed.

Prints one JSON line per section and writes ``OUT/gate_study.json``, where
OUT is ``--out=DIR`` (default ``build/studies``).
"""

from __future__ import annotations

import json
import os
import sys
import time
import traceback

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
os.chdir(ROOT)

import numpy as np  # noqa: E402
import jax  # noqa: E402

from car_racing_tpu.models import controllers  # noqa: E402
from car_racing_tpu.utils import device_checks as dc, numerics  # noqa: E402

OUT = next((a.split("=", 1)[1] for a in sys.argv if a.startswith("--out=")),
           os.path.join(ROOT, "build", "studies"))
ONLY = next((a.split("=", 1)[1].split(",") for a in sys.argv if a.startswith("--only=")),
            ["laps", "fleets"])
N_FLEETS = next((int(a.split("=", 1)[1]) for a in sys.argv if a.startswith("--fleets=")), 8)
LANES = next((int(a.split("=", 1)[1]) for a in sys.argv if a.startswith("--lanes=")), 64)
if "--no-restart" in sys.argv:
    controllers.WARM_RES_MAX = float("inf")
RES: dict = {"card": dc.card(), "device": jax.devices()[0].device_kind}


def gate(run, tol=None):
    tol = dc.CROSS_DEVICE_TOL if tol is None else tol
    try:
        err = run()
    except Exception as e:  # noqa: BLE001 — recorded in the output
        return {"error": f"{type(e).__name__}: {str(e)[:300]}"}
    stats = {"median": float(np.median(err)), "p90": float(np.quantile(err, 0.9)),
             "max": float(err.max()), "steps": len(err)}
    try:
        dc.check_replay(err, tol)
        return {"pass": True, **stats}
    except AssertionError:
        return {"pass": False, **stats}


def laps():
    fx = dc.fixture()
    fx_cpu = dc.fixture(jax.devices("cpu")[0])
    ref_cpu = jax.device_get(dc.lmpc_lap(fx_cpu, return_carries=True))
    ref_scan = jax.device_get(dc.lmpc_lap(fx, backend="scan", return_carries=True))
    tf32 = _with_default_precision
    res = {
        "cpu_on_cpu": gate(lambda: dc.lmpc_replay_error(ref_cpu, fx_cpu), dc.SAME_DEVICE_TOL),
        "kernel_from_cpu": gate(lambda: dc.lmpc_replay_error(ref_cpu, fx)),
        "scan_from_cpu": gate(lambda: dc.lmpc_replay_error(ref_cpu, fx, backend="scan")),
        "kernel_tf32_from_cpu": gate(lambda: tf32(lambda: dc.lmpc_replay_error(ref_cpu, fx))),
        "kernel_half_substeps_from_cpu": gate(
            lambda: dc.lmpc_replay_error(ref_cpu, fx, sub_dt=0.002)),
        "kernel_from_gpu_scan": gate(
            lambda: dc.lmpc_replay_error(ref_scan, fx, backend="pallas"), dc.SAME_DEVICE_TOL),
        "lap_steps": {
            "cpu": int(ref_cpu[3]), "gpu_scan": int(ref_scan[3]),
            "gpu_kernel": int(dc.lmpc_lap(fx)[3]),
            "gpu_kernel_tf32": int(tf32(lambda: dc.lmpc_lap(fx))[3]),
            "gpu_kernel_half_substeps": int(dc.lmpc_lap(fx, sub_dt=0.002)[3]),
        },
    }
    res["matmul_tf32"] = tf32(_probe)
    res["matmul_pinned"] = _probe()
    return res


def _with_default_precision(fn):
    """``fn()`` with the package's matmul pin at the platform default (TF32
    on an H100)."""
    numerics.PRECISION = "default"
    try:
        return fn()
    finally:
        numerics.PRECISION = "highest"


def _probe():
    try:
        return dc.matmul_error()
    except AssertionError as e:
        return {"fail": str(e)}


class Recorder:
    """Host-side log of every controller solve: (branch, x, u, converged,
    kkt_res, iterations).  Under the fleet's vmap the callback runs once per
    lane; under its lax.cond both branches run, the flags say which acted."""

    def __init__(self):
        self.rows: list = []

    def log(self, branch, x, u, conv, res, iters):
        self.rows.append((int(branch), np.asarray(x), np.asarray(u), bool(conv),
                          float(res), int(iters)))

    def install(self):
        lmpc, tracker = controllers.lmpc, controllers.mpc_multi_agents

        def lmpc_logged(x, *a, **k):
            U, X, sol = lmpc(x, *a, **k)
            jax.debug.callback(self.log, 0, x, U[0], sol.converged, sol.kkt_res,
                               sol.iterations)
            return U, X, sol

        def tracker_logged(x, *a, **k):
            u0, U, X, sol = tracker(x, *a, **k)
            jax.debug.callback(self.log, 1, x, u0, sol.converged, sol.kkt_res,
                               sol.iterations)
            return u0, U, X, sol

        controllers.lmpc, controllers.mpc_multi_agents = lmpc_logged, tracker_logged

    def index(self):
        index = {}
        for r in self.rows:
            index.setdefault(r[1].tobytes(), []).append(r)
        return index

    def for_lane(self, xc, lap, L, index=None):
        """The records whose state matches this lane's step k, per step."""
        index = self.index() if index is None else index
        out = []
        for k in range(lap + 1):
            x = np.array(xc[k], np.float32)
            x[4] = np.float32(np.mod(x[4], np.float32(L)))
            out.append([(r[0], r[2].tolist(), r[3], r[4], r[5])
                        for r in index.get(x.tobytes(), [])])
        return out


def fleets():
    rec = Recorder()
    rec.install()
    fx = dc.fixture()
    L = float(np.asarray(fx["track"].lap_length))
    summary, failures = [], {}
    for seed in range(N_FLEETS):
        rec.rows.clear()
        xc0, xg0 = dc.fleet_starts(fx, LANES, seed=seed)
        t0 = time.perf_counter()
        out = jax.device_get(dc.racing_fleet(fx, xc0, xg0))
        wall = time.perf_counter() - t0
        xc, _, ot, ls = out
        bad = []
        index = rec.index()
        failed_solves, longest = 0, 0
        for b in range(xc.shape[0]):
            lap = min(int(ls[b]), 249)
            run = 0
            for k, rs in enumerate(rec.for_lane(xc[b], lap, L, index)[:lap]):
                bad_now = ot[b][k] and any(r[0] == 1 and r[3] >= controllers.WARM_RES_MAX
                                           for r in rs)
                failed_solves += bad_now
                run = run + 1 if bad_now else 0
                longest = max(longest, run)
            try:
                dc.check_racing_lane(fx, xc[b], ot[b], ls[b], 250, f"lane {b}: ")
            except AssertionError as e:
                bad.append(str(e))
                failures[f"seed{seed}_lane{b}"] = {
                    "xc": xc[b], "us": out[1][b], "ot": ot[b], "lap": int(ls[b]),
                    "solves": rec.for_lane(xc[b], min(int(ls[b]), 249), L, index)}
        summary.append({"seed": seed, "wall_s": wall, "lap_median": float(np.median(ls)),
                        "max_abs_ey": float(np.abs(xc[:, :, 5]).max()), "failed": bad,
                        "unconverged_solves": int(sum(not r[3] for r in rec.rows)),
                        "solves": len(rec.rows), "failed_tracker_solves": int(failed_solves),
                        "longest_failed_run": longest})
        print(json.dumps(summary[-1]), flush=True)
    if failures:
        np.savez(os.path.join(OUT, "fleet_failures.npz"),
                 **{f"{k}_{f}": np.asarray(v[f]) for k, v in failures.items()
                    for f in ("xc", "us", "ot", "lap")})
        with open(os.path.join(OUT, "fleet_failures.json"), "w") as fh:
            json.dump({k: v["solves"] for k, v in failures.items()}, fh)
    return {"fleets": summary, "failed_lanes": sorted(failures)}


def main():
    os.makedirs(OUT, exist_ok=True)
    print(json.dumps({"card": RES["card"], "device": RES["device"]}), flush=True)
    for name, fn in (("laps", laps), ("fleets", fleets)):
        if name not in ONLY:
            continue
        t0 = time.perf_counter()
        try:
            RES[name] = fn()
        except Exception:  # noqa: BLE001 — recorded in the output
            RES[name] = {"error": traceback.format_exc()[-3000:]}
        RES[name + "_wall_s"] = time.perf_counter() - t0
        print(name, json.dumps(RES[name], default=str), flush=True)
        with open(os.path.join(OUT, "gate_study.json"), "w") as fh:
            json.dump(RES, fh, indent=1, default=str)


if __name__ == "__main__":
    main()
