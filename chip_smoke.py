"""Smoke run of the racing stack on one NVIDIA GPU, in one process.

    python chip_smoke.py            # one card: every phase below
    python chip_smoke.py --multi    # four cards: the mesh path only

Phases (one card): 1 device check, 2 kernels at real widths against their
references and the matmul precision probe, 3 the CLI drivers' entry points
in-process, 4 the flagship fused path (racing-game lap gate, every step of
the CPU's f32 LMPC lap replayed on the GPU, fused vs host loop), 5
production width (64-lane fleet, 256-branch corridor sweep vs the CPU), 6
the ``gpu``-marked tests via ``pytest.main``.  XLA runs at its default
settings, as every other entry point of the package does.  Each
check prints what it measured, its bound, and the compile and run seconds.
Every phase runs; any failure makes the script exit non-zero without the
final line.  The last line is one JSON object naming the device.

It refuses to run without a GPU (no CPU fallback), and opens the card once:
a second JAX process on the same card would not get device memory.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import re
import sys
import time
import traceback

ROOT = os.path.dirname(os.path.abspath(__file__))


def require_gpu(devices) -> None:
    """Exit non-zero unless the first JAX device is a GPU."""
    if not devices or devices[0].platform != "gpu":
        found = devices[0].platform if devices else "none"
        raise SystemExit(f"chip_smoke: needs a GPU, JAX found platform '{found}'")


class Phases:
    """Runs named checks, timing compile (lowering + XLA) apart from the
    rest via JAX's monitoring events, and remembers failures."""

    _COMPILE_EVENTS = ("/jax/core/compile/jaxpr_to_mlir_module_duration",
                       "/jax/core/compile/backend_compile_duration")

    def __init__(self):
        import jax

        self.compile_s = 0.0
        self.failed: list[str] = []
        jax.monitoring.register_event_duration_secs_listener(self._on_event)

    def _on_event(self, event, duration, **_):
        if event in self._COMPILE_EVENTS:
            self.compile_s += duration

    def run(self, name, fn, *args, **kwargs):
        c0, t0 = self.compile_s, time.perf_counter()
        try:
            result = fn(*args, **kwargs)
            status = "ok"
        except Exception as e:  # noqa: BLE001 — recorded, then exit non-zero
            result = f"{type(e).__name__}: {e}"
            status = "FAILED"
            self.failed.append(name)
            traceback.print_exc(file=sys.stderr)
        wall = time.perf_counter() - t0
        comp = self.compile_s - c0
        print(f"[{status}] {name}: {json.dumps(result, default=str)} "
              f"(compile {comp:.1f} s, run {wall - comp:.1f} s)", flush=True)
        return result if status == "ok" else None


# ---------------------------------------------------------------------------
# phase 3: the CLI drivers, called in-process
# ---------------------------------------------------------------------------

def app_tracking():
    from car_racing_tpu.apps import common, control_test

    control_test.tracking({"ctrl_policy": "mpc-lti", "track_layout": "l_shape",
                           "simulation": True, "zero_noise": True})
    sim = common.load_sim("data/simulator/mpc-lti_l_shape.obj")
    ego = sim.vehicles["ego"]
    import numpy as np

    traj = sim.full_trajectory("ego", kind="xcurv")
    ey = float(np.abs(traj[:, 5]).max())
    assert ego.laps >= 1, f"no lap completed ({ego.laps})"
    assert np.isfinite(traj).all() and ey < 0.8, f"|ey| {ey:.3f} vs width 0.8"
    return {"laps": int(ego.laps), "max_abs_ey": ey, "bound_ey": 0.8}


def _lap_times(text):
    return [float(t) for t in re.findall(r"lap time at iteration \d+ is ([\d.]+) s", text)]


def app_fused_protocol():
    from car_racing_tpu.apps import lmpc_test

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        lmpc_test.fused_protocol({"track_layout": "l_shape", "lap_number": 3})
    laps = _lap_times(buf.getvalue())
    assert len(laps) == 3, buf.getvalue()
    assert laps[-1] < laps[0], f"learned lap {laps[-1]} s not faster than PID {laps[0]} s"
    return {"lap_times_s": laps}


def app_racing_overtake():
    from car_racing_tpu.apps import common, overtake_planner_test

    args = {"track_layout": "l_shape", "lap_number": 4, "simulation": True,
            "zero_noise": True, "number_other_agents": 2, "direct_lmpc": False,
            "diff_alpha": False, "multi_tests": False, "sim_replay": False,
            "random_other_agents": False, "save_trajectory": False}
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        overtake_planner_test.racing_overtake(args)
    laps = _lap_times(buf.getvalue())
    sim = common.load_sim("data/simulator/racing_game_l_shape.obj")
    assert len(laps) == 4, buf.getvalue()[-2000:]
    assert laps[-1] < laps[0], f"racing lap {laps[-1]} s not faster than PID {laps[0]} s"
    assert len(sim.vehicles) == 3, sorted(sim.vehicles)
    return {"lap_times_s": laps, "vehicles": sorted(sim.vehicles)}


# ---------------------------------------------------------------------------
# phases 4-5
# ---------------------------------------------------------------------------

def fused_vs_host(n_steps: int = 60, tol: float = 1e-4):
    """Fused MPC-LTI rollout vs the host loop, both on the GPU.  On the CPU
    the two agree to 1e-9; on the GPU they are separately compiled
    programs (fusion and libdevice differ in the last ulps of f32), so the
    bound is ``tol`` in every state."""
    import numpy as np
    import jax.numpy as jnp

    from car_racing_tpu.ops import dynamics, track as track_ops
    from car_racing_tpu.racing import fused, policies, simulator, vehicles
    from car_racing_tpu.utils import params
    from car_racing_tpu.utils.constants import X_DIM

    track = track_ops.load_track("l_shape", width=0.8)
    mpc_param = params.MPCParam.default(vt=0.8)
    sysp = params.SystemParam.default()
    xs, _ = fused.rollout_mpc_tracking(
        track, dynamics.BicycleParams.default(), mpc_param, sysp,
        jnp.asarray([0.8, 0, 0, 0, 0, 0.0]), jnp.zeros(X_DIM), jnp.zeros(X_DIM),
        n_steps=n_steps,
    )
    ego = vehicles.DynamicBicycleModel(name="ego", system_param=sysp)
    ego.set_zero_noise()
    ego.set_state_curvilinear(np.zeros(X_DIM))
    ego.set_state_global(np.zeros(X_DIM))
    ego.start_logging()
    sim = simulator.CarRacingSim()
    sim.set_timestep(0.1)
    sim.set_track(track)
    sim.add_vehicle(ego)
    pol = policies.MPCTracking(mpc_param, sysp)
    pol.set_timestep(0.1)
    pol.set_track(track)
    pol.set_racing_sim(sim)
    ego.set_ctrl_policy(pol)
    sim.sim(sim_time=n_steps * 0.1)
    host = np.asarray(ego.xcurv_log)
    m = min(len(host), n_steps)
    dev = float(np.max(np.abs(np.asarray(xs)[1 : m + 1] - host[:m])))
    assert dev < tol, f"fused vs host max |dx| {dev:.2e} (bound {tol:g})"
    return {"steps": m, "max_abs_dev": dev, "tol": tol, "precision": "f32, highest"}


def corridor_sweep_vs_cpu(mesh_gpu, x_tol: float = 1e-3):
    """256-branch corridor sweep (64 scenarios x 4 corridors, N=10) on
    ``mesh_gpu`` against the same sweep on a one-device CPU mesh: the same
    winning branch in every scenario and ``X_best`` within ``x_tol``, the
    f32 IPM's stopping tolerance: converged iterates differ by solver noise
    between cuSOLVER and LAPACK factorizations."""
    import numpy as np
    import jax
    from jax.sharding import Mesh

    from car_racing_tpu.parallel import mesh as mesh_mod, scaling

    inputs = scaling.corridor_sweep_inputs(64, 10)
    gpu = mesh_mod.corridor_sweep(mesh_gpu, *inputs, num_horizon=10)
    cpu_dev = jax.devices("cpu")[0]
    mesh_cpu = Mesh(np.asarray([cpu_dev]).reshape(1, 1), ("scenario", "branch"))
    cpu_in = jax.device_put(inputs, cpu_dev)
    cpu = mesh_mod.corridor_sweep(mesh_cpu, *cpu_in, num_horizon=10)
    best_g, best_c = np.asarray(gpu[0]), np.asarray(cpu[0])
    same = int((best_g == best_c).sum())
    dx = float(np.max(np.abs(np.asarray(gpu[1]) - np.asarray(cpu[1]))))
    assert same == len(best_c), f"winners differ in {len(best_c) - same} of {len(best_c)} scenarios"
    assert dx < x_tol, f"X_best differs by {dx:.2e} (bound {x_tol:g})"
    return {"scenarios": len(best_c), "branches": 256, "same_winner": same,
            "max_abs_dX_best": dx, "tol": x_tol,
            "devices": sorted({d.id for d in gpu[1].devices()})}


def memory_of_racing_step(fx, n_steps: int = 250):
    from car_racing_tpu.racing import fused

    lowered = fused.rollout_racing_game.lower(
        fx["track"], fx["bike"], fx["lmpc_param"], fx["rg_param"], fx["sys_param"],
        fx["xcurv0"], fx["xglob0"], *fx["seed"], *fx["traffic"], fx["opti"],
        n_steps=n_steps,
    )
    m = lowered.compile().memory_analysis()
    return {k: getattr(m, k) for k in (
        "argument_size_in_bytes", "output_size_in_bytes", "temp_size_in_bytes",
        "generated_code_size_in_bytes") if hasattr(m, k)}


def gpu_tests():
    import pytest

    class Count:
        passed = 0

        def pytest_runtest_logreport(self, report):
            if report.when == "call" and report.passed:
                Count.passed += 1

    os.environ["CAR_RACING_TEST_PLATFORM"] = "device"
    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                      os.path.join(ROOT, "tests", "test_gpu.py")], plugins=[Count()])
    os.chdir(ROOT)
    assert rc == 0 and Count.passed > 0, f"pytest exit {rc}, {Count.passed} passed"
    return {"passed": Count.passed, "exit_code": int(rc)}


# ---------------------------------------------------------------------------
# --multi: the mesh path on four cards
# ---------------------------------------------------------------------------

def multi_phases(ph, n: int = 4):
    import numpy as np
    import jax
    import jax.numpy as jnp

    from car_racing_tpu.parallel import mesh as mesh_mod, scaling
    from car_racing_tpu.utils import device_checks as dc

    assert len(jax.devices()) >= n, f"--multi needs {n} GPUs, found {len(jax.devices())}"
    mesh_n, mesh_1 = mesh_mod.make_mesh(n), mesh_mod.make_mesh(1)

    def sweep(x_tol=1e-3):
        inputs = scaling.corridor_sweep_inputs(64, 10)
        one = mesh_mod.corridor_sweep(mesh_1, *inputs, num_horizon=10)
        many = mesh_mod.corridor_sweep(mesh_n, *inputs, num_horizon=10)
        same = int((np.asarray(one[0]) == np.asarray(many[0])).sum())
        dx = float(np.max(np.abs(np.asarray(one[1]) - np.asarray(many[1]))))
        devs = sorted({d.id for d in many[4].devices()})
        assert same == 64, f"winners differ in {64 - same} scenarios"
        assert dx < x_tol, f"X_best differs by {dx:.2e} (bound {x_tol:g})"
        assert len(devs) == n, f"sweep landed on devices {devs}"
        return {"mesh": dict(mesh_n.shape), "same_winner": same, "max_abs_dX_best": dx,
                "tol": x_tol, "devices": devs}

    def fleet(lanes=64, n_steps=250):
        """The sharded fleet against the single-card fleet from the same
        starts: every lane of both passes the racing-lane gate, lane b of
        each starts from start b, the lap-step distributions agree
        (``device_checks.compare_fleets``), and the shards sit on all four
        cards."""
        fx = dc.fixture()
        xc0, xg0 = dc.fleet_starts(fx, lanes)
        one_out = jax.device_get(dc.racing_fleet(fx, xc0, xg0, n_steps=n_steps))
        one = dc.check_fleet(fx, one_out, n_steps)
        many = mesh_mod.fleet_rollout(
            mesh_n, fx["track"], fx["bike"], fx["lmpc_param"], fx["rg_param"],
            fx["sys_param"], xc0, xg0, *fx["seed"], *fx["traffic"], fx["opti"],
            n_steps=n_steps)
        shard_devs = sorted(s.device.id for s in many[0].addressable_shards)
        many_out = jax.device_get(many)
        sharded = dc.check_fleet(fx, many_out, n_steps)
        same = dc.compare_fleets(many_out, one_out, xc0)
        assert len(set(shard_devs)) == n, f"fleet shards on devices {shard_devs}"
        peaks = [(d.memory_stats() or {}).get("peak_bytes_in_use", 0) for d in jax.devices()[:n]]
        assert all(p > 0 for p in peaks), f"a device stayed unused: peaks {peaks}"
        return {"lanes": lanes, "steps": n_steps, "single_card": one, "sharded": sharded,
                "sharded_vs_single": same, "shard_devices": shard_devs,
                "peak_bytes_per_device": peaks}

    def exchange():
        lap = jnp.asarray(np.random.default_rng(0).normal(
            size=(mesh_n.shape["scenario"], 8, 6)), jnp.float32)
        full = mesh_mod.safe_set_exchange(mesh_n, lap)
        devs = sorted(s.device.id for s in full.addressable_shards)
        for s in full.addressable_shards:
            np.testing.assert_array_equal(np.asarray(s.data), np.asarray(lap))
        assert full.sharding.is_fully_replicated and len(devs) == n, devs
        return {"replicated_on": devs}

    ph.run("multi: corridor_sweep 256 branches, 4 cards vs 1", sweep)
    ph.run("multi: fleet_rollout 64 lanes, 4 cards vs 1", fleet)
    ph.run("multi: safe_set_exchange", exchange)


# ---------------------------------------------------------------------------

def main(argv) -> int:
    multi = "--multi" in argv
    import jax

    require_gpu(jax.devices())
    os.chdir(ROOT)
    sys.path.insert(0, ROOT)
    from car_racing_tpu.utils import compile_cache

    cache_dir = compile_cache.enable()
    from car_racing_tpu.utils import device_checks as dc, numerics

    dev = jax.devices()[0]
    print(f"card: {dc.card()}", flush=True)
    print(f"device: platform={dev.platform} kind={dev.device_kind} "
          f"count={len(jax.devices())}; compile cache: {cache_dir}; "
          f"matmul precision: {numerics.PRECISION}; "
          f"XLA_FLAGS: {os.environ.get('XLA_FLAGS', '(unset)')}", flush=True)
    ph = Phases()

    if multi:
        multi_phases(ph)
    else:
        from car_racing_tpu.parallel import mesh as mesh_mod

        fx = dc.fixture()
        # 2. kernels at real widths against their references
        ph.run("kernel: fused integrator vs scan, 64 lanes, one period (f32)",
               dc.integrator_deviation, fx)
        ph.run("precision: f32 matmul (512, 512) vs float64 numpy", dc.matmul_error)
        for n in (20, 40):
            ph.run(f"solver: solve_batched (256, {n}, {n}) vs float64 numpy",
                   dc.spd_solve_error, n, 256)
        ph.run("solver: solve_multi_batched (256, 20, 20) x 6 rhs vs float64 numpy",
               dc.spd_solve_error, 20, 256, 6)
        ph.run("memory_analysis: fused racing-game lap (250 steps)",
               memory_of_racing_step, fx)
        # 3. entry points, in-process
        ph.run("app: control_test.tracking mpc-lti l_shape", app_tracking)
        ph.run("app: lmpc_test.fused_protocol l_shape, 3 laps", app_fused_protocol)
        ph.run("app: overtake_planner_test.racing_overtake l_shape, 4 laps",
               app_racing_overtake)

        # 4. the flagship fused path
        def racing_lap():
            xc, _, ot, ls = dc.racing_game(fx)
            return dc.check_racing_lane(fx, xc, ot, ls, 250)

        def gpu_vs_cpu_lap():
            ref_cpu = dc.lmpc_lap(dc.fixture(jax.devices("cpu")[0]), return_carries=True)
            out_gpu = dc.lmpc_lap(fx)
            r = dc.check_replay(dc.lmpc_replay_error(ref_cpu, fx), dc.CROSS_DEVICE_TOL)
            r.update(dc.check_lap_feasible(out_gpu), lap_steps_gpu=int(out_gpu[3]),
                     lap_steps_cpu=int(ref_cpu[3]), precision="f32, matmul highest")
            return r

        ph.run("flagship: racing-game lap gate (250 steps)", racing_lap)
        ph.run("flagship: LMPC lap, each CPU step replayed on the GPU", gpu_vs_cpu_lap)
        ph.run("flagship: fused MPC-LTI vs host loop, both on GPU", fused_vs_host)

        # 5. production width
        def fleet64():
            xc0, xg0 = dc.fleet_starts(fx, 64)
            return dc.check_fleet(fx, dc.racing_fleet(fx, xc0, xg0), 250)

        ph.run("width: 64-lane racing-game fleet, every lane gated", fleet64)
        ph.run("width: 256-branch corridor sweep vs CPU", corridor_sweep_vs_cpu,
               mesh_mod.make_mesh(1))
        # 6. the gpu-marked tests, same process
        ph.run("tests: pytest -m gpu tests/test_gpu.py", gpu_tests)

    if ph.failed:
        print(f"chip_smoke: {len(ph.failed)} check(s) failed: {ph.failed}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind, "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
