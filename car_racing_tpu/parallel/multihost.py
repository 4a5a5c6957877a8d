"""Multi-host (multi-process) execution of the racing-game parallel paths.

SURVEY §5.8's distributed design is a single SPMD program over several
hosts: ``jax.distributed.initialize`` per host, branch batches laid out
with ``shard_map`` over a ('host','branch')-shaped mesh, intra-host
collectives for the branch argmin, inter-host ones for the safe-set
exchange.
The reference's analog spans OS processes two ways — one process per
overtake corridor joined through Manager dicts
(/root/reference/car_racing/planning/overtake_traj_planner.py:177-197) and
a ROS node graph over TCPROS
(/root/reference/car_racing/racing/realtime/simulator.py:54-83).

This module is the inter-process half of that design, runnable on one
machine as N local CPU processes:

- each worker process calls :func:`initialize` (``jax.distributed`` with a
  localhost coordinator, gloo CPU collectives, K virtual devices per
  process), after which ``jax.devices()`` spans every process;
- :func:`spanning_mesh` lays the global devices out as
  ``('scenario', 'branch')`` with the **scenario axis across processes**
  (the inter-host axis — safe-set exchange crosses it) and each process's
  local devices on the **branch axis** (the intra-host axis — the corridor
  argmin's all_gather/psum stay intra-process);
- :func:`worker` runs the REAL programs on that spanning mesh — the
  planner's corridor branch sweep (`mesh.corridor_sweep`, identical QPs,
  fallback, and selection cost as the single-chip path), the LMPC safe-set
  all-gather (`mesh.safe_set_exchange`), and a small racing-game
  `mesh.fleet_rollout` — and asserts parity against a purely process-local
  single-device run of the same problems;
- :func:`launch` spawns the workers from a driving process (the pytest /
  artifact entry point) and aggregates their reports.

On real hosts the same programs run unchanged over a mesh of their GPUs;
:func:`initialize` is the CPU harness's own set-up (cpu platform, gloo).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile

import numpy as np

# Default coordinator port; worker/launcher agree through argv so parallel
# pytest sessions can override it.
DEFAULT_PORT = 9941


def initialize(process_id: int, num_processes: int, local_devices: int,
               port: int = DEFAULT_PORT) -> None:
    """Join the process-spanning JAX runtime (call before any device use).

    Selects the cpu platform (the harness runs beside any accelerator
    without touching it), carves ``local_devices`` virtual devices out of
    this process, selects gloo TCP collectives — the CPU stand-in for the
    interconnect — and connects to the coordination service. After this returns, ``jax.devices()`` lists
    ``num_processes * local_devices`` devices and collectives span them.
    """
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", local_devices)
    jax.config.update("jax_cpu_collectives_implementation", "gloo")
    jax.distributed.initialize(
        coordinator_address=f"127.0.0.1:{port}",
        num_processes=num_processes,
        process_id=process_id,
    )


def spanning_mesh():
    """('scenario', 'branch') mesh over ALL processes' devices: scenario
    spans processes (inter-host axis), branch stays within each process
    (intra-host axis)."""
    import jax
    from jax.sharding import Mesh

    n_proc = jax.process_count()
    n_local = len(jax.local_devices())
    devs = sorted(jax.devices(), key=lambda d: (d.process_index, d.id))
    return Mesh(np.asarray(devs).reshape(n_proc, n_local), ("scenario", "branch"))


def _put(mesh, value, spec):
    """Shard a host-global value onto the spanning mesh (every process holds
    the full value; device_put places only the locally-addressable shards)."""
    import jax
    from jax.sharding import NamedSharding

    v = np.asarray(value)
    if v.dtype == np.float64:
        # pre-canonicalize: multi-process device_put cross-checks values
        # through a broadcast whose f64->f32 canonicalization differs from
        # the local path, tripping its equality assert on equal values
        v = v.astype(np.float32)
    return jax.device_put(v, NamedSharding(mesh, spec))


def _gather(x) -> np.ndarray:
    """Fetch a (possibly non-addressable) global array to the host."""
    from jax.experimental import multihost_utils

    return np.asarray(multihost_utils.process_allgather(x, tiled=True))


def worker(process_id: int, num_processes: int, local_devices: int,
           port: int, out_path: str, repo_root: str,
           fleet: bool = True) -> dict:
    """Run the spanning-mesh programs and the process-local oracle; assert
    parity; write a JSON report. Every process executes this identically
    (SPMD) — asserts fire in all of them."""
    initialize(process_id, num_processes, local_devices, port)

    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, PartitionSpec as P

    from . import mesh as mesh_mod, scaling

    os.chdir(repo_root)  # data CSV paths are repo-root relative
    report: dict = {
        "process_id": process_id,
        "num_processes": num_processes,
        "local_devices_per_process": local_devices,
        "global_devices": len(jax.devices()),
        "checks": {},
    }
    assert jax.process_count() == num_processes
    assert len(jax.devices()) == num_processes * local_devices

    mesh = spanning_mesh()
    # a purely process-local single-device mesh: the parity oracle runs the
    # SAME corridor_sweep program without any cross-process communication
    local_mesh = Mesh(
        np.asarray(jax.local_devices()[:1]).reshape(1, 1), ("scenario", "branch")
    )

    # ---- 1. corridor branch sweep across processes --------------------
    S, N = 8, 10
    inputs = scaling.corridor_sweep_inputs(S, N, seed=7)
    scen, br, rep = P("scenario"), P("scenario", "branch"), P()
    specs = (scen, rep, rep, rep, rep, rep, br, br, br, br, br, br, br,
             br, br, br, scen)
    sharded = tuple(_put(mesh, v, s) for v, s in zip(inputs, specs))

    best, X_best, costs, conv, _, iters_mh = mesh_mod.corridor_sweep(
        mesh, *sharded, num_horizon=N
    )
    best, X_best = _gather(best), _gather(X_best)
    costs, conv, iters_mh = _gather(costs), _gather(conv), _gather(iters_mh)

    b1, X1, c1, v1, _, it1 = mesh_mod.corridor_sweep(local_mesh, *inputs, num_horizon=N)
    np.testing.assert_array_equal(best, np.asarray(b1))
    np.testing.assert_allclose(X_best, np.asarray(X1), atol=1e-4)
    np.testing.assert_allclose(costs, np.asarray(c1), rtol=1e-4)
    np.testing.assert_array_equal(conv, np.asarray(v1))
    # observability parity across the process boundary: identical REAL
    # per-branch Newton counts
    np.testing.assert_array_equal(iters_mh, np.asarray(it1))
    report["checks"]["corridor_sweep_parity"] = {
        "ok": True,
        "scenarios": S,
        "branches": int(costs.shape[1]),
        "winning_branches": [int(b) for b in best],
    }

    # ---- 2. safe-set exchange across the process boundary -------------
    lap = np.random.default_rng(3).normal(size=(mesh.shape["scenario"], 8, 6))
    full = mesh_mod.safe_set_exchange(mesh, jnp.asarray(lap, jnp.float32))
    assert full.sharding.is_fully_replicated
    # replication across processes: every process's local shard is the FULL
    # array and matches the host value bit-for-bit
    local = np.asarray(full.addressable_shards[0].data)
    np.testing.assert_allclose(local, lap.astype(np.float32), rtol=0, atol=0)
    report["checks"]["safe_set_exchange"] = {
        "ok": True,
        "bytes_exchanged": int(lap.size * 4),
    }

    # ---- 3. a small racing-game fleet spanning every process ----------
    if fleet:
        from ..ops import dynamics, track as track_ops
        from ..utils import params as params_mod

        tonp = lambda t: jax.tree.map(np.asarray, t)
        spec_csv = np.genfromtxt("data/track_layout/l_shape.csv", delimiter=",")
        track = tonp(track_ops.build_track(spec_csv, width=1.0))
        seed = np.load("data/bench/lmpc_seed_l_shape.npz")
        B = num_processes * local_devices
        rng = np.random.default_rng(1)
        pert = np.zeros((B, 6), np.float64)
        pert[:, 5] = rng.normal(0, 0.02, B)
        xc0 = np.asarray(seed["xcurv0"]) + pert
        xg0 = np.broadcast_to(np.asarray(seed["xglob0"]), (B, 6))
        opti = np.genfromtxt("data/optimal_traj/xcurv_l_shape.csv", delimiter=",")
        args = (
            track, tonp(dynamics.BicycleParams.default()),
            tonp(params_mod.LMPCParam.default()),
            tonp(params_mod.RacingGameParam.default(alpha=0.8)),
            tonp(params_mod.SystemParam.default()),
        )
        shared = (
            seed["ss1"], seed["q1"], seed["ss2"], seed["q2"],
            seed["u1"], seed["u2"], seed["valid1"], seed["valid2"],
            np.asarray(seed["counter"], np.int32),
            seed["lin_points0"], seed["lin_input0"],
            np.asarray([[0.72, 7.5], [0.7, 5.5]]),
            np.asarray([[0.0, -0.2], [0.0, -0.5]]),
            opti,
        )
        lane = P(("scenario", "branch"))
        xc_f, _, _, _ = mesh_mod.fleet_rollout(
            mesh, *args, _put(mesh, xc0, lane), _put(mesh, xg0, lane),
            *shared, n_steps=3,
        )
        xc_f = _gather(xc_f)
        assert xc_f.shape == (B, 4, 6)
        assert np.isfinite(xc_f).all()
        report["checks"]["fleet_rollout"] = {
            "ok": True, "lanes": B, "steps": 3,
        }

    with open(out_path, "w") as fh:
        json.dump(report, fh, indent=1)
        fh.write("\n")
    return report


def _worker_env() -> dict:
    """Child env: scrub the parent's forced virtual-device flag (the worker
    sizes its own device count via jax_num_cpu_devices) and any ambient
    platform pin; the worker pins cpu itself."""
    env = dict(os.environ)
    flags = env.get("XLA_FLAGS", "")
    flags = " ".join(
        f for f in flags.split() if "host_platform_device_count" not in f
    )
    if flags:
        env["XLA_FLAGS"] = flags
    else:
        env.pop("XLA_FLAGS", None)
    env.pop("JAX_PLATFORMS", None)
    return env


def launch(num_processes: int = 2, local_devices: int = 2,
           port: int = DEFAULT_PORT, fleet: bool = True,
           timeout_s: float = 900.0, repo_root: str | None = None) -> dict:
    """Spawn ``num_processes`` worker processes, wait, aggregate reports.

    Returns the aggregate dict (also the payload of MULTIHOST artifacts):
    per-process reports plus an overall ``ok``. Raises on worker failure
    with the failing worker's tail of output."""
    repo_root = repo_root or os.path.dirname(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    )
    env = _worker_env()
    procs, outs, logs, log_fhs = [], [], [], []
    with tempfile.TemporaryDirectory() as td:
        for pid in range(num_processes):
            out_path = os.path.join(td, f"worker_{pid}.json")
            log_path = os.path.join(td, f"worker_{pid}.log")
            outs.append(out_path)
            logs.append(log_path)
            cmd = [
                sys.executable, "-m", "car_racing_tpu.parallel.multihost",
                "--process-id", str(pid),
                "--num-processes", str(num_processes),
                "--local-devices", str(local_devices),
                "--port", str(port),
                "--out", out_path,
                "--repo-root", repo_root,
            ]
            if not fleet:
                cmd.append("--no-fleet")
            log_fh = open(log_path, "w")
            log_fhs.append(log_fh)
            procs.append(
                subprocess.Popen(
                    cmd, env=env, cwd=repo_root,
                    stdout=log_fh, stderr=subprocess.STDOUT,
                )
            )
        fails = []
        for fh in log_fhs:
            fh.close()
        for pid, p in enumerate(procs):
            try:
                rc = p.wait(timeout=timeout_s)
            except subprocess.TimeoutExpired:
                for q in procs:
                    q.kill()
                raise RuntimeError(
                    f"multihost worker {pid} timed out after {timeout_s}s"
                )
            if rc != 0:
                with open(logs[pid]) as fh:
                    tail = fh.read()[-2000:]
                fails.append((pid, rc, tail))
        if fails:
            pid, rc, tail = fails[0]
            raise RuntimeError(
                f"multihost worker {pid} exited {rc} "
                f"({len(fails)}/{num_processes} failed):\n{tail}"
            )
        reports = []
        for out_path in outs:
            with open(out_path) as fh:
                reports.append(json.load(fh))
    checks = set()
    for r in reports:
        checks.update(k for k, v in r["checks"].items() if v.get("ok"))
    return {
        "ok": True,
        "num_processes": num_processes,
        "local_devices_per_process": local_devices,
        "global_devices": num_processes * local_devices,
        "mesh_axes": {"scenario": "spans processes (inter-host axis)",
                      "branch": "intra-process devices (intra-host axis)"},
        "transport": "jax.distributed + gloo TCP collectives (CPU stand-in "
                     "for the interconnect; the same program runs on GPUs)",
        "checks_passed": sorted(checks),
        "workers": reports,
    }


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description="multihost worker entry")
    ap.add_argument("--process-id", type=int, required=True)
    ap.add_argument("--num-processes", type=int, required=True)
    ap.add_argument("--local-devices", type=int, default=2)
    ap.add_argument("--port", type=int, default=DEFAULT_PORT)
    ap.add_argument("--out", required=True)
    ap.add_argument("--repo-root", required=True)
    ap.add_argument("--no-fleet", action="store_true")
    a = ap.parse_args(argv)
    worker(
        a.process_id, a.num_processes, a.local_devices, a.port, a.out,
        a.repo_root, fleet=not a.no_fleet,
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
