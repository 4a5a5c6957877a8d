"""Multi-HOST (multi-process) distributed tests: the inter-process half of
SURVEY §5.8, absent through round 3.

tests/test_parallel.py proves the sharded programs on a single-process
virtual mesh; here the SAME programs (mesh.corridor_sweep with its
collective selection, mesh.safe_set_exchange, mesh.fleet_rollout) run over
a mesh SPANNING OS PROCESSES: 2 worker processes x 2 virtual CPU devices,
joined by jax.distributed with a localhost coordinator and gloo TCP
collectives (the CPU stand-in for the interconnect).  Scenario axis spans
the processes (the inter-host axis — the safe-set all-gather crosses it),
branch axis stays within each process (the intra-host axis — the corridor
argmin's collectives never leave a process).

Reference analog: one OS process per overtake corridor joined via Manager
dicts (/root/reference/car_racing/planning/overtake_traj_planner.py:177-197)
and the ROS node graph
(/root/reference/car_racing/racing/realtime/simulator.py:54-83).
"""

import json

import pytest

from car_racing_tpu.parallel import multihost


@pytest.fixture(scope="module")
def mh_report(repo_root):
    """Launch the 2-process harness once for the module (compile-heavy)."""
    return multihost.launch(
        num_processes=2, local_devices=2, port=9961, fleet=True,
        repo_root=repo_root,
    )


@pytest.fixture(scope="module")
def mh_report_4x1(repo_root):
    """4 hosts x 1 device: the n_hosts=4 topology, corridor sweep +
    exchange only."""
    return multihost.launch(
        num_processes=4, local_devices=1, port=9963, fleet=False,
        repo_root=repo_root,
    )


def test_spanning_mesh_runs_real_programs(mh_report):
    """Every worker must pass every check: corridor-sweep parity vs its own
    process-local single-device run, bitwise safe-set replication across
    the process boundary, and a finite racing-game fleet spanning all four
    devices."""
    assert mh_report["ok"]
    assert mh_report["num_processes"] == 2
    assert mh_report["global_devices"] == 4
    assert mh_report["checks_passed"] == [
        "corridor_sweep_parity", "fleet_rollout", "safe_set_exchange"
    ]
    assert len(mh_report["workers"]) == 2
    for w in mh_report["workers"]:
        assert w["global_devices"] == 4
        assert w["local_devices_per_process"] == 2
        for name, chk in w["checks"].items():
            assert chk["ok"], (w["process_id"], name)


def test_workers_agree_on_selection(mh_report):
    """SPMD consistency: both processes must compute the identical winning
    branches for the identical sweep problem (each already asserted parity
    against its local single-device oracle; this pins cross-process
    agreement explicitly)."""
    w0, w1 = mh_report["workers"]
    assert (
        w0["checks"]["corridor_sweep_parity"]["winning_branches"]
        == w1["checks"]["corridor_sweep_parity"]["winning_branches"]
    )


def test_multihost_artifact(mh_report, mh_report_4x1, tmp_path):
    """Write the executable multi-process evidence of both topologies as
    one artifact (to a temporary path: the run must not rewrite tracked
    files)."""
    payload = {
        "what": "OS processes joined by jax.distributed (localhost "
                "coordinator, gloo TCP collectives); mesh "
                "('scenario','branch') spans processes; runs the REAL "
                "corridor sweep + safe-set exchange (+ racing-game fleet "
                "on the 2x2 topology) with parity asserts in every process",
        "topologies": {
            "2_processes_x_2_devices": mh_report,
            "4_processes_x_1_device": mh_report_4x1,
        },
    }
    out = tmp_path / "multihost.json"
    out.write_text(json.dumps(payload, indent=1))
    back = json.loads(out.read_text())["topologies"]
    assert back["2_processes_x_2_devices"]["ok"] and back["4_processes_x_1_device"]["ok"]


def test_four_process_topology(mh_report_4x1):
    """4 worker processes x 1 device each — scenario axis spans
    all four processes — running the corridor sweep and safe-set exchange
    with the same per-process parity asserts (fleet omitted: the heavy
    compile x4 on 2 cores buys no additional coverage here)."""
    rep = mh_report_4x1
    assert rep["ok"]
    assert rep["global_devices"] == 4
    assert rep["num_processes"] == 4
    assert "corridor_sweep_parity" in rep["checks_passed"]
    assert "safe_set_exchange" in rep["checks_passed"]
    # all four processes agree on the winners
    wins = [
        w["checks"]["corridor_sweep_parity"]["winning_branches"]
        for w in rep["workers"]
    ]
    assert all(w == wins[0] for w in wins)
