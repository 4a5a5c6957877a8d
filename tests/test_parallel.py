"""Distributed tests on the virtual 8-device CPU mesh: the racing-game
corridor branch sweep (the planner's REAL QP) sharded with shard_map,
collective best-branch selection, safe-set all-gather, and consistency
with the single-chip planner computation."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from car_racing_tpu.parallel import mesh as mesh_mod, scaling
from car_racing_tpu.planning import overtake as ov
from car_racing_tpu.utils.constants import X_DIM


@pytest.fixture(scope="module")
def mesh():
    assert len(jax.devices()) == 8, "conftest must force 8 virtual devices"
    return mesh_mod.make_mesh(8)


def _host_oracle(inputs, N):
    """Single-chip oracle: the planner's own batch solve + numpy fallback +
    numpy selection, exactly as OvertakeTrajPlanner.get_local_traj does."""
    (x0, A, B, width, veh_w, veh_l, bez, ley, lg, rey, rg, ls, rs, lv, rv,
     act, od) = inputs
    S, BR = bez.shape[:2]
    bests, X_bests, all_costs, all_conv = [], [], [], []
    for s in range(S):
        X, _, conv, _ = ov._solve_branch_batch(
            x0[s], A, B, width, veh_w, bez[s],
            ley[s, :, :N], lg[s, :, :N], rey[s, :, :N], rg[s, :, :N],
            num_horizon=N,
        )
        X = np.array(X)
        conv = np.asarray(conv)
        bezs = np.asarray(bez[s])
        for br in range(BR):
            if not conv[br]:
                X[br] = np.asarray(
                    ov.kinematic_fallback_traj(x0[s], bez[s, br], N)
                )
        costs = -10.0 * (X[:, -1, 4] - X[:, 0, 4])
        for br in range(BR):
            for side_s, side_ey, valid in (
                (ls[s, br], ley[s, br], lv[s, br]),
                (rs[s, br], rey[s, br], rv[s, br]),
            ):
                if not bool(valid):
                    continue
                diffs = X[br, :, 4] - np.asarray(side_s)
                diffey = X[br, :, 5] - np.asarray(side_ey)
                viol = diffs**2 + diffey**2 - float(veh_l) ** 2 - float(veh_w) ** 2 < 0
                costs[br] += 100.0 * viol.sum()
            if int(od[s]) >= 0 and int(od[s]) != br:
                costs[br] += 100.0
        costs = np.where(np.asarray(act[s]), costs, np.inf)
        best = int(np.argmin(costs))
        bests.append(best)
        X_bests.append(X[best])
        all_costs.append(costs)
        all_conv.append(conv)
    return (np.asarray(bests), np.stack(X_bests), np.stack(all_costs),
            np.stack(all_conv))


def test_mesh_shape(mesh):
    assert mesh.shape == {"scenario": 2, "branch": 4}


def test_corridor_sweep_matches_single_chip_planner(mesh):
    """The mesh sweep must solve the planner's EXACT corridor problem:
    identical inputs through mesh.corridor_sweep (sharded over 8 devices,
    collective selection) and through the single-chip _solve_branch_batch +
    host fallback + host selection must agree on every branch cost, the
    winning branch, and its trajectory."""
    S, N = 8, 10
    inputs = scaling.corridor_sweep_inputs(S, N, seed=7)
    best, X_best, costs, conv, X_all, iters = mesh_mod.corridor_sweep(
        mesh, *inputs, num_horizon=N
    )
    ref_best, ref_X, ref_costs, ref_conv = _host_oracle(inputs, N)

    # f32 problem data: batched reductions reorder between shard batch
    # sizes, so agreement is to f32 accumulation noise (corridor costs are
    # separated by O(0.1+), so the winner cannot flip)
    np.testing.assert_array_equal(np.asarray(conv), ref_conv)
    np.testing.assert_allclose(np.asarray(costs), ref_costs, rtol=1e-4)
    np.testing.assert_array_equal(np.asarray(best), ref_best)
    np.testing.assert_allclose(np.asarray(X_best), ref_X, atol=1e-4)


def test_corridor_sweep_padding_and_hysteresis(mesh):
    """Padding rows (active=False) must never win; the direction-switch
    hysteresis must bias selection toward old_dir."""
    S, N = 8, 10
    inputs = list(scaling.corridor_sweep_inputs(S, N, seed=11))
    active = np.asarray(inputs[15]).copy()
    active[:, -1] = False  # pad out the last corridor
    inputs[15] = jnp.asarray(active)
    best, _, costs, _, _, _ = mesh_mod.corridor_sweep(mesh, *inputs, num_horizon=N)
    assert (np.asarray(best) != active.shape[1] - 1).all()
    assert np.isinf(np.asarray(costs)[:, -1]).all()

    # hysteresis: pin old_dir to the previous winner -> winner is stable
    inputs[16] = jnp.asarray(np.asarray(best), jnp.int32)
    best2, _, costs2, _, _, _ = mesh_mod.corridor_sweep(mesh, *inputs, num_horizon=N)
    np.testing.assert_array_equal(np.asarray(best2), np.asarray(best))
    # non-winning branches pay the +100 switch penalty
    c1, c2 = np.asarray(costs), np.asarray(costs2)
    mask = np.isfinite(c1)
    not_best = mask & (np.arange(c1.shape[1])[None] != np.asarray(best)[:, None])
    np.testing.assert_allclose(c2[not_best], c1[not_best] + 100.0, rtol=1e-5)


def test_corridor_sweep_mesh_size_invariance(mesh):
    """Identical results at 1 device and 8 devices (the correctness half of
    the scaling story; timing runs on real hardware in bench)."""
    S, N = 8, 10
    inputs = scaling.corridor_sweep_inputs(S, N, seed=3)
    mesh1 = mesh_mod.make_mesh(1)
    b1, X1, c1, v1, _, i1 = mesh_mod.corridor_sweep(mesh1, *inputs, num_horizon=N)
    b8, X8, c8, v8, _, i8 = mesh_mod.corridor_sweep(mesh, *inputs, num_horizon=N)
    np.testing.assert_array_equal(np.asarray(b1), np.asarray(b8))
    np.testing.assert_allclose(np.asarray(X1), np.asarray(X8), atol=1e-4)
    np.testing.assert_allclose(np.asarray(c1), np.asarray(c8), rtol=1e-4)
    np.testing.assert_array_equal(np.asarray(v1), np.asarray(v8))


def test_fleet_rollout_shards_racing_game(mesh):
    """A fleet of fused racing-game laps sharded over all 8 devices —
    scenario DP on the flagship path.

    NOT asserted: lane-for-lane equality with the unsharded batch.  The
    racing-game loop takes discrete decisions (safe-set window argmin,
    corridor selection) whose inputs differ at float-rounding level between
    lowerings (per-device batch of 1 under shard_map vs a batch of 8), and
    the closed loop amplifies a flipped tie into macroscopically different
    — but equally valid — laps (measured: 4 of 8 perturbed lanes diverge).
    What IS asserted: the sharded program is deterministic (bitwise
    run-to-run), and every lane is a valid racing rollout (finite, on
    track, making forward progress)."""
    from car_racing_tpu.ops import dynamics, track as track_ops
    from car_racing_tpu.utils import params

    seed = np.load("data/bench/lmpc_seed_l_shape.npz")
    spec = np.genfromtxt("data/track_layout/l_shape.csv", delimiter=",")
    track = track_ops.build_track(spec, width=1.0)
    opti = jnp.asarray(
        np.genfromtxt("data/optimal_traj/xcurv_l_shape.csv", delimiter=",")
    )
    j = lambda k: jnp.asarray(seed[k])
    B, n_steps = 8, 30
    rng = np.random.default_rng(5)
    pert = np.zeros((B, X_DIM))
    pert[:, 5] = rng.normal(0, 0.02, B)
    xc0 = jnp.asarray(np.asarray(seed["xcurv0"]) + pert)
    xg0 = jnp.broadcast_to(j("xglob0"), (B, X_DIM))
    args = (
        track, dynamics.BicycleParams.default(), params.LMPCParam.default(),
        params.RacingGameParam.default(alpha=0.8), params.SystemParam.default(),
    )
    shared = (
        j("ss1"), j("q1"), j("ss2"), j("q2"), j("u1"), j("u2"),
        jnp.asarray(seed["valid1"]), jnp.asarray(seed["valid2"]),
        jnp.asarray(seed["counter"], jnp.int32),
        j("lin_points0"), j("lin_input0"),
        jnp.asarray([[0.72, 7.5], [0.7, 5.5]]),
        jnp.asarray([[0.0, -0.2], [0.0, -0.5]]),
        opti,
    )

    xc_f, us_f, ot_f, steps_f = mesh_mod.fleet_rollout(
        mesh, *args, xc0, xg0, *shared, n_steps=n_steps
    )
    assert xc_f.shape == (B, n_steps + 1, X_DIM)
    xc_f = np.asarray(xc_f)
    # deterministic: a second sharded run is bitwise identical
    xc_f2, _, ot_f2, _ = mesh_mod.fleet_rollout(
        mesh, *args, xc0, xg0, *shared, n_steps=n_steps
    )
    np.testing.assert_array_equal(xc_f, np.asarray(xc_f2))
    np.testing.assert_array_equal(np.asarray(ot_f), np.asarray(ot_f2))
    # every lane is a valid racing rollout
    assert np.isfinite(xc_f).all()
    assert np.abs(xc_f[:, :, 5]).max() < 1.0  # on track
    progress = xc_f[:, -1, 4] - xc_f[:, 0, 4]
    assert (progress > 0.5).all(), progress  # every lane moves forward


def test_learning_fleet_shards_protocol(mesh):
    """A fleet of multi-lap LMPC learning protocols sharded over all 8
    devices (mesh_mod.learning_fleet): every lane must complete its lap
    with in-scan add_trajectory promotion, deterministically, from shared
    seed columns."""
    from car_racing_tpu.ops import dynamics, track as track_ops
    from car_racing_tpu.utils import params

    seed = np.load("data/bench/lmpc_seed_l_shape.npz")
    spec = np.genfromtxt("data/track_layout/l_shape.csv", delimiter=",")
    track = track_ops.build_track(spec, width=1.0)
    j = lambda k: jnp.asarray(seed[k])
    B, n_steps = 8, 200
    rng = np.random.default_rng(7)
    pert = np.zeros((B, X_DIM))
    pert[:, 5] = rng.normal(0, 0.01, B)
    xc0 = jnp.asarray(np.asarray(seed["xcurv0"]) + pert)
    xg0 = jnp.broadcast_to(j("xglob0"), (B, X_DIM))
    args = (
        track, dynamics.BicycleParams.default(), params.LMPCParam.default(),
        params.SystemParam.default(),
    )
    shared = (
        j("ss1"), j("q1"), j("u1"), jnp.asarray(seed["counter"], jnp.int32),
        j("ss2"), j("q2"), j("u2"), jnp.asarray(seed["pid_lap_steps"], jnp.int32),
        j("lin_points0"), j("lin_input0"),
    )

    xc_f, us_f, lap_steps, laps_done = mesh_mod.learning_fleet(
        mesh, *args, xc0, xg0, *shared, n_laps=1, n_steps=n_steps
    )
    assert xc_f.shape == (B, n_steps + 1, X_DIM)
    assert lap_steps.shape == (B, 1)
    # every lane completes its learning lap, in the regime of the
    # host-seeded first LMPC lap (179 steps on the unperturbed seed)
    assert (np.asarray(laps_done) == 1).all()
    lap_steps = np.asarray(lap_steps)[:, 0]
    assert (lap_steps > 150).all() and (lap_steps < 200).all(), lap_steps
    xc_f = np.asarray(xc_f)
    assert np.isfinite(xc_f).all()
    assert np.abs(xc_f[:, :, 5]).max() < 1.0  # on track
    # deterministic: a second sharded run is bitwise identical
    xc_f2, _, ls2, _ = mesh_mod.learning_fleet(
        mesh, *args, xc0, xg0, *shared, n_laps=1, n_steps=n_steps
    )
    np.testing.assert_array_equal(xc_f, np.asarray(xc_f2))


def test_safe_set_exchange(mesh):
    lap = jnp.asarray(np.random.default_rng(0).normal(size=(2, 8, X_DIM)))
    full = mesh_mod.safe_set_exchange(mesh, lap)
    np.testing.assert_allclose(np.asarray(full), np.asarray(lap))
    # output is fully replicated
    assert full.sharding.is_fully_replicated


def test_scaling_artifact(mesh, tmp_path):
    """Run the corridor-sweep scaling measurement on the virtual 8-device
    CPU mesh and write its artifact (to a temporary path: the run must not
    rewrite tracked files).

    The virtual-mesh strong/weak-scaling numbers validate the sharded
    program end to end but mostly measure CPU-core oversubscription, so
    they are asserted for shape and finiteness only; the collective traffic
    comes from the compiled program's HLO and is asserted exactly."""
    import json

    report = scaling.scaling_efficiency(total_branches=256, horizon=10, reps=5)
    assert report["n_devices"] == 8
    assert report["single"]["total_branches"] == 256
    assert report["multi_strong_scaling"]["total_branches"] == 256  # constant work
    assert report["multi_weak_scaling"]["total_branches"] == 2048  # 8x, labeled
    assert np.isfinite(report["efficiency_strong"]) and report["efficiency_strong"] > 0
    assert np.isfinite(report["efficiency_weak"]) and report["efficiency_weak"] > 0

    # collective bytes come from the COMPILED program's HLO, not
    # hand-computed shapes
    traffic = report["collective_traffic"]
    assert traffic["n_collective_ops"] >= 2  # all_gather(costs) + psum(X_best)
    assert traffic["bytes_per_device"] > 0
    # every collective the HLO contains must be PARSED (both explicit-list
    # and iota replica_groups encodings, tuple-shaped outputs): a partial
    # miss would silently undercount the traffic
    assert traffic["unparsed_collectives"] == 0, traffic
    assert "all-gather" in traffic["per_op"] and "all-reduce" in traffic["per_op"]

    out = tmp_path / "scaling.json"
    out.write_text(json.dumps({"environment": "8 virtual CPU devices", **report}))
    assert json.loads(out.read_text())["n_devices"] == 8


def test_compiled_program_caches_are_bounded(mesh):
    """Both compiled-program caches (_SWEEP_CACHE and _FLEET_CACHE) pin a
    compiled sharded program AND its Mesh, so they must stay bounded LRUs:
    inserting past the cap evicts the oldest entry."""
    # sweep cache: prefill with dummies, then a real call must (a) still
    # hit/compile fine and (b) trigger eviction back under the cap
    saved = dict(mesh_mod._SWEEP_CACHE)
    try:
        mesh_mod._SWEEP_CACHE.clear()
        for i in range(mesh_mod._SWEEP_CACHE_MAX):
            mesh_mod._SWEEP_CACHE[("dummy", i)] = lambda *a: None
        S, N = 8, 10
        inputs = scaling.corridor_sweep_inputs(S, N, seed=3)
        mesh_mod.corridor_sweep(mesh, *inputs, num_horizon=N)
        assert len(mesh_mod._SWEEP_CACHE) == mesh_mod._SWEEP_CACHE_MAX
        assert ("dummy", 0) not in mesh_mod._SWEEP_CACHE  # oldest evicted
        real_key = [k for k in mesh_mod._SWEEP_CACHE if k[0] != "dummy"]
        assert len(real_key) == 1
        # LRU move-to-end on hit: touching dummy 1 then inserting keeps it
        mesh_mod._SWEEP_CACHE.move_to_end(("dummy", 1))
    finally:
        mesh_mod._SWEEP_CACHE.clear()
        mesh_mod._SWEEP_CACHE.update(saved)

    # fleet cache: exercise the put/get helpers directly
    saved_f = dict(mesh_mod._FLEET_CACHE)
    try:
        mesh_mod._FLEET_CACHE.clear()
        for i in range(mesh_mod._FLEET_CACHE_MAX + 3):
            mesh_mod._fleet_cache_put(("k", i), lambda *a: i)
        assert len(mesh_mod._FLEET_CACHE) == mesh_mod._FLEET_CACHE_MAX
        assert mesh_mod._fleet_cache_get(("k", 0)) is None  # evicted
        assert mesh_mod._fleet_cache_get(("k", mesh_mod._FLEET_CACHE_MAX + 2)) is not None
        # a hit refreshes recency: oldest survivor is evicted next, not it
        oldest_survivor = ("k", 3)
        mesh_mod._fleet_cache_get(oldest_survivor)  # touch
        mesh_mod._fleet_cache_put(("k", 99), lambda *a: None)
        assert oldest_survivor in mesh_mod._FLEET_CACHE
    finally:
        mesh_mod._FLEET_CACHE.clear()
        mesh_mod._FLEET_CACHE.update(saved_f)
