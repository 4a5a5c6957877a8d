"""Device-mesh parallelism: the racing game's corridor branch sweep over
device meshes.

The reference's flagship parallel component is the overtake trajectory
planner's per-corridor NLP fan-out — one OS process per corridor, results
gathered through Manager dicts (overtake_traj_planner.py:177-204), branch
selection on the host (:205-244).  The mesh design (SURVEY §2
parallelism inventory): the SAME corridor QP the planner solves
(planning/overtake.corridor_branch_qp — Bezier references, gated corridor
no-overlap rows, kinematic fallback, progress/collision/hysteresis
selection) is vmapped per chip and sharded across a mesh with
``shard_map``; best-branch selection rides XLA collectives
(all_gather + psum) between devices instead of Manager dicts.

Axes:
- ``scenario`` — data parallelism over independent racing games / vehicles
  (the DP analog for this workload).
- ``branch``   — the overtake-corridor sweep within each scenario
  (scenario/branch parallelism).
"""

from __future__ import annotations

from collections import OrderedDict
from functools import partial

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops import ipm, ocp
from ..planning import overtake as ov
from ..utils import numerics
from ..utils.constants import U_DIM, X_DIM


def make_mesh(n_devices: int | None = None):
    """Build a ('scenario', 'branch') mesh over the first n devices."""
    devs = jax.devices()[: (n_devices or len(jax.devices()))]
    n = len(devs)
    n_scen = 2 if n % 2 == 0 and n >= 4 else 1
    shape = (n_scen, n // n_scen)
    return Mesh(np.asarray(devs).reshape(shape), ("scenario", "branch"))


def make_branch_mesh(n_devices: int | None = None):
    """Mesh with every device on the 'branch' axis (scenario axis 1) — the
    shape a single racing game's planner dispatch wants: its one scenario's
    corridors fan out across all chips."""
    devs = jax.devices()[: (n_devices or len(jax.devices()))]
    return Mesh(np.asarray(devs).reshape(1, len(devs)), ("scenario", "branch"))


# Bounded LRU like _FLEET_CACHE below: each entry
# pins a compiled sharded program AND its Mesh, so an unbounded dict would
# grow without limit in a long-lived process sweeping horizons/meshes.
_SWEEP_CACHE: OrderedDict = OrderedDict()
_SWEEP_CACHE_MAX = 8


def corridor_sweep(
    mesh: Mesh,
    xcurv_ego: jax.Array,  # (S, X_DIM) per-scenario ego states
    A: jax.Array,
    B: jax.Array,
    track_width: jax.Array,
    veh_width: jax.Array,
    veh_length: jax.Array,
    bezier_samples: jax.Array,  # (S, BR, N+1, 2) sampled corridor curves
    left_ey: jax.Array,  # (S, BR, N+1) left-neighbor ey over the horizon
    left_gate: jax.Array,  # (S, BR, N+1) bool — QP corridor row active
    right_ey: jax.Array,  # (S, BR, N+1)
    right_gate: jax.Array,  # (S, BR, N+1)
    left_s: jax.Array,  # (S, BR, N+1) left neighbor wrapped s (selection)
    right_s: jax.Array,  # (S, BR, N+1)
    left_valid: jax.Array,  # (S, BR) bool — branch has a left neighbor
    right_valid: jax.Array,  # (S, BR)
    active: jax.Array,  # (S, BR) bool — False rows are padding (cost +inf)
    old_dir: jax.Array,  # (S,) int32 previous direction, -1 = none
    num_horizon: int = 10,
):
    """Sharded racing-game corridor branch sweep + collective selection.

    Solves, for every scenario, the planner's REAL per-corridor QPs
    (planning/overtake.corridor_branch_qp) with the kinematic fallback for
    unconverged branches and the reference's progress/collision/hysteresis
    selection cost (overtake_traj_planner.py:205-244) as the collective
    reduction: costs all_gather over the 'branch' axis, argmin, and a psum
    one-hot gather of the winning trajectory.  Scenarios shard over
    'scenario', corridors over 'branch'.

    Returns (best (S,) int32 global branch index, X_best (S, N+1, X_DIM),
    costs (S, BR), converged (S, BR), X_all (S, BR, N+1, X_DIM),
    iters (S, BR) int32 — REAL per-branch Newton counts from the sharded
    IPM, so mesh dispatch keeps the same per-branch effort observability
    as the single-chip path (round-3 weak #5)).

    The compiled sharded program is cached per (mesh, horizon, dtype) so
    repeated sweeps (every overtake control step) pay zero retrace.
    """
    args = (
        xcurv_ego, A, B, track_width, veh_width, veh_length,
        bezier_samples, left_ey, left_gate, right_ey, right_gate,
        left_s, right_s, left_valid, right_valid, active, old_dir,
    )
    return sweep_program(mesh, num_horizon, xcurv_ego.dtype)(*args)


def sweep_program(mesh: Mesh, num_horizon: int, dtype):
    """The cached jitted sweep program for (mesh, horizon, dtype) — exposed
    so the scaling harness can ``.lower(...).compile()`` it and read the
    ACTUAL collective ops/bytes out of the compiled HLO instead of
    hand-computing them."""
    N = num_horizon
    dtype = jnp.dtype(dtype)
    cache_key = (mesh, N, dtype.name)
    cached = _SWEEP_CACHE.get(cache_key)
    if cached is not None:
        _SWEEP_CACHE.move_to_end(cache_key)
        return cached

    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(
            P("scenario"),  # xcurv_ego
            P(), P(), P(), P(), P(),  # A, B, widths, length
            P("scenario", "branch"),  # bezier_samples
            P("scenario", "branch"), P("scenario", "branch"),  # left ey/gate
            P("scenario", "branch"), P("scenario", "branch"),  # right ey/gate
            P("scenario", "branch"), P("scenario", "branch"),  # left/right s
            P("scenario", "branch"), P("scenario", "branch"),  # valid masks
            P("scenario", "branch"),  # active
            P("scenario"),  # old_dir
        ),
        out_specs=(
            P("scenario"),  # best
            P("scenario"),  # X_best
            P("scenario", "branch"),  # costs
            P("scenario", "branch"),  # converged
            P("scenario", "branch"),  # X_all
            P("scenario", "branch"),  # iters
        ),
        check_vma=False,  # the QP solver's scan carry mixes varying/invariant
    )
    def sweep(x0_l, A, B, width, veh_w, veh_l, bez_l, ley_l, lg_l, rey_l,
              rg_l, ls_l, rs_l, lv_l, rv_l, act_l, od_l):
        S_l, BR_l = bez_l.shape[:2]
        n_u = N * U_DIM
        my_rank = jax.lax.axis_index("branch")
        br_idx = my_rank * BR_l + jnp.arange(BR_l)

        # per-scenario QP BUILD (branch-invariant condensed prediction built
        # once per scenario), then ONE flat (S_l*BR_l)-problem IPM solve, so
        # the batched factorization sees one large batch instead of S_l
        # batches of BR_l~4.
        def build_scenario(x0, bez_s, ley, lg, rey, rg):
            phi, G, s_pred = ov.corridor_context(x0, A, B, N)
            qp = jax.vmap(
                lambda bez, a, b, c, d: ov.corridor_branch_qp(
                    phi, G, s_pred, width, veh_w, bez, a, b, c, d, N
                )
            )(bez_s, ley[:, :N], lg[:, :N], rey[:, :N], rg[:, :N])
            return qp, phi, G

        qp_nested, phi_s, G_s = jax.vmap(build_scenario)(
            x0_l, bez_l, ley_l, lg_l, rey_l, rg_l
        )
        qp_flat = jax.tree.map(
            lambda a: a.reshape((S_l * BR_l,) + a.shape[2:]), qp_nested
        )
        sol = ipm.solve_qp_batch(
            qp_flat, jnp.zeros((S_l * BR_l, n_u), dtype), iters=30
        )
        z_s = sol.z.reshape(S_l, BR_l, n_u)
        conv_s = sol.converged.reshape(S_l, BR_l)
        iters_s = sol.iterations.reshape(S_l, BR_l)

        def per_scenario(x0, phi, G, z, conv, bez_s, ley, rey, ls, rs, lv,
                         rv, act, od):
            X = jax.vmap(lambda zz: ocp.unpack_states(phi, G, zz, x0))(z)
            # kinematic fallback for unconverged branches
            X_kin = jax.vmap(lambda bez: ov.kinematic_fallback_traj(x0, bez, N))(bez_s)
            X = jnp.where(conv[:, None, None], X, X_kin)

            # the reference's selection cost, padding rows forced to +inf
            costs = jax.vmap(
                lambda Xb, a, b, c, d, e, f, gidx: ov.branch_selection_cost(
                    Xb, a, b, c, d, e, f, veh_l, veh_w, od, gidx
                )
            )(X, ls, ley, rs, rey, lv, rv, br_idx)
            costs = jnp.where(act, costs, jnp.inf)

            # collective best across the branch axis
            all_costs = jax.lax.all_gather(costs, "branch", tiled=False).reshape(-1)
            best = jnp.argmin(all_costs).astype(jnp.int32)
            local_best = best - my_rank * BR_l
            has_best = (local_best >= 0) & (local_best < BR_l)
            X_best = jnp.where(
                has_best,
                X[jnp.clip(local_best, 0, BR_l - 1)],
                jnp.zeros_like(X[0]),
            )
            X_best = jax.lax.psum(X_best, "branch")
            return best, X_best, costs, conv, X

        best, X_best, costs, conv, X = jax.vmap(per_scenario)(
            x0_l, phi_s, G_s, z_s, conv_s, bez_l, ley_l, rey_l, ls_l, rs_l,
            lv_l, rv_l, act_l, od_l,
        )
        return best, X_best, costs, conv, X, iters_s

    compiled = numerics.jit(sweep)
    _SWEEP_CACHE[cache_key] = compiled
    while len(_SWEEP_CACHE) > _SWEEP_CACHE_MAX:
        _SWEEP_CACHE.popitem(last=False)
    return compiled


# compiled fleet programs, keyed on (kind, mesh, lane shape/dtype, statics):
# every array input is a real argument of the jitted function (nothing is
# closed over, so nothing is baked in as a constant), which makes the cache
# safe across changing safe sets / traffic and kills the per-call re-trace
# of the heaviest sharded programs in the repo.  Bounded LRU: each entry
# pins a compiled sharded program AND its Mesh, so an unbounded dict would
# grow without limit in a long-lived process sweeping shapes/meshes
_FLEET_CACHE: OrderedDict = OrderedDict()
_FLEET_CACHE_MAX = 8


def _fleet_cache_get(key):
    fn = _FLEET_CACHE.get(key)
    if fn is not None:
        _FLEET_CACHE.move_to_end(key)
    return fn


def _fleet_cache_put(key, fn):
    _FLEET_CACHE[key] = fn
    while len(_FLEET_CACHE) > _FLEET_CACHE_MAX:
        _FLEET_CACHE.popitem(last=False)


def fleet_rollout(
    mesh: Mesh,
    track, bike_params, lmpc_param, rg_param, sys_param,
    xcurv0_batch: jax.Array,  # (B, X_DIM), B divisible by the device count
    xglob0_batch: jax.Array,
    ss_prev, qfun_prev, ss_prev2, qfun_prev2,
    u_prev_lap, u_prev2_lap, valid_prev, valid_prev2, counter,
    lin_points0, lin_input0, obs_s_coef, obs_ey_coef, opti_traj_xcurv,
    n_steps: int = 300,
):
    """A fleet of fused racing-game laps sharded across EVERY device of the
    mesh (the scenario batch splits over the flattened ('scenario','branch')
    axes): full-scale production deployment of the flagship path — each
    device runs its shard of complete on-device laps (LMPC dispatch,
    corridor planner, CBF tracker) with zero cross-device traffic during
    the laps; lap-end safe-set exchange rides :func:`safe_set_exchange`.

    Returns the same tuple as racing/fused.rollout_racing_game_batch."""
    from ..racing import fused

    args = (
        track, bike_params, lmpc_param, rg_param, sys_param,
        xcurv0_batch, xglob0_batch,
        ss_prev, qfun_prev, ss_prev2, qfun_prev2,
        u_prev_lap, u_prev2_lap, valid_prev, valid_prev2, counter,
        lin_points0, lin_input0, obs_s_coef, obs_ey_coef, opti_traj_xcurv,
    )
    key = (
        "racing", mesh, n_steps,
        xcurv0_batch.shape, jnp.dtype(xcurv0_batch.dtype).name,
        ss_prev.shape,
    )
    cached = _fleet_cache_get(key)
    if cached is not None:
        return cached(*args)

    lane = P(("scenario", "branch"))
    # 5 param pytrees replicated, 2 lane-sharded starts, 14 replicated arrays
    in_specs = (P(),) * 5 + (lane, lane) + (P(),) * 14

    @partial(
        jax.shard_map, mesh=mesh,
        in_specs=in_specs, out_specs=(lane, lane, lane, lane),
        check_vma=False,
    )
    def run(tr, bp, lp, rp, sp, xc_l, xg_l, *sh):
        # throughput path: opt into the unrolled substep scan explicitly
        # (the batch entry point defaults to 1 for bitwise consistency);
        # only the scan reads it — on CUDA the integrator kernel runs
        return fused.rollout_racing_game_batch(
            tr, bp, lp, rp, sp, xc_l, xg_l, *sh, n_steps=n_steps,
            dynamics_unroll=10,
        )

    compiled = numerics.jit(run)
    _fleet_cache_put(key, compiled)
    return compiled(*args)


def learning_fleet(
    mesh: Mesh,
    track, bike_params, lmpc_param, sys_param,
    xcurv0_batch: jax.Array,  # (B, X_DIM), B divisible by the device count
    xglob0_batch: jax.Array,
    ss_prev, qfun_prev, u_prev_lap, t_prev,
    ss_prev2, qfun_prev2, u_prev2_lap, t_prev2,
    lin_points0, lin_input0,
    n_laps: int = 3,
    n_steps: int = 600,
):
    """A fleet of complete multi-lap LMPC learning protocols sharded
    across every device of the mesh: each device runs its shard of
    independent learning curves (racing/fused.rollout_lmpc_learning, the
    in-scan add_trajectory promotion included) from shared seed columns.
    Embarrassingly parallel during the curves; exchange learned racelines
    afterwards with :func:`safe_set_exchange`.

    Returns the same tuple as racing/fused.rollout_lmpc_learning_batch."""
    from ..racing import fused

    args = (
        track, bike_params, lmpc_param, sys_param,
        xcurv0_batch, xglob0_batch,
        ss_prev, qfun_prev, u_prev_lap, t_prev,
        ss_prev2, qfun_prev2, u_prev2_lap, t_prev2,
        lin_points0, lin_input0,
    )
    key = (
        "learning", mesh, n_laps, n_steps,
        xcurv0_batch.shape, jnp.dtype(xcurv0_batch.dtype).name,
        ss_prev.shape,
    )
    # capacity gate (racing/fused.rollout_lmpc_learning docstring): the
    # in-scan promotion clips row indices to P-1; an undersized column
    # would silently corrupt the learned safe set
    P_rows = int(ss_prev.shape[0])
    t1, t2 = int(t_prev), int(t_prev2)
    assert P_rows >= t1 + max(t1, t2) + 2, (
        f"safe-set columns have P={P_rows} rows; need >= t_prev + "
        f"lap_steps + 1 (seed laps {t1}/{t2} steps)"
    )

    cached = _fleet_cache_get(key)
    if cached is not None:
        return cached(*args)

    lane = P(("scenario", "branch"))
    in_specs = (P(),) * 4 + (lane, lane) + (P(),) * 10

    @partial(
        jax.shard_map, mesh=mesh,
        in_specs=in_specs, out_specs=(lane, lane, lane, lane),
        check_vma=False,
    )
    def run(tr, bp, lp, sp, xc_l, xg_l, *sh):
        return fused.rollout_lmpc_learning_batch(
            tr, bp, lp, sp, xc_l, xg_l, *sh, n_laps=n_laps, n_steps=n_steps,
            dynamics_unroll=10,
        )

    compiled = numerics.jit(run)
    _fleet_cache_put(key, compiled)
    return compiled(*args)


def safe_set_exchange(mesh: Mesh, lap_traj: jax.Array):
    """All-gather each scenario shard's newest lap trajectory so every
    device holds the full safe set (the LMPC safe-set exchange of SURVEY
    §5.8; replaces pickle/ROS transport).  Expressed as a resharding —
    XLA inserts the all-gather collective."""
    sharded = jax.device_put(lap_traj, NamedSharding(mesh, P("scenario")))
    return numerics.jit(lambda x: x, out_shardings=NamedSharding(mesh, P()))(sharded)


def dryrun(n_devices: int) -> None:
    """One full multi-chip step on tiny shapes: a 256-solve corridor branch
    sweep — the planner's REAL QP with corridor rows, Bezier references,
    fallback, and the collective selection reduction — sharded over
    ('scenario','branch'), plus the safe-set all-gather.  Used by the
    driver's multichip dry run."""
    from . import scaling

    mesh = make_mesh(n_devices)
    BR = 4  # 3 vehicles of interest per scenario -> 4 corridors
    S = 256 // BR
    N = 6  # small horizon for the dry run
    inputs = scaling.corridor_sweep_inputs(S, N, seed=0, dtype=jnp.float32)

    best, X_best, costs, conv, X_all, iters = corridor_sweep(
        mesh, *inputs, num_horizon=N
    )
    jax.block_until_ready((best, X_best))
    assert best.shape == (S,)
    assert X_best.shape == (S, N + 1, X_DIM)
    assert costs.shape == (S, BR) and X_all.shape == (S, BR, N + 1, X_DIM)
    assert iters.shape == (S, BR)
    assert bool(jnp.all((best >= 0) & (best < BR)))

    lap = jnp.asarray(
        np.random.default_rng(0).normal(size=(mesh.shape["scenario"], 8, X_DIM)),
        jnp.float32,
    )
    full = safe_set_exchange(mesh, lap)
    jax.block_until_ready(full)
    assert full.shape == lap.shape

    # scenario-DP on the flagship: a tiny fleet of fused racing-game steps
    # sharded over every device (LMPC dispatch <-> corridor planner + CBF
    # tracker inside lax.scan, one lane per device slot)
    import os

    from ..ops import dynamics, track as track_ops
    from ..utils import params as params_mod

    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    dtype = jnp.float32
    cast = lambda t: jax.tree.map(lambda a: jnp.asarray(a, dtype), t)
    spec = np.genfromtxt(f"{root}/data/track_layout/l_shape.csv", delimiter=",")
    track = cast(track_ops.build_track(spec, width=1.0))
    seed = np.load(f"{root}/data/bench/lmpc_seed_l_shape.npz")
    jf = lambda k: jnp.asarray(seed[k], dtype)
    B = n_devices
    rng = np.random.default_rng(1)
    pert = np.zeros((B, X_DIM))
    pert[:, 5] = rng.normal(0, 0.02, B)
    xc0 = jf("xcurv0") + jnp.asarray(pert, dtype)
    xg0 = jnp.broadcast_to(jf("xglob0"), (B, X_DIM))
    opti = jnp.asarray(
        np.genfromtxt(f"{root}/data/optimal_traj/xcurv_l_shape.csv", delimiter=","),
        dtype,
    )
    xc_f, _, _, _ = fleet_rollout(
        mesh, track, cast(dynamics.BicycleParams.default()),
        cast(params_mod.LMPCParam.default()),
        cast(params_mod.RacingGameParam.default(alpha=0.8, data_dir=f"{root}/data")),
        cast(params_mod.SystemParam.default()),
        xc0, xg0,
        jf("ss1"), jf("q1"), jf("ss2"), jf("q2"), jf("u1"), jf("u2"),
        jnp.asarray(seed["valid1"]), jnp.asarray(seed["valid2"]),
        jnp.asarray(seed["counter"], jnp.int32),
        jf("lin_points0"), jf("lin_input0"),
        jnp.asarray([[0.72, 7.5], [0.7, 5.5]], dtype),
        jnp.asarray([[0.0, -0.2], [0.0, -0.5]], dtype),
        opti, n_steps=3,
    )
    jax.block_until_ready(xc_f)
    assert xc_f.shape == (B, 4, X_DIM)
    assert bool(jnp.isfinite(xc_f).all())
    print(
        f"dryrun ok: mesh={dict(mesh.shape)} corridor_solves={S * BR} "
        f"best[:8]={np.asarray(best)[:8]} fleet_lanes={B}"
    )
