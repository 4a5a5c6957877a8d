"""Fused on-device rollout must reproduce the host-loop simulation."""

import numpy as np
import jax.numpy as jnp

from car_racing_tpu.ops import dynamics, track as track_ops
from car_racing_tpu.racing import fused, policies, simulator, vehicles
from car_racing_tpu.utils import params
from car_racing_tpu.utils.constants import X_DIM


def test_fused_rollout_matches_host_loop():
    spec = np.genfromtxt("data/track_layout/l_shape.csv", delimiter=",")
    track = track_ops.build_track(spec, width=0.8)
    mpc_param = params.MPCParam.default(vt=0.8)
    sysp = params.SystemParam.default()
    bike = dynamics.BicycleParams.default()
    xtarget = jnp.asarray(np.array([0.8, 0, 0, 0, 0, 0.0]))

    n_steps = 60
    xcurvs, us = fused.rollout_mpc_tracking(
        track, bike, mpc_param, sysp, xtarget,
        jnp.zeros(X_DIM), jnp.zeros(X_DIM), n_steps=n_steps,
    )
    xcurvs = np.asarray(xcurvs)

    # host loop (same zero-noise config)
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
    host_traj = np.asarray(ego.xcurv_log)

    # identical program on both paths (same solver, same warm-start shift,
    # same substepped dynamics): machine-precision agreement, like the
    # fused LMPC lap.  Measured drift over 60 steps is <1e-14 in every
    # state; 1e-9 leaves slack for BLAS variation while still catching any
    # real semantic divergence (round-3 weak #2: the old 2e-2 could hide
    # 10% of the track half-width)
    m = min(len(host_traj), n_steps)
    np.testing.assert_allclose(xcurvs[1 : m + 1], host_traj[:m], atol=1e-9)


def test_fused_mpccbf_rollout_avoids_obstacles():
    """Fused on-device MPC-CBF closed loop: prescribed traffic, warm-started
    CBF solves inside one lax.scan — no collision, stays on track, converges."""
    spec = np.genfromtxt("data/track_layout/l_shape.csv", delimiter=",")
    track = track_ops.build_track(spec, width=1.0)
    cbf_param = params.MPCCBFParam.default(vt=0.8)
    sysp = params.SystemParam.default()
    bike = dynamics.BicycleParams.default()
    n_obs = 4
    s_coef = np.zeros((n_obs, 2))
    ey_coef = np.zeros((n_obs, 2))
    act = np.zeros(n_obs, bool)
    s_coef[0], ey_coef[0], act[0] = [0.2, 4.0], [0.0, 0.1], True
    s_coef[1], ey_coef[1], act[1] = [0.2, 10.0], [0.0, -0.1], True
    halfs = np.ones((n_obs, 2))
    halfs[:2] = [0.2, 0.1]
    n_steps = 150
    xc, us, kkt, its = fused.rollout_mpccbf(
        track, bike, cbf_param, sysp, jnp.asarray([0.8, 0, 0, 0, 0, 0.0]),
        jnp.zeros(X_DIM), jnp.zeros(X_DIM),
        jnp.asarray(s_coef), jnp.asarray(ey_coef), jnp.asarray(act),
        jnp.asarray(halfs), jnp.asarray([0.2, 0.1]), n_steps=n_steps,
    )
    xc = np.asarray(xc)
    assert np.isfinite(xc).all()
    assert np.abs(xc[:, 5]).max() < 1.0  # on track
    L = float(track.lap_length)
    t = np.arange(len(xc)) * 0.1
    for cs, ce in ((s_coef[0], ey_coef[0]), (s_coef[1], ey_coef[1])):
        ds = np.abs(np.mod(xc[:, 4] - np.polyval(cs, t) + L / 2, L) - L / 2)
        dey = np.abs(xc[:, 5] - np.polyval(ce, t))
        assert not ((ds < 0.85 * 0.4) & (dey < 0.85 * 0.2)).any()
    # warm-started solves stay converged (same gate as tests/test_mpccbf.py)
    assert np.percentile(np.asarray(kkt), 50) < 1e-3
    # iteration counts are REAL per-solve first-pass-under-tol counts, not a
    # constant fill: warm-started solves must show spread and finish early
    its = np.asarray(its)
    assert its.min() >= 0 and its.max() <= 20
    assert len(np.unique(its)) > 1, "iteration counts look like a constant fill"
    # input bounds respected
    us = np.asarray(us)
    assert np.abs(us[:, 0]).max() <= 0.5 + 1e-6
    assert np.abs(us[:, 1]).max() <= 1.0 + 1e-6


def test_fused_ilqr_matches_host_loop():
    """Fused on-device iLQR loop vs the host iLQRRacing policy on the
    blocking-car scenario of tests/test_ilqr.py: same solver, same dynamics,
    same prescribed obstacle — trajectories must agree."""
    spec = np.genfromtxt("data/track_layout/ellipse.csv", delimiter=",")
    track = track_ops.build_track(spec, width=1.0)
    ilqr_param = params.ILQRParam.default(vt=0.8)
    sysp = params.SystemParam.default()
    bike = dynamics.BicycleParams.default()
    obs_s, obs_ey = [0.2, 5.0], [0.0, 0.1]
    n_steps = 100

    half = jnp.asarray([0.2, 0.1])
    xtarget = jnp.asarray([0.8, 0, 0, 0, 0, 0.0])
    xc, us, its = fused.rollout_ilqr(
        track, bike, ilqr_param, xtarget, jnp.zeros(X_DIM), jnp.zeros(X_DIM),
        jnp.asarray(obs_s), jnp.asarray(obs_ey), half, half, n_steps=n_steps,
        warm_start=False,  # this pair pins the COLD (reference-behavior) path
    )
    xc = np.asarray(xc)
    # REAL per-solve Levenberg counts: spread, early-exit, never max_iter
    its = np.asarray(its)
    assert len(np.unique(its)) > 1 and its.max() < int(ilqr_param.max_iter)

    # behavior: follows the leader without collision (tests/test_ilqr.py gates)
    tail = xc[n_steps // 2 :]
    assert 0.1 < tail[:, 0].mean() < 0.45
    t = np.arange(len(xc)) * 0.1
    s_obs = np.polyval(obs_s, t)
    assert (s_obs - xc[:, 4] > 0.3).all()

    # host loop on the same scenario
    ego = vehicles.DynamicBicycleModel(name="ego", system_param=sysp)
    ego.set_zero_noise()
    ego.set_state_curvilinear(np.zeros(X_DIM))
    ego.set_state_global(np.zeros(X_DIM))
    ego.start_logging()
    # cold host policy to match the cold fused rollout (warm starting is
    # the policy default since r5; this parity pair pins the cold path)
    policy = policies.iLQRRacing(ilqr_param, sysp, warm_start=False)
    policy.set_timestep(0.1)
    policy.set_track(track)
    ego.set_ctrl_policy(policy)
    ego.set_track(track)
    car1 = vehicles.NoDynamicsModel(name="car1")
    car1.set_track(track)
    car1.set_state_curvilinear_func(obs_s, obs_ey)
    car1.start_logging()
    sim = simulator.CarRacingSim()
    sim.set_timestep(0.1)
    sim.set_track(track)
    sim.add_vehicle(ego)
    policy.set_racing_sim(sim)
    sim.add_vehicle(car1)
    sim.sim(sim_time=n_steps * 0.1)
    host_traj = np.asarray(ego.xcurv_log)

    # identical program on both paths (the host policy drives the same
    # scan-fused Levenberg solver the rollout embeds): measured drift over
    # 100 steps is <5e-14 across every state; 1e-9 leaves slack for BLAS
    # variation while catching real semantic divergence (round-3 weak #2:
    # the old 2e-2 could hide 10% of the track half-width)
    m = min(len(host_traj), n_steps)
    np.testing.assert_allclose(xc[1 : m + 1], host_traj[:m], atol=1e-9)


def test_fused_ilqr_warm_start_passes_blocking_car():
    """Shift-warm-started iLQR (warm_start=True, the policy default since
    r5): the solver keeps
    momentum and lands in the PASSING local optimum instead of settling
    behind the blocking car — collision-free by the box metric, faster
    than the leader, and identical between the host policy and the fused
    rollout (both shift the same way)."""
    spec = np.genfromtxt("data/track_layout/ellipse.csv", delimiter=",")
    track = track_ops.build_track(spec, width=1.0)
    ilqr_param = params.ILQRParam.default(vt=0.8)
    sysp = params.SystemParam.default()
    bike = dynamics.BicycleParams.default()
    obs_s, obs_ey = [0.2, 5.0], [0.0, 0.1]
    n_steps = 100
    half = jnp.asarray([0.2, 0.1])
    xtarget = jnp.asarray([0.8, 0, 0, 0, 0, 0.0])
    xc, us, its_w = fused.rollout_ilqr(
        track, bike, ilqr_param, xtarget, jnp.zeros(X_DIM), jnp.zeros(X_DIM),
        jnp.asarray(obs_s), jnp.asarray(obs_ey), half, half, n_steps=n_steps,
        warm_start=True,
    )
    xc = np.asarray(xc)
    # warm solves exit in few iterations (the latency point of warm starts)
    assert float(np.asarray(its_w).mean()) < 12.0
    L = float(track.lap_length)
    t = np.arange(len(xc)) * 0.1
    s_obs = np.polyval(obs_s, t)
    ey_obs = np.polyval(obs_ey, t)
    rel = np.mod(xc[:, 4] - s_obs + L / 2, L) - L / 2
    assert rel[0] < -1.0 and rel[-1] > 0.5, "warm-started ego never passed"
    ds = np.abs(rel)
    dey = np.abs(xc[:, 5] - ey_obs)
    # collision gates: (a) the degree-6 superellipse the reference's CBF
    # actually enforces (control.py:544-558) must stay > 1 at every step —
    # the repelling-cost optimum passes OUTSIDE the barrier; (b) the
    # axis-aligned box with the same 0.9 leniency the racing-game tests use
    # (the exact box corner is conservative vs the superellipse and the
    # optimum grazes it by ~1 cm at one step)
    barrier = (ds / 0.4) ** 6 + (dey / 0.2) ** 6
    assert barrier.min() > 1.0, f"inside the CBF superellipse ({barrier.min():.2f})"
    assert not ((ds < 0.9 * 0.4) & (dey < 0.9 * 0.2)).any(), "collision while passing"
    # keeps near-target speed instead of crawling behind the 0.2 m/s leader
    assert xc[n_steps // 2 :, 0].mean() > 0.7

    # host policy with warm_start=True agrees with the fused rollout
    ego = vehicles.DynamicBicycleModel(name="ego", system_param=sysp)
    ego.set_zero_noise()
    ego.set_state_curvilinear(np.zeros(X_DIM))
    ego.set_state_global(np.zeros(X_DIM))
    ego.start_logging()
    policy = policies.iLQRRacing(ilqr_param, sysp, warm_start=True)
    policy.set_timestep(0.1)
    policy.set_track(track)
    ego.set_ctrl_policy(policy)
    ego.set_track(track)
    car1 = vehicles.NoDynamicsModel(name="car1")
    car1.set_track(track)
    car1.set_state_curvilinear_func(obs_s, obs_ey)
    car1.start_logging()
    sim = simulator.CarRacingSim()
    sim.set_timestep(0.1)
    sim.set_track(track)
    sim.add_vehicle(ego)
    policy.set_racing_sim(sim)
    sim.add_vehicle(car1)
    sim.sim(sim_time=n_steps * 0.1)
    host_traj = np.asarray(ego.xcurv_log)
    m = min(len(host_traj), n_steps)
    # same machine-precision regime as the cold-start iLQR parity test
    np.testing.assert_allclose(xc[1 : m + 1], host_traj[:m], atol=1e-9)


def test_fused_lmpc_lap_matches_host_loop():
    """Fused LMPC learning lap (fused.rollout_lmpc_lap) vs the host
    LMPCRacingGame loop on the SAME seed safe sets with NO traffic.

    With no other vehicles the host orchestrator never dispatches onto the
    overtake branch, so both paths solve the identical per-step problem:
    local regression -> safe-set selection -> convex-hull terminal QP ->
    dynamics substeps -> add_point.  Agreement must therefore be exact to
    solver tolerance for the WHOLE lap, and the lap lengths must match."""
    seed = np.load("data/bench/lmpc_seed_l_shape.npz")
    spec = np.genfromtxt("data/track_layout/l_shape.csv", delimiter=",")
    track = track_ops.build_track(spec, width=1.0)
    opti_xc = np.genfromtxt("data/optimal_traj/xcurv_l_shape.csv", delimiter=",")
    opti_xg = np.genfromtxt("data/optimal_traj/xglob_l_shape.csv", delimiter=",")
    L = float(track.lap_length)
    timestep = 0.1

    # ---- host loop, seeded with the SAME committed safe-set laps ----------
    lmpc = policies.LMPCRacingGame(
        params.LMPCParam.default(),
        racing_game_param=params.RacingGameParam.default(alpha=0.8),
        system_param=params.SystemParam.default(),
        timestep=timestep, lap_number=4, time_lmpc=1000.0,
    )
    lmpc.set_track(track)
    lmpc.set_timestep(timestep)
    lmpc.set_opti_traj(opti_xc, opti_xg)
    P = seed["ss1"].shape[0]
    lmpc.ss_xcurv[:P, :, 0] = seed["ss2"]
    lmpc.ss_xcurv[:P, :, 1] = seed["ss1"]
    lmpc.u_ss[:P, :, 0] = seed["u2"]
    lmpc.u_ss[:P, :, 1] = seed["u1"]
    lmpc.Qfun[:P, 0] = seed["q2"]
    lmpc.Qfun[:P, 1] = seed["q1"]
    lmpc.time_ss[0] = int(seed["pid_lap_steps"])
    lmpc.time_ss[1] = int(seed["counter"])
    lmpc.iter = 2
    lmpc.lin_points = np.asarray(seed["lin_points0"])
    lmpc.lin_input = np.asarray(seed["lin_input0"])

    ego = vehicles.DynamicBicycleModel(name="ego", system_param=params.SystemParam.default())
    ego.set_timestep(timestep)
    ego.set_zero_noise()
    ego.set_state_curvilinear(np.asarray(seed["xcurv0"]))
    ego.set_state_global(np.asarray(seed["xglob0"]))
    ego.start_logging()
    ego.set_ctrl_policy(lmpc)

    sim = simulator.CarRacingSim()
    sim.set_timestep(timestep)
    sim.set_track(track)
    sim.add_vehicle(ego)
    sim.set_opti_traj(opti_xg)
    lmpc.set_racing_sim(sim)
    lmpc.set_vehicles_track()
    sim.sim(sim_time=28.0, one_lap=True, one_lap_name="ego")
    host_traj = np.asarray(ego.xcurv_log)
    host_lap_steps = len(host_traj)
    assert host_lap_steps < 280, "host LMPC lap never completed"
    assert not any(x is not None for x in ego.local_trajs), (
        "host loop unexpectedly dispatched the overtake planner with no traffic"
    )

    # ---- fused rollout on the identical problem ---------------------------
    j = lambda k: jnp.asarray(seed[k])
    xc, us, done, lap_steps = fused.rollout_lmpc_lap(
        track, dynamics.BicycleParams.default(),
        params.LMPCParam.default(), params.SystemParam.default(),
        j("xcurv0"), j("xglob0"),
        j("ss1"), j("q1"), j("ss2"), j("q2"), j("u1"), j("u2"),
        jnp.asarray(seed["valid1"]), jnp.asarray(seed["valid2"]),
        jnp.asarray(seed["counter"], jnp.int32),
        j("lin_points0"), j("lin_input0"), n_steps=300,
    )
    lap_steps = int(lap_steps)
    xc = np.asarray(xc)
    assert 0 < lap_steps < 300

    # identical problems every step: lap lengths equal, trajectories exact
    # to solver tolerance (host xcurv_log[k] = state AFTER step k; fused
    # xc[k] = state BEFORE step k — one-step shift)
    assert abs(lap_steps - host_lap_steps) <= 1, (lap_steps, host_lap_steps)
    m = min(lap_steps, host_lap_steps)
    ds = np.abs(np.mod(xc[1 : m + 1, 4] - host_traj[:m, 4] + L / 2, L) - L / 2)
    dey = np.abs(xc[1 : m + 1, 5] - host_traj[:m, 5])
    dvx = np.abs(xc[1 : m + 1, 0] - host_traj[:m, 0])
    assert ds.max() < 1e-6, f"s diverged by {ds.max():.2e} m"
    assert dey.max() < 1e-6, f"ey diverged by {dey.max():.2e} m"
    assert dvx.max() < 1e-6, f"vx diverged by {dvx.max():.2e} m/s"


def test_fused_lmpc_learning_matches_host_protocol():
    """The fused MULTI-LAP learning rollout (fused.rollout_lmpc_learning)
    vs the host protocol: three consecutive LMPC laps with add_trajectory
    promotion at each boundary, from the same committed seed laps.

    The fused path performs the host's add_trajectory inside the scan
    (appendix recovery, Qfun = (T-1)-arange backfill, column demotion,
    s wrap), so lap step counts must match exactly and trajectories agree
    to solver tolerance across ALL laps.  Lap times must also improve
    monotonically from the MPC seed lap — the learning curve."""
    seed = np.load("data/bench/lmpc_seed_l_shape.npz")
    spec = np.genfromtxt("data/track_layout/l_shape.csv", delimiter=",")
    track = track_ops.build_track(spec, width=1.0)
    opti_xc = np.genfromtxt("data/optimal_traj/xcurv_l_shape.csv", delimiter=",")
    opti_xg = np.genfromtxt("data/optimal_traj/xglob_l_shape.csv", delimiter=",")
    L = float(track.lap_length)
    timestep = 0.1
    n_laps = 3

    # ---- host protocol: 3 LMPC laps + add_trajectory at each boundary -----
    lmpc = policies.LMPCRacingGame(
        params.LMPCParam.default(),
        racing_game_param=params.RacingGameParam.default(alpha=0.8),
        system_param=params.SystemParam.default(),
        timestep=timestep, lap_number=2 + n_laps, time_lmpc=1000.0,
    )
    lmpc.set_track(track)
    lmpc.set_timestep(timestep)
    lmpc.set_opti_traj(opti_xc, opti_xg)
    P = seed["ss1"].shape[0]
    lmpc.ss_xcurv[:P, :, 0] = seed["ss2"]
    lmpc.ss_xcurv[:P, :, 1] = seed["ss1"]
    lmpc.u_ss[:P, :, 0] = seed["u2"]
    lmpc.u_ss[:P, :, 1] = seed["u1"]
    lmpc.Qfun[:P, 0] = seed["q2"]
    lmpc.Qfun[:P, 1] = seed["q1"]
    lmpc.time_ss[0] = int(seed["pid_lap_steps"])
    lmpc.time_ss[1] = int(seed["counter"])
    lmpc.iter = 2
    lmpc.lin_points = np.asarray(seed["lin_points0"])
    lmpc.lin_input = np.asarray(seed["lin_input0"])

    ego = vehicles.DynamicBicycleModel(name="ego", system_param=params.SystemParam.default())
    ego.set_timestep(timestep)
    ego.set_zero_noise()
    ego.set_state_curvilinear(np.asarray(seed["xcurv0"]))
    ego.set_state_global(np.asarray(seed["xglob0"]))
    ego.start_logging()
    ego.set_ctrl_policy(lmpc)

    sim = simulator.CarRacingSim()
    sim.set_timestep(timestep)
    sim.set_track(track)
    sim.add_vehicle(ego)
    sim.set_opti_traj(opti_xg)
    lmpc.set_racing_sim(sim)
    lmpc.set_vehicles_track()
    for lap in range(n_laps):
        sim.sim(sim_time=40.0, one_lap=True, one_lap_name="ego")
        lmpc.add_trajectory(ego, lap)
    host_traj = np.asarray(ego.xcurv_log)
    host_lap_steps = [int(lmpc.time_ss[2 + j]) for j in range(n_laps)]
    assert lmpc.iter == 2 + n_laps

    # ---- fused multi-lap rollout on the identical seed --------------------
    j = lambda k: jnp.asarray(seed[k])
    xc, us, lap_steps, laps_done = fused.rollout_lmpc_learning(
        track, dynamics.BicycleParams.default(),
        params.LMPCParam.default(), params.SystemParam.default(),
        j("xcurv0"), j("xglob0"),
        j("ss1"), j("q1"), j("u1"), jnp.asarray(seed["counter"], jnp.int32),
        j("ss2"), j("q2"), j("u2"), jnp.asarray(seed["pid_lap_steps"], jnp.int32),
        j("lin_points0"), j("lin_input0"), n_laps=n_laps, n_steps=500,
    )
    assert int(laps_done) == n_laps
    lap_steps = [int(v) for v in np.asarray(lap_steps)]
    xc = np.asarray(xc)

    # exact lap-step agreement, every lap
    assert lap_steps == host_lap_steps, (lap_steps, host_lap_steps)
    # learning curve: monotone improvement from the MPC seed lap
    curve = [int(seed["counter"])] + lap_steps
    assert all(a > b for a, b in zip(curve, curve[1:])), curve
    # trajectory agreement to solver tolerance across all laps (host
    # xcurv_log[k] = state AFTER step k, s wrapped per lap; fused xc[k] =
    # state BEFORE step k, also wrapped — one-step shift)
    m = sum(lap_steps)
    ds = np.abs(np.mod(xc[1 : m + 1, 4] - host_traj[:m, 4] + L / 2, L) - L / 2)
    dey = np.abs(xc[1 : m + 1, 5] - host_traj[:m, 5])
    dvx = np.abs(xc[1 : m + 1, 0] - host_traj[:m, 0])
    assert ds.max() < 1e-6, f"s diverged by {ds.max():.2e} m"
    assert dey.max() < 1e-6, f"ey diverged by {dey.max():.2e} m"
    assert dvx.max() < 1e-6, f"vx diverged by {dvx.max():.2e} m/s"


def test_learning_protocol_from_scratch():
    """racing/protocol.run_learning_protocol: the reference's full
    lmpc_test protocol (PID seed lap -> MPC seed lap -> LMPC learning laps,
    lmpc_test.py:58-139) with every stage a fused on-device rollout and
    only numpy lap-cut/column glue between stages.  The learning curve
    must decrease monotonically from a standing start."""
    from car_racing_tpu.racing import protocol

    track = track_ops.load_track("l_shape", width=1.0)
    out = protocol.run_learning_protocol(track, n_laps=3)
    curve = out["lap_steps"]
    assert len(curve) == 5  # PID, MPC, 3 learned laps
    assert all(a > b for a, b in zip(curve, curve[1:])), curve
    # the learned laps land in the same regime as the host-seeded fused
    # learning test (179 -> 121 -> 87 on the committed seed)
    assert curve[-1] < 100, curve
    # column construction keeps host add_trajectory structure
    ss1, q1 = out["seed_columns"]["ss1"], out["seed_columns"]["q1"]
    T = curve[1]
    assert ss1[T, 4] >= float(track.lap_length)  # crossing row un-wrapped
    assert (ss1[T + 1 :] == 1e4).all()  # sentinel beyond the lap
    np.testing.assert_allclose(q1, (T - 1) - np.arange(len(q1)))
    # raceline export: fastest learned lap in the reference CSV format
    import tempfile

    from car_racing_tpu.racing import protocol as protocol_mod

    with tempfile.TemporaryDirectory() as d:
        it = protocol_mod.export_learned_raceline(out, track, "l_shape", data_dir=d)
        assert it == 2 + int(np.argmin(curve[2:]))
        lap = np.loadtxt(f"{d}/optimal_traj/xcurv_l_shape_learned.csv", delimiter=",")
        assert lap.shape == (min(curve[2:]) + 1, X_DIM)
        assert lap[0, 4] < 1.0 and lap[-1, 4] >= float(track.lap_length)
        assert (np.diff(lap[:, 4]) > 0).all()  # monotone raceline


def test_fused_racing_game_lap():
    """The FLAGSHIP path fully fused: one on-device racing-game lap (LMPC
    dispatch <-> corridor branch planner + warm-started multi-agent CBF
    tracker via lax.cond) against the CI traffic pattern.  Must complete
    the lap faster than the PID seed lap, trigger real overtake steps,
    avoid both cars, and stay on track."""
    import jax.numpy as jnp

    seed = np.load("data/bench/lmpc_seed_l_shape.npz")
    spec = np.genfromtxt("data/track_layout/l_shape.csv", delimiter=",")
    track = track_ops.build_track(spec, width=1.0)
    opti = np.genfromtxt("data/optimal_traj/xcurv_l_shape.csv", delimiter=",")
    j = lambda k: jnp.asarray(seed[k])
    # traffic of tests/test_racing_game.py, pre-sorted by ey descending
    s_coef = np.array([[0.72, 7.5], [0.7, 5.5]])
    ey_coef = np.array([[0.0, -0.2], [0.0, -0.5]])
    xc, us, ot, lap_steps = fused.rollout_racing_game(
        track, dynamics.BicycleParams.default(),
        params.LMPCParam.default(), params.RacingGameParam.default(alpha=0.8),
        params.SystemParam.default(), j("xcurv0"), j("xglob0"),
        j("ss1"), j("q1"), j("ss2"), j("q2"), j("u1"), j("u2"),
        jnp.asarray(seed["valid1"]), jnp.asarray(seed["valid2"]),
        jnp.asarray(seed["counter"], jnp.int32),
        j("lin_points0"), j("lin_input0"),
        jnp.asarray(s_coef), jnp.asarray(ey_coef), jnp.asarray(opti),
        n_steps=300,
    )
    lap_steps = int(lap_steps)
    xc = np.asarray(xc)
    assert 0 < lap_steps < 300, "fused racing-game lap never completed"
    assert lap_steps < int(seed["pid_lap_steps"])  # beats the seed PID lap
    assert int(np.asarray(ot).sum()) > 0, "no overtake step ever triggered"
    assert np.isfinite(xc[:lap_steps]).all()
    assert np.abs(xc[:lap_steps, 5]).max() < 1.0  # on track
    L = float(track.lap_length)
    t = np.arange(len(xc)) * 0.1
    for cs, ce in zip(s_coef, ey_coef):
        ds = np.abs(np.mod(xc[:, 4] - np.polyval(cs, t) + L / 2, L) - L / 2)
        dey = np.abs(xc[:, 5] - np.polyval(ce, t))
        assert not ((ds < 0.9 * 0.4) & (dey < 0.9 * 0.2))[:lap_steps].any()


def test_fused_racing_game_matches_host_loop():
    """Fused racing game vs the host LMPCRacingGame loop on the SAME seed
    safe sets and traffic.

    The fused path now solves the IDENTICAL per-step problems as the host
    loop on every branch: the corridor problem is masked down to the
    vehicles-of-interest subset (compacted, ey-descending), the tracker
    uses the host's MAX_OBSTACLES padded layout and cold/warm iteration
    protocol, and branch selection shares branch_selection_cost.  The
    only remaining difference is floating-point accumulation order, so
    the whole lap — overtake steps included — must agree to 1e-6."""
    _check_racing_game_fused_vs_host()


def test_fused_racing_game_restarts_cold_like_host_loop(monkeypatch):
    """With every tracker solve counted as failed
    (``controllers.WARM_RES_MAX = 0``), no solve seeds the next one: both
    the fused game and the host loop solve every overtake step cold, and
    they still agree step for step."""
    import jax

    from car_racing_tpu.models import controllers

    monkeypatch.setattr(controllers, "WARM_RES_MAX", 0.0)
    jax.clear_caches()  # the bound is read when the fused game is traced
    try:
        _check_racing_game_fused_vs_host()
    finally:
        monkeypatch.undo()
        jax.clear_caches()


def _check_racing_game_fused_vs_host():
    import jax.numpy as jnp

    seed = np.load("data/bench/lmpc_seed_l_shape.npz")
    spec = np.genfromtxt("data/track_layout/l_shape.csv", delimiter=",")
    track = track_ops.build_track(spec, width=1.0)
    opti_xc = np.genfromtxt("data/optimal_traj/xcurv_l_shape.csv", delimiter=",")
    opti_xg = np.genfromtxt("data/optimal_traj/xglob_l_shape.csv", delimiter=",")
    s_coef = np.array([[0.72, 7.5], [0.7, 5.5]])  # pre-sorted by ey desc
    ey_coef = np.array([[0.0, -0.2], [0.0, -0.5]])
    L = float(track.lap_length)
    timestep = 0.1

    # ---- host loop, seeded with the SAME committed safe-set laps ----------
    lmpc = policies.LMPCRacingGame(
        params.LMPCParam.default(),
        racing_game_param=params.RacingGameParam.default(alpha=0.8),
        system_param=params.SystemParam.default(),
        timestep=timestep, lap_number=4, time_lmpc=1000.0,
    )
    lmpc.set_track(track)
    lmpc.set_timestep(timestep)
    lmpc.set_opti_traj(opti_xc, opti_xg)
    P = seed["ss1"].shape[0]
    lmpc.ss_xcurv[:P, :, 0] = seed["ss2"]
    lmpc.ss_xcurv[:P, :, 1] = seed["ss1"]
    lmpc.u_ss[:P, :, 0] = seed["u2"]
    lmpc.u_ss[:P, :, 1] = seed["u1"]
    lmpc.Qfun[:P, 0] = seed["q2"]
    lmpc.Qfun[:P, 1] = seed["q1"]
    lmpc.time_ss[0] = int(seed["pid_lap_steps"])
    lmpc.time_ss[1] = int(seed["counter"])
    lmpc.iter = 2
    lmpc.lin_points = np.asarray(seed["lin_points0"])
    lmpc.lin_input = np.asarray(seed["lin_input0"])

    ego = vehicles.DynamicBicycleModel(name="ego", system_param=params.SystemParam.default())
    ego.set_timestep(timestep)
    ego.set_zero_noise()
    ego.set_state_curvilinear(np.asarray(seed["xcurv0"]))
    ego.set_state_global(np.asarray(seed["xglob0"]))
    ego.start_logging()
    ego.set_ctrl_policy(lmpc)

    sim = simulator.CarRacingSim()
    sim.set_timestep(timestep)
    sim.set_track(track)
    sim.add_vehicle(ego)
    sim.set_opti_traj(opti_xg)
    lmpc.set_racing_sim(sim)
    lmpc.set_vehicles_track()
    for i in range(2):
        car = vehicles.NoDynamicsModel(name=f"car{i+1}")
        car.set_track(track)
        car.set_state_curvilinear_func(list(s_coef[i]), list(ey_coef[i]))
        car.start_logging()
        sim.add_vehicle(car)
    sim.sim(sim_time=28.0, one_lap=True, one_lap_name="ego")
    host_traj = np.asarray(ego.xcurv_log)
    host_lap_steps = len(host_traj)
    assert host_lap_steps < 280, "host racing-game lap never completed"
    host_overtakes = np.asarray([x is not None for x in ego.local_trajs])
    assert host_overtakes.any(), "host loop never overtook"
    # the lap must exercise MULTIPLE interest-subset sizes, otherwise the
    # 1e-6 agreement below would not prove the fused path's
    # vehicles-of-interest masking (a lap where every overtake step saw
    # all cars would pass even with the pre-r5 all-traffic corridors)
    interest_sizes = {len(v) for v in ego.vehicles_interest if v is not None}
    assert len(interest_sizes) >= 2, (
        f"only interest sizes {interest_sizes} seen — scenario no longer "
        "stresses the subset masking; adjust the traffic pattern"
    )

    # ---- fused rollout on the identical problem ----------------------------
    j = lambda k: jnp.asarray(seed[k])
    xc, us, ot, lap_steps = fused.rollout_racing_game(
        track, dynamics.BicycleParams.default(),
        params.LMPCParam.default(), params.RacingGameParam.default(alpha=0.8),
        params.SystemParam.default(), j("xcurv0"), j("xglob0"),
        j("ss1"), j("q1"), j("ss2"), j("q2"), j("u1"), j("u2"),
        jnp.asarray(seed["valid1"]), jnp.asarray(seed["valid2"]),
        jnp.asarray(seed["counter"], jnp.int32),
        j("lin_points0"), j("lin_input0"),
        jnp.asarray(s_coef), jnp.asarray(ey_coef), jnp.asarray(opti_xc),
        n_steps=300,
    )
    lap_steps = int(lap_steps)
    xc = np.asarray(xc)
    ot = np.asarray(ot)
    assert 0 < lap_steps < 300
    assert ot.any(), "fused loop never overtook"

    # ---- exact agreement ---------------------------------------------------
    # identical lap time
    assert lap_steps == host_lap_steps, (lap_steps, host_lap_steps)
    # host xcurv_log[k] is the state AFTER step k; fused xc[k] the state
    # BEFORE step k — align with the one-step shift
    m = min(lap_steps, host_lap_steps)
    ds = np.abs(
        np.mod(xc[1 : m + 1, 4] - host_traj[:m, 4] + L / 2, L) - L / 2
    )
    dey = np.abs(xc[1 : m + 1, 5] - host_traj[:m, 5])
    dvx = np.abs(xc[1 : m + 1, 0] - host_traj[:m, 0])
    # both dispatch onto the overtake branch at the SAME steps — the
    # vehicles-of-interest trigger and masking agree step by step
    host_ot = host_overtakes[:m]
    fused_ot = ot[:m]
    np.testing.assert_array_equal(fused_ot, host_ot)
    # the whole closed lap — LMPC steps AND overtake steps — agrees to
    # 1e-6: both paths now solve bit-identical per-step problems; only
    # accumulation order differs
    assert ds.max() < 1e-6, f"s diverged by {ds.max():.2e} m"
    assert dey.max() < 1e-6, f"ey diverged by {dey.max():.2e} m"
    assert dvx.max() < 1e-6, f"vx diverged by {dvx.max():.2e} m/s"


def test_fused_batch_rollout():
    spec = np.genfromtxt("data/track_layout/l_shape.csv", delimiter=",")
    track = track_ops.build_track(spec, width=0.8)
    mpc_param = params.MPCParam.default(vt=0.8)
    sysp = params.SystemParam.default()
    bike = dynamics.BicycleParams.default()
    xtarget = jnp.asarray(np.array([0.8, 0, 0, 0, 0, 0.0]))
    B = 4
    xc0 = jnp.zeros((B, X_DIM)).at[:, 5].set(jnp.linspace(-0.2, 0.2, B))
    xg0 = jnp.zeros((B, X_DIM))
    xcurvs, us = fused.rollout_mpc_tracking_batch(
        track, bike, mpc_param, sysp, xtarget, xc0, xg0, n_steps=30
    )
    assert xcurvs.shape == (B, 31, X_DIM)
    # all lanes converge toward centerline and target speed
    final = np.asarray(xcurvs[:, -1])
    assert np.abs(final[:, 5]).max() < 0.1
    assert np.abs(final[:, 0] - 0.8).max() < 0.1


def test_corridor_hold_prevents_mid_corner_graze():
    """Safety regression pin for the once-characterized m_shape graze, plus
    feature retention for the opt-in ``corridor_hold`` margin.

    History (PARITY.md "Characterized behavioral limitations"): through
    round 4 this scenario grazed car1 mid-corner with default params —
    superellipse barrier dipped to ~0.04 — and the r4 diagnosis blamed
    the reference's discrete-CBF decay.  The round-5 exactness fix
    (corridor problem masked to the vehicles-of-interest subset, matching
    the host loop and the reference) removed the ACTUAL cause: with the
    far car no longer distorting the corridor mid-ey, the selected plan
    stays wide until clear and the default-params episode is
    collision-free by a wide margin (measured barrier ~108).  This test
    pins that improved default behavior and keeps the corridor_hold knob
    exercised (still useful defense-in-depth for other geometries)."""
    track = track_ops.load_track("m_shape", width=1.0)
    seed = np.load("data/bench/lmpc_seed_m_shape.npz")
    j = lambda k: jnp.asarray(seed[k])
    opti = jnp.asarray(
        np.genfromtxt("data/optimal_traj/xcurv_m_shape.csv", delimiter=",")
    )
    s_coef = np.array([[0.72, 7.5], [0.7, 5.5]])
    ey_coef = np.array([[0.0, -0.2], [0.0, -0.5]])
    L = float(track.lap_length)

    def run(rg_param):
        xc, us, ot, lap_steps = fused.rollout_racing_game(
            track, dynamics.BicycleParams.default(), params.LMPCParam.default(),
            rg_param, params.SystemParam.default(), j("xcurv0"), j("xglob0"),
            j("ss1"), j("q1"), j("ss2"), j("q2"), j("u1"), j("u2"),
            jnp.asarray(seed["valid1"]), jnp.asarray(seed["valid2"]),
            jnp.asarray(seed["counter"], jnp.int32),
            j("lin_points0"), j("lin_input0"),
            jnp.asarray(s_coef), jnp.asarray(ey_coef), opti, n_steps=700,
        )
        ls = int(lap_steps)
        assert 0 < ls < 700
        xc = np.asarray(xc)[: ls + 1]
        t = np.arange(len(xc)) * 0.1
        bars = []
        for sc, ec in zip(s_coef, ey_coef):
            ds = np.abs(np.mod(xc[:, 4] - np.polyval(sc, t) + L / 2, L) - L / 2)
            dey = np.abs(xc[:, 5] - np.polyval(ec, t))
            bars.append(((ds / 0.4) ** 6 + (dey / 0.2) ** 6).min())
        return min(bars), int(np.asarray(ot).sum()), ls

    bar_default, ot_default, _ = run(params.RacingGameParam.default(alpha=0.8))
    assert ot_default > 0
    assert bar_default > 1.0, (
        f"the m_shape mid-corner graze is BACK (barrier {bar_default:.3f}); "
        "the r5 vehicles-of-interest corridor masking eliminated it — a "
        "regression here means the corridor problem is seeing non-interest "
        "traffic again"
    )

    import dataclasses

    held = dataclasses.replace(
        params.RacingGameParam.default(alpha=0.8), corridor_hold=1.2
    )
    bar_held, ot_held, ls_held = run(held)
    assert ot_held > 0, "held corridor must still overtake"
    assert bar_held > 1.0, f"corridor_hold=1.2 grazes ({bar_held})"


def test_fused_racing_game_three_cars():
    """Corridor compaction beyond the CI pair: three prescribed cars on
    staggered lanes (ey +0.15 / -0.15 / -0.45, s offsets 1.6 m and 0.8 m
    apart) so the vehicles-of-interest subset sweeps sizes 1, 2 AND 3
    during the lap — branch counts 2..4 of the static n_veh+1=4, with the
    invalid tail masked.  The lap must complete faster than the PID seed,
    dispatch overtake steps, stay inside the corridor ey bound, and stay
    collision-free against every car."""
    seed = np.load("data/bench/lmpc_seed_l_shape.npz")
    spec = np.genfromtxt("data/track_layout/l_shape.csv", delimiter=",")
    track = track_ops.build_track(spec, width=1.0)
    opti = np.genfromtxt("data/optimal_traj/xcurv_l_shape.csv", delimiter=",")
    j = lambda k: jnp.asarray(seed[k])
    s_coef = np.array([[0.70, 7.0], [0.72, 6.2], [0.68, 5.4]])  # ey desc
    ey_coef = np.array([[0.0, 0.15], [0.0, -0.15], [0.0, -0.45]])
    L = float(track.lap_length)
    rgp = params.RacingGameParam.default(alpha=0.8)
    xc, us, ot, lap_steps = fused.rollout_racing_game(
        track, dynamics.BicycleParams.default(), params.LMPCParam.default(),
        rgp, params.SystemParam.default(), j("xcurv0"), j("xglob0"),
        j("ss1"), j("q1"), j("ss2"), j("q2"), j("u1"), j("u2"),
        jnp.asarray(seed["valid1"]), jnp.asarray(seed["valid2"]),
        jnp.asarray(seed["counter"], jnp.int32),
        j("lin_points0"), j("lin_input0"),
        jnp.asarray(s_coef), jnp.asarray(ey_coef), jnp.asarray(opti),
        n_steps=300,
    )
    ls = int(lap_steps)
    xc = np.asarray(xc)
    ot = np.asarray(ot)
    assert 0 < ls < 300, "3-car racing-game lap never completed"
    assert ls < int(seed["pid_lap_steps"])
    assert ot[:ls].any(), "no overtake step ever triggered"
    assert np.isfinite(xc[: ls + 1]).all()
    # corridor ey bound (track_width - veh_width/2 = 0.9)
    assert np.abs(xc[: ls + 1, 5]).max() < 0.9
    t_all = np.arange(len(xc)) * 0.1
    for cs, ce in zip(s_coef, ey_coef):
        ds = np.abs(np.mod(xc[:, 4] - np.polyval(cs, t_all) + L / 2, L) - L / 2)
        dey = np.abs(xc[:, 5] - np.polyval(ce, t_all))
        assert not ((ds < 0.9 * 0.4) & (dey < 0.9 * 0.2))[: ls + 1].any(), (
            f"collision with the ey={ce[1]} car"
        )
    # the scenario must exercise interest-subset sizes 1, 2 AND 3
    # (recomputed with the same trigger formula the scan uses)
    veh_len = 0.4
    sizes = set()
    for k in range(ls):
        if not ot[k]:
            continue
        t = k * 0.1
        s_e = xc[k, 4] % L
        m = 0
        for cs in s_coef:
            s_a = np.polyval(cs, t) % L
            dv = abs(xc[k, 0] - cs[0])
            front = rgp.safety_factor * veh_len + rgp.planning_prediction_factor * dv
            w = lambda d, lim: (d >= 0) and (d <= lim)
            if (
                w(s_a - s_e, front) or w(s_a + L - s_e, front)
                or w(s_e - s_a, veh_len) or w(s_e + L - s_a, veh_len)
            ):
                m += 1
        sizes.add(m)
    assert {1, 2, 3} <= sizes, (
        f"interest sizes seen {sizes} — retune the traffic so the masking "
        "is exercised at every subset size"
    )


def test_learning_protocol_other_layout():
    """The protocol's auto-sizing claim ('runs unmodified on all four
    layouts') exercised beyond l_shape: a zero-to-learned run on ellipse —
    the PID seed lap, the MPC seed lap, and one fused LMPC lap must each
    beat its predecessor with no layout-specific configuration."""
    from car_racing_tpu.racing import protocol

    track = track_ops.load_track("ellipse", width=1.0)
    out = protocol.run_learning_protocol(track, n_laps=1)
    curve = out["lap_steps"]
    assert len(curve) == 3  # PID, MPC, 1 learned lap
    assert all(a > b for a, b in zip(curve, curve[1:])), curve
    # regime check vs the committed ellipse seed fixture (PID 379/MPC 344)
    assert 250 < curve[0] < 500 and curve[-1] < curve[1]
