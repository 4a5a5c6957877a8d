"""Fused on-device closed-loop rollouts.

The reference's simulation loop crosses the Python/C++ boundary at every
control step (offboard.py:124-127 -> IPOPT).  On-device deployment fuses
the whole receding-horizon loop — MPC solve, 100 dynamics substeps, state
handoff, warm-start shift — into ONE jitted ``lax.scan``, so a full lap
executes on-device with zero host round-trips.  This is the latency story
for the BASELINE metrics: per-control-step time is total device time /
steps, with no dispatch overhead in the measurement or in production.

Also provides the batched variant (vmap over initial states / scenarios)
used for scaling sweeps.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..models import controllers
from ..ops import bezier as bezier_mod, dynamics, lmpc_learning, track as track_ops
from ..utils import numerics
from ..utils.constants import U_DIM, X_DIM
from ..utils.params import LMPCParam, MPCCBFParam, MPCParam, SystemParam


@partial(numerics.jit, static_argnames=("n_steps", "control_dt", "sub_dt"))
def rollout_mpc_tracking(
    track: track_ops.Track,
    bike_params: dynamics.BicycleParams,
    mpc_param: MPCParam,
    sys_param: SystemParam,
    xtarget: jax.Array,
    xcurv0: jax.Array,
    xglob0: jax.Array,
    n_steps: int = 100,
    control_dt: float = 0.1,
    sub_dt: float = 0.001,
):
    """Closed-loop MPC-LTI tracking entirely on-device.

    Each scan step: condensed-QP solve (warm-started by the shifted
    previous solution) -> one control period of Euler substeps.
    Returns (xcurv_traj (n_steps+1, X), u_traj (n_steps, U), kkt_res (n_steps,)).
    """
    N = mpc_param.num_horizon
    dtype = xcurv0.dtype

    def step(carry, _):
        xcurv, xglob, u_warm = carry
        u0, U, _ = controllers.mpc_lti(
            xcurv,
            xtarget,
            mpc_param,
            sys_param,
            track.width.astype(dtype),
            u_warm=u_warm,
            return_traj=True,
        )
        xglob_next, xcurv_next = dynamics.propagate(
            track, bike_params, xglob, xcurv, u0, control_dt=control_dt, sub_dt=sub_dt
        )
        flat = U.reshape(-1)
        u_warm_next = jnp.concatenate([flat[U_DIM:], flat[-U_DIM:]])
        return (xcurv_next, xglob_next, u_warm_next), (xcurv, u0)

    u_warm0 = jnp.zeros(N * U_DIM, dtype)
    (xcurv_T, _, _), (xcurvs, us) = jax.lax.scan(
        step, (xcurv0, xglob0, u_warm0), None, length=n_steps
    )
    xcurvs = jnp.concatenate([xcurvs, xcurv_T[None]], axis=0)
    return xcurvs, us


@partial(
    numerics.jit,
    static_argnames=("n_steps", "control_dt", "sub_dt", "cold_iters", "warm_iters"),
)
def rollout_mpccbf(
    track: track_ops.Track,
    bike_params: dynamics.BicycleParams,
    cbf_param: MPCCBFParam,
    sys_param: SystemParam,
    xtarget: jax.Array,
    xcurv0: jax.Array,
    xglob0: jax.Array,
    obs_s_coef: jax.Array,  # (n_obs, deg+1) polynomial s(t), polyval order
    obs_ey_coef: jax.Array,  # (n_obs, deg+1) polynomial ey(t)
    obs_active: jax.Array,  # (n_obs,) bool — static obstacle schedule
    obs_halfs: jax.Array,  # (n_obs, 2)
    agent_half: jax.Array,  # (2,)
    n_steps: int = 100,
    control_dt: float = 0.1,
    sub_dt: float = 0.001,
    cold_iters: int = 40,
    warm_iters: int = 20,
):
    """Closed-loop MPC-CBF racing entirely on-device.

    Obstacles follow a *static prescribed schedule* — polynomial
    (s(t), ey(t)) like the NoDynamics obstacles of the reference CI tests
    (auto_mpccbf_test.py:24-31) — so the whole loop (obstacle forecast,
    gating, warm-started CBF solve, 100 dynamics substeps) fuses into one
    ``lax.scan``.  Step 0 solves cold outside the scan; every scanned step
    reuses the previous primal-dual iterate at the shorter warm budget,
    exactly like the host-side MPCCBFRacing policy.

    Returns (xcurv_traj (n_steps+1, X), u_traj (n_steps, U), kkt (n_steps,),
    iters (n_steps,) int32 — real per-solve Newton-iteration counts).
    """
    N = cbf_param.num_horizon
    dtype = xcurv0.dtype
    n_obs = obs_s_coef.shape[0]
    L = track.lap_length.astype(dtype)
    obs_vs = jax.vmap(jnp.polyder)(obs_s_coef)
    obs_vey = jax.vmap(jnp.polyder)(obs_ey_coef)

    def obs_forecast(t):
        """(n_obs, N+1, X_DIM) prescribed-motion predictions at time t."""
        ts = t + control_dt * jnp.arange(N + 1, dtype=dtype)
        s = jax.vmap(lambda c: jnp.polyval(c, ts))(obs_s_coef)
        ey = jax.vmap(lambda c: jnp.polyval(c, ts))(obs_ey_coef)
        vs = jax.vmap(lambda c: jnp.polyval(c, ts))(obs_vs)
        vey = jax.vmap(lambda c: jnp.polyval(c, ts))(obs_vey)
        zeros = jnp.zeros_like(s)
        return jnp.stack([vs, vey, zeros, zeros, s, ey], axis=2)

    def solve(xcurv, t, warm, iters):
        obs_trajs = obs_forecast(t)
        gate = controllers.obstacle_gate_mask(xcurv, obs_trajs[:, 0, 4], L)
        return controllers.mpccbf(
            xcurv,
            xtarget,
            cbf_param,
            sys_param,
            track.width.astype(dtype),
            obs_trajs,
            obs_active & gate,
            agent_half,
            obs_halfs,
            L,
            warm=warm,
            return_traj=True,
            iters=iters,
        )

    def advance(xcurv, xglob, u):
        xglob, xcurv = dynamics.propagate(
            track, bike_params, xglob, xcurv, u, control_dt=control_dt, sub_dt=sub_dt
        )
        # lap bookkeeping: wrap s like ModelBase.update_memory
        wrap = xcurv[4] > L
        return xcurv.at[4].add(jnp.where(wrap, -L, 0.0)), xglob

    # step 0: cold solve
    u0, U, _, sol = solve(xcurv0, jnp.asarray(0.0, dtype), None, cold_iters)
    xcurv1, xglob1 = advance(xcurv0, xglob0, u0)
    warm0 = controllers.shift_cbf_warm(sol, N, n_obs)

    def step(carry, k):
        xcurv, xglob, warm = carry
        t = (k.astype(dtype) + 1.0) * control_dt
        u, U, _, sol = solve(xcurv, t, warm, warm_iters)
        xcurv_next, xglob_next = advance(xcurv, xglob, u)
        warm_next = controllers.shift_cbf_warm(sol, N, n_obs)
        return (xcurv_next, xglob_next, warm_next), (xcurv, u, sol.kkt_res, sol.iterations)

    (xcurv_T, _, _), (xcurvs, us, kkts, its) = jax.lax.scan(
        step, (xcurv1, xglob1, warm0), jnp.arange(n_steps - 1)
    )
    xcurvs = jnp.concatenate([xcurv0[None], xcurvs, xcurv_T[None]], axis=0)
    us = jnp.concatenate([u0[None], us], axis=0)
    return xcurvs, us, kkts, its


@partial(numerics.jit, static_argnames=("n_steps", "control_dt", "sub_dt", "warm_start"))
def rollout_ilqr(
    track: track_ops.Track,
    bike_params: dynamics.BicycleParams,
    ilqr_param,
    xtarget: jax.Array,
    xcurv0: jax.Array,
    xglob0: jax.Array,
    obs_s_coef: jax.Array,  # (deg+1,) polynomial s(t) of the ONE obstacle
    obs_ey_coef: jax.Array,  # (deg+1,) polynomial ey(t)
    agent_half: jax.Array,  # (2,) ego (length/2, width/2)
    obs_half: jax.Array,  # (2,)
    n_steps: int = 100,
    control_dt: float = 0.1,
    sub_dt: float = 0.001,
    warm_start: bool = True,
):
    """Closed-loop iLQR racing entirely on-device.

    The reference's heaviest per-step solve (max_iter=150, N=50 —
    control.py:64-195) fused like the other controllers: each scan step
    forecasts the prescribed obstacle (polynomial (s(t), ey(t)) like the
    reference's NoDynamics car), runs the full iLQR solve (backward Riccati
    + accept/reject Levenberg schedule under a while_loop that exits early
    on convergence), then one control period of Euler substeps.  A single
    obstacle, replicating the reference's keep-only-the-last-listed-vehicle
    behavior (control.py:100-110).

    ``warm_start=True`` (the default, matching the iLQRRacing policy's
    default) shift-warm-starts each solve from the previous step's
    sequence.  This is NOT behavior-neutral: the nonconvex solve lands in
    a different local optimum — ``warm_start=False`` reproduces the
    reference's cold zero-init, which settles behind a blocking car
    (pinned by the ilqr_ellipse golden and the cold parity test); warm
    solves keep momentum and take the collision-free passing line,
    converging in a few Levenberg iterations instead of ~10-20.

    Returns (xcurv_traj (n_steps+1, X), u_traj (n_steps, U),
    iters (n_steps,) int32 — REAL per-solve Levenberg iteration counts,
    the same honest effort signal the CBF/QP paths report).
    """
    N = ilqr_param.num_horizon
    dtype = xcurv0.dtype
    L = track.lap_length.astype(dtype)
    obs_vs = jnp.polyder(obs_s_coef)
    obs_vey = jnp.polyder(obs_ey_coef)

    def obs_forecast(t):
        ts = t + control_dt * jnp.arange(N + 1, dtype=dtype)
        s = jnp.polyval(obs_s_coef, ts)
        ey = jnp.polyval(obs_ey_coef, ts)
        vs = jnp.polyval(obs_vs, ts)
        vey = jnp.polyval(obs_vey, ts)
        zeros = jnp.zeros_like(s)
        return jnp.stack([vs, vey, zeros, zeros, s, ey], axis=1)  # (N+1, X)

    def step(carry, k):
        xcurv, xglob, u_warm = carry
        t = k.astype(dtype) * control_dt
        u, U, it = controllers.ilqr(
            xcurv, xtarget, ilqr_param, obs_forecast(t), agent_half, obs_half,
            u_init=u_warm if warm_start else None, return_seq=True,
        )
        xglob_next, xcurv_next = dynamics.propagate(
            track, bike_params, xglob, xcurv, u, control_dt=control_dt, sub_dt=sub_dt
        )
        # same shift-warm-start as the host iLQRRacing policy
        u_warm_next = jnp.concatenate([U[1:], U[-1:]], axis=0)
        return (xcurv_next, xglob_next, u_warm_next), (xcurv, u, it)

    u_warm0 = jnp.zeros((N, U_DIM), dtype)
    (xcurv_T, _, _), (xcurvs, us, its) = jax.lax.scan(
        step, (xcurv0, xglob0, u_warm0), jnp.arange(n_steps)
    )
    xcurvs = jnp.concatenate([xcurvs, xcurv_T[None]], axis=0)
    return xcurvs, us, its


def _lmpc_lap_step(
    track, bike_params, lmpc_param, sys_param, ss_prev2, qfun_prev, qfun_prev2,
    u_prev_lap, u_prev2_lap, valid_prev, valid_prev2, counter,
    control_dt, sub_dt, dynamics_backend,
):
    """The control step of :func:`rollout_lmpc_lap` as ``step(carry, k) ->
    (carry, (xcurv, u, done))``, with carry ``(xcurv, xglob, ss1,
    lin_points, lin_input, u_prev, z_warm, done)``."""
    N = lmpc_param.num_horizon
    K_per = lmpc_param.num_ss_points // lmpc_param.num_ss_iter
    dtype = ss_prev2.dtype
    L = track.lap_length.astype(dtype)
    W = track.width.astype(dtype)
    P = ss_prev2.shape[0]
    n_u = N * U_DIM

    ss_data_2 = ss_prev2
    u_data = jnp.stack([u_prev2_lap, u_prev_lap])
    valid = jnp.stack([valid_prev2, valid_prev])

    def step(carry, k):
        xcurv, xglob, ss1, lin_points, lin_input, u_prev, z_warm, done = carry
        x = xcurv.at[4].set(jnp.mod(xcurv[4], L))

        curvs = track_ops.curvature_batch(track, jnp.mod(lin_points[:N, 4], L))
        A_tv, B_tv, C_tv = lmpc_learning.estimate_abc_horizon(
            lin_points[:N],
            lin_input[:N],
            jnp.stack([ss_data_2, ss1]),
            u_data,
            valid,
            curvs,
            jnp.asarray(control_dt, dtype),
        )
        pts1, q1 = lmpc_learning.select_points(
            ss1, qfun_prev, x, K_per, lmpc_param.shift
        )
        pts2, q2 = lmpc_learning.select_points(
            ss_prev2, qfun_prev2, x, K_per, lmpc_param.shift
        )
        ss_points = jnp.concatenate([pts1, pts2], axis=1)
        qfun_sel = jnp.concatenate([q1, q2])

        U, X, sol = controllers.lmpc(
            x,
            lmpc_param,
            A_tv,
            B_tv,
            C_tv,
            ss_points,
            qfun_sel,
            u_prev,
            sys_param,
            L,
            W,
            z_warm=z_warm,
            num_horizon=N,
        )
        u = U[0]

        xglob_next, xcurv_next = dynamics.propagate(
            track, bike_params, xglob, xcurv, u, control_dt=control_dt,
            sub_dt=sub_dt, backend=dynamics_backend,
        )
        done_next = done | (xcurv_next[4] >= L)

        # add_point (base.py:624-629): append this step onto lap iter-1
        idx = jnp.clip(counter + k + 1, 0, P - 1)
        appended = x + jnp.zeros(X_DIM, dtype).at[4].set(L)
        ss1_next = jnp.where(done, ss1, ss1.at[idx].set(appended))

        lin_points_next = jnp.concatenate([X[1:], X[-1:]], axis=0)
        lin_input_next = jnp.concatenate([U[1:], U[-1:]], axis=0)
        z_warm_next = jnp.concatenate([U[1:].reshape(-1), U[-1], sol.z[n_u:]])

        frozen = lambda new, old: jnp.where(done, old, new)
        carry_next = (
            frozen(xcurv_next, xcurv),
            frozen(xglob_next, xglob),
            ss1_next,
            frozen(lin_points_next, lin_points),
            frozen(lin_input_next, lin_input),
            frozen(u, u_prev),
            frozen(z_warm_next, z_warm),
            done_next,
        )
        return carry_next, (xcurv, u, done)

    return step


@partial(
    numerics.jit,
    static_argnames=("n_steps", "control_dt", "sub_dt", "dynamics_backend", "return_carries"),
)
def rollout_lmpc_lap(
    track: track_ops.Track,
    bike_params: dynamics.BicycleParams,
    lmpc_param: LMPCParam,
    sys_param: SystemParam,
    xcurv0: jax.Array,
    xglob0: jax.Array,
    ss_prev: jax.Array,  # (P, X_DIM) safe set of lap iter-1 (sentinel-padded)
    qfun_prev: jax.Array,  # (P,) its cost-to-go (fully backfilled)
    ss_prev2: jax.Array,  # (P, X_DIM) lap iter-2
    qfun_prev2: jax.Array,  # (P,)
    u_prev_lap: jax.Array,  # (P, U_DIM) inputs of lap iter-1 (regression data)
    u_prev2_lap: jax.Array,  # (P, U_DIM) lap iter-2
    valid_prev: jax.Array,  # (P,) bool regression-row mask of lap iter-1
    valid_prev2: jax.Array,  # (P,)
    counter: jax.Array,  # () int32: time_ss[iter-1] (append offset)
    lin_points0: jax.Array,  # (N+1, X_DIM) initial linearization states
    lin_input0: jax.Array,  # (N, U_DIM)
    n_steps: int = 400,
    control_dt: float = 0.1,
    sub_dt: float = 0.001,
    dynamics_backend: str = "auto",
    return_carries: bool = False,
):
    """One full LMPC learning lap entirely on-device.

    ``dynamics_backend`` is forwarded to dynamics.propagate — the GPU tier
    (tests/test_gpu.py) uses it to run the SAME closed lap with the scan
    integrator vs the fused integrator kernel on the card.

    The safe-set arrays live in the scan carry: every step runs the local
    regression (kernel-weighted batched linear solves), safe-set point
    selection, the convex-hull terminal QP, the dynamics substeps, AND the
    reference's ``add_point`` append (base.py:624-629) — the current lap's
    states are written into lap iter-1's array at ``counter + k + 1`` with
    s shifted by one lap length, which is what lets the selection window
    run past the lap boundary.  This kills the per-step Python->IPOPT
    boundary of the reference's LMPC loop (base.py:456-501) the same way
    rollout_mpc_tracking does for MPC-LTI.

    The appended inputs are NOT written back (host add_point stores them,
    but nothing reads them: the regression's validity mask is fixed at lap
    start, base.py:592-599).

    Stops learning updates once s crosses the lap length (``done``); the
    scan runs the fixed n_steps regardless.  Returns (xcurv_traj
    (n_steps+1, X), u_traj (n_steps, U), done (n_steps,) bool, lap_steps),
    and with ``return_carries`` also the carry entering every step (stacked
    along a leading n_steps axis), which :func:`lmpc_lap_replay` takes.
    """
    N = lmpc_param.num_horizon
    dtype = xcurv0.dtype
    n_u = N * U_DIM
    K = lmpc_param.num_ss_points
    step = _lmpc_lap_step(
        track, bike_params, lmpc_param, sys_param, ss_prev2, qfun_prev, qfun_prev2,
        u_prev_lap, u_prev2_lap, valid_prev, valid_prev2, counter,
        control_dt, sub_dt, dynamics_backend,
    )
    if return_carries:
        step_fn = lambda c, k: (lambda nc, y: (nc, (y, c)))(*step(c, k))
    else:
        step_fn = step

    init = (
        xcurv0,
        xglob0,
        ss_prev,
        lin_points0,
        lin_input0,
        jnp.zeros(U_DIM, dtype),
        jnp.zeros(n_u + K, dtype).at[n_u:].set(1.0 / K),
        jnp.asarray(False),
    )
    final, ys = jax.lax.scan(step_fn, init, jnp.arange(n_steps))
    (xcurvs, us, dones), carries = ys if return_carries else (ys, None)
    xcurvs = jnp.concatenate([xcurvs, final[0][None]], axis=0)
    lap_steps = jnp.sum(~dones)
    if return_carries:
        return xcurvs, us, dones, lap_steps, carries
    return xcurvs, us, dones, lap_steps


@partial(numerics.jit, static_argnames=("control_dt", "sub_dt", "dynamics_backend"))
def lmpc_lap_replay(
    track, bike_params, lmpc_param, sys_param, ss_prev2, qfun_prev, qfun_prev2,
    u_prev_lap, u_prev2_lap, valid_prev, valid_prev2, counter,
    carries, ks,
    control_dt: float = 0.1,
    sub_dt: float = 0.001,
    dynamics_backend: str = "auto",
):
    """One control step of :func:`rollout_lmpc_lap` from each of a batch
    of recorded carries (``return_carries=True``) at step indices ``ks``:
    the same step, fed the same inputs, on whatever device the arguments
    live on.  Returns the batch of next carries."""
    step = _lmpc_lap_step(
        track, bike_params, lmpc_param, sys_param, ss_prev2, qfun_prev, qfun_prev2,
        u_prev_lap, u_prev2_lap, valid_prev, valid_prev2, counter,
        control_dt, sub_dt, dynamics_backend,
    )
    return jax.vmap(lambda c, k: step(c, k)[0])(carries, ks)


@partial(
    numerics.jit,
    static_argnames=("n_laps", "n_steps", "control_dt", "sub_dt", "dynamics_unroll"),
)
def rollout_lmpc_learning(
    track: track_ops.Track,
    bike_params: dynamics.BicycleParams,
    lmpc_param: LMPCParam,
    sys_param: SystemParam,
    xcurv0: jax.Array,
    xglob0: jax.Array,
    ss_prev: jax.Array,  # (P, X_DIM) lap iter-1 column (sentinel-padded)
    qfun_prev: jax.Array,  # (P,) its fully-backfilled Qfun
    u_prev_lap: jax.Array,  # (P, U_DIM)
    t_prev: jax.Array,  # () int32: time_ss[iter-1] (lap step count)
    ss_prev2: jax.Array,  # (P, X_DIM) lap iter-2 column
    qfun_prev2: jax.Array,  # (P,)
    u_prev2_lap: jax.Array,  # (P, U_DIM)
    t_prev2: jax.Array,  # () int32: time_ss[iter-2]
    lin_points0: jax.Array,  # (N+1, X_DIM)
    lin_input0: jax.Array,  # (N, U_DIM)
    n_laps: int = 3,
    n_steps: int = 600,
    control_dt: float = 0.1,
    sub_dt: float = 0.001,
    dynamics_unroll: int = 1,
):
    """The ENTIRE multi-lap LMPC learning protocol in one on-device scan.

    Where :func:`rollout_lmpc_lap` fuses one learning lap,
    this fuses the whole learning curve: a continuous scan in which every
    lap crossing performs the host's ``add_trajectory`` promotion
    (policies.py:407-433, reference base.py:631-655) *inside* the scan via
    masked array ops — no host round-trip between laps:

    - the just-driven lap's trajectory is recovered from the ``add_point``
      appendix it wrote into lap iter-1's column (rows ``t_prev+1 ..
      t_prev+T`` hold steps 0..T-1 with s+L; the crossing state, s >= L
      un-wrapped, becomes row T of the new column — matching the host lap
      memory, vehicles.py:110-136);
    - its Qfun column is ``(T-1) - arange(P)`` — exactly the host's
      ``compute_cost_host`` + backfill loop (policies.py:421-427) for a
      monotone lap, including the quirk that the crossing row backfills to
      -1 because its 0 cost collides with the "unwritten" sentinel;
    - lap iter-1 (WITH its appendix — the host mutates the stored column
      in place, so appended rows persist when it becomes iter-2) is demoted
      to iter-2, regression validity masks become ``arange < time_ss - 1``
      of the new columns, and s wraps by one lap length exactly like
      ``update_memory``.

    Both safe-set columns, their input logs, Qfun columns and lap lengths
    live in the scan carry; the linearization trajectory, input-rate anchor
    and QP warm start roll across lap boundaries untouched (the host
    policy's persist the same way).  Freezes after ``n_laps`` crossings.

    **Capacity requirement**: the add_point appendix and the promotion's
    crossing row index clip to ``P - 1``, so a column must satisfy
    ``P >= t_prev + lap_steps + 1`` for every lap it absorbs; an
    undersized ``P`` silently overwrites the last row and corrupts the
    learned safe set.  ``run_learning_protocol`` auto-sizes and asserts
    this (racing/protocol.py); callers supplying their own seed columns
    (rollout_lmpc_learning_batch, parallel/mesh.learning_fleet) must size
    ``P`` accordingly — learning_fleet asserts it host-side.

    Returns (xcurv_traj (n_steps+1, X) with s wrapped per lap, u_traj
    (n_steps, U), lap_steps (n_laps,) int32 per-lap step counts — the
    learning curve, lap_steps*control_dt = the reference's lap-time report
    (lmpc_test.py:148-155) — and laps_done ()).
    """
    N = lmpc_param.num_horizon
    K_per = lmpc_param.num_ss_points // lmpc_param.num_ss_iter
    dtype = xcurv0.dtype
    L = track.lap_length.astype(dtype)
    W = track.width.astype(dtype)
    P = ss_prev.shape[0]
    n_u = N * U_DIM
    K = lmpc_param.num_ss_points
    SENTINEL = jnp.asarray(1e4, dtype)
    rows = jnp.arange(P)
    lapshift = jnp.zeros(X_DIM, dtype).at[4].set(L)

    z_warm0 = jnp.zeros(n_u + K, dtype).at[n_u:].set(1.0 / K)

    def promote(lap_ss, lap_u, T, xcurv_cross):
        """Build the new iter-1 column from the lap just driven, host
        add_trajectory semantics.  Sourced from the CLEAN per-lap buffer,
        not the add_point appendix: the appendix stores ``x + L`` and
        un-shifting it re-rounds s by ~1 ulp, which measurably drifts the
        closed loop off the host protocol (1e-5 m over three laps)."""
        in_lap = rows < T
        ss_new = jnp.where(in_lap[:, None], lap_ss, SENTINEL)
        ss_new = ss_new.at[jnp.clip(T, 0, P - 1)].set(xcurv_cross)
        u_new = jnp.where(in_lap[:, None], lap_u, SENTINEL)
        q_new = (T - 1 - rows).astype(dtype)
        return ss_new, u_new, q_new

    def step(carry, k):
        (xcurv, xglob, ssA, uA, qA, tA, ssB, uB, qB, tB, lap_ss, lap_u,
         lin_points, lin_input, u_prev, z_warm, k_in_lap, lap_idx) = carry
        done = lap_idx >= n_laps
        x = xcurv.at[4].set(jnp.mod(xcurv[4], L))

        curvs = track_ops.curvature_batch(track, jnp.mod(lin_points[:N, 4], L))
        A_tv, B_tv, C_tv = lmpc_learning.estimate_abc_horizon(
            lin_points[:N],
            lin_input[:N],
            jnp.stack([ssB, ssA]),
            jnp.stack([uB, uA]),
            jnp.stack([rows < tB - 1, rows < tA - 1]),
            curvs,
            jnp.asarray(control_dt, dtype),
        )
        pts1, q1 = lmpc_learning.select_points(ssA, qA, x, K_per, lmpc_param.shift)
        pts2, q2 = lmpc_learning.select_points(ssB, qB, x, K_per, lmpc_param.shift)
        ss_points = jnp.concatenate([pts1, pts2], axis=1)
        qfun_sel = jnp.concatenate([q1, q2])

        U, X, sol = controllers.lmpc(
            x, lmpc_param, A_tv, B_tv, C_tv, ss_points, qfun_sel, u_prev,
            sys_param, L, W, z_warm=z_warm, num_horizon=N,
        )
        u = U[0]

        xglob_next, xcurv_next = dynamics.propagate(
            track, bike_params, xglob, xcurv, u,
            control_dt=control_dt, sub_dt=sub_dt, unroll=dynamics_unroll,
        )

        # add_point into lap iter-1's column (policies.py:400-405), plus the
        # clean per-lap record promotion sources from
        idx = jnp.clip(tA + k_in_lap + 1, 0, P - 1)
        ssA = ssA.at[idx].set(x + lapshift)
        uA = uA.at[idx].set(u)
        kidx = jnp.clip(k_in_lap, 0, P - 1)
        lap_ss = lap_ss.at[kidx].set(x)
        lap_u = lap_u.at[kidx].set(u)

        crossing = (xcurv_next[4] >= L) & ~done
        T = (k_in_lap + 1).astype(tA.dtype)
        ss_new, u_new, q_new = promote(lap_ss, lap_u, T, xcurv_next)

        sel = lambda new, old: jnp.where(crossing, new, old)
        ssB2, uB2, qB2, tB2 = sel(ssA, ssB), sel(uA, uB), sel(qA, qB), sel(tA, tB)
        ssA2, uA2, qA2, tA2 = sel(ss_new, ssA), sel(u_new, uA), sel(q_new, qA), sel(T, tA)
        xcurv_next = sel(xcurv_next - lapshift, xcurv_next)
        k_in_lap2 = sel(jnp.zeros_like(k_in_lap), k_in_lap + 1)
        lap_idx2 = lap_idx + crossing.astype(lap_idx.dtype)

        lin_points_next = jnp.concatenate([X[1:], X[-1:]], axis=0)
        lin_input_next = jnp.concatenate([U[1:], U[-1:]], axis=0)
        z_warm_next = jnp.concatenate([U[1:].reshape(-1), U[-1], sol.z[n_u:]])

        frozen = lambda new, old: jnp.where(done, old, new)
        carry_next = (
            frozen(xcurv_next, xcurv),
            frozen(xglob_next, xglob),
            frozen(ssA2, ssA), frozen(uA2, uA), frozen(qA2, qA), frozen(tA2, tA),
            frozen(ssB2, ssB), frozen(uB2, uB), frozen(qB2, qB), frozen(tB2, tB),
            lap_ss, lap_u,
            frozen(lin_points_next, lin_points),
            frozen(lin_input_next, lin_input),
            frozen(u, u_prev),
            frozen(z_warm_next, z_warm),
            frozen(k_in_lap2, k_in_lap),
            frozen(lap_idx2, lap_idx),
        )
        return carry_next, (xcurv, u, lap_idx, done)

    i32 = jnp.int32
    init = (
        xcurv0, xglob0,
        ss_prev, u_prev_lap, qfun_prev, jnp.asarray(t_prev, i32),
        ss_prev2, u_prev2_lap, qfun_prev2, jnp.asarray(t_prev2, i32),
        jnp.full((P, X_DIM), 1e4, dtype), jnp.full((P, U_DIM), 1e4, dtype),
        lin_points0, lin_input0,
        jnp.zeros(U_DIM, dtype), z_warm0,
        jnp.asarray(0, i32), jnp.asarray(0, i32),
    )
    final, (xcurvs, us, lap_ids, dones) = jax.lax.scan(step, init, jnp.arange(n_steps))
    xcurvs = jnp.concatenate([xcurvs, final[0][None]], axis=0)
    active = ~dones
    lap_steps = jnp.stack(
        [jnp.sum(active & (lap_ids == j)) for j in range(n_laps)]
    ).astype(i32)
    laps_done = final[-1]
    return xcurvs, us, lap_steps, laps_done


@partial(
    numerics.jit,
    static_argnames=(
        "n_steps", "control_dt", "sub_dt", "tracker_iters", "tracker_iters_cold",
        "dynamics_unroll",
    ),
)
def rollout_racing_game(
    track: track_ops.Track,
    bike_params: dynamics.BicycleParams,
    lmpc_param: LMPCParam,
    rg_param,  # RacingGameParam
    sys_param: SystemParam,
    xcurv0: jax.Array,
    xglob0: jax.Array,
    ss_prev: jax.Array,  # (P, X_DIM) lap iter-1 safe set (sentinel-padded)
    qfun_prev: jax.Array,  # (P,)
    ss_prev2: jax.Array,  # (P, X_DIM) lap iter-2
    qfun_prev2: jax.Array,  # (P,)
    u_prev_lap: jax.Array,  # (P, U_DIM)
    u_prev2_lap: jax.Array,  # (P, U_DIM)
    valid_prev: jax.Array,  # (P,)
    valid_prev2: jax.Array,  # (P,)
    counter: jax.Array,  # () int32
    lin_points0: jax.Array,  # (N_lmpc+1, X_DIM)
    lin_input0: jax.Array,  # (N_lmpc, U_DIM)
    obs_s_coef: jax.Array,  # (n_veh, deg+1) s(t) polynomials, SORTED ey desc
    obs_ey_coef: jax.Array,  # (n_veh, deg+1)
    opti_traj_xcurv: jax.Array,  # (T, X_DIM) stored raceline
    n_steps: int = 300,
    control_dt: float = 0.1,
    sub_dt: float = 0.001,
    tracker_iters: int = 20,  # warm-step IPM iters (= policies.CBF_ITERS_WARM)
    tracker_iters_cold: int = 40,  # episode-first cold solve (= CBF_ITERS_COLD)
    dynamics_unroll: int = 1,
):
    """The FLAGSHIP path fully fused: one on-device racing-game lap.

    Every control step runs the reference's LMPCRacingGame dispatch
    (base.py:456-583) inside one ``lax.scan``: proximity triggers
    (planner_helper.py:218-266) select via ``lax.cond`` between

    - the LMPC learning step (regression + safe-set selection + convex-hull
      terminal QP — the rollout_lmpc_lap body), and
    - the overtake step: Bezier corridor references (ops/bezier.py), the
      corridor branch-QP batch (planning/overtake._solve_branch_batch — the
      component the reference forks one OS process per branch for),
      kinematic fallback, progress/collision/hysteresis branch selection,
      and the warm-started multi-agent CBF tracker.

    Prescribed traffic follows polynomial (s(t), ey(t)) schedules with
    constant ey, pre-sorted by ey (descending) by the caller — so the
    corridor ordering is static, the one host-side decision of the
    reference planner that cannot be a runtime mask.  The corridor
    problem is restricted to the vehicles-of-interest subset exactly as
    the host loop (and the reference, overtake_traj_planner.py:70-92):
    the per-vehicle interest mask compacts active vehicles to the front
    (stable argsort keeps the ey-descending order), branch count and
    neighbor gates follow the ACTIVE count m as runtime masks over the
    static n_veh+1 branches, and the CBF tracker sees the same
    MAX_OBSTACLES-row zero-padded obstacle layout the host builds
    (policies.py:565-581) with the host's cold/warm iteration split
    (CBF_ITERS_COLD + warm=None on the first step of an episode,
    CBF_ITERS_WARM + shifted primal-dual triple after, selected at runtime
    in one traced solve via mpc_multi_agents ``warm_select``) —
    the fused lap is numerically identical to the host loop
    (tests/test_fused.py::test_fused_racing_game_matches_host_loop).

    Returns (xcurv_traj (n_steps+1, X), u_traj (n_steps, U),
    overtake_flags (n_steps,) bool, lap_steps).
    """
    from ..ops import lmpc_learning as _ll
    from ..planning import overtake as _ov
    from .policies import MAX_OBSTACLES as _N_OBS

    N = lmpc_param.num_horizon
    Np = rg_param.num_horizon_planner
    Nc = rg_param.num_horizon_ctrl
    K = lmpc_param.num_ss_points
    K_per = K // lmpc_param.num_ss_iter
    dtype = xcurv0.dtype
    L = track.lap_length.astype(dtype)
    W = track.width.astype(dtype)
    P = ss_prev.shape[0]
    n_u = N * U_DIM
    n_veh = obs_s_coef.shape[0]
    n_br = n_veh + 1
    veh_len, veh_wid = jnp.asarray(0.4, dtype), jnp.asarray(0.2, dtype)
    agent_half = jnp.stack([veh_len / 2, veh_wid / 2])
    obs_vs = jax.vmap(jnp.polyder)(obs_s_coef)
    obs_vey = jax.vmap(jnp.polyder)(obs_ey_coef)

    u_data = jnp.stack([u_prev2_lap, u_prev_lap])
    valid = jnp.stack([valid_prev2, valid_prev])

    z_warm_cold = jnp.zeros(n_u + K, dtype).at[n_u:].set(1.0 / K)
    # placeholder primal-dual triple carried while no overtake episode is
    # live; the episode's FIRST tracker solve ignores it (warm=None cold
    # path, exactly the host's _z_warm_ma = None protocol) and every
    # later step carries the shifted triple.  Sized to the host tracker's
    # MAX_OBSTACLES-row layout (policies.py:565-567).  The fourth entry
    # says whether the triple may seed the next solve: False here, and
    # after a failed solve (controllers.WARM_RES_MAX).
    nz_t = Nc * U_DIM + _N_OBS * (Nc + 1)
    m_t = 2 * Nc * U_DIM + 4 * Nc + _N_OBS * (Nc + 1) + _N_OBS * Nc
    warm_ma_cold = (
        jnp.zeros(nz_t, dtype).at[Nc * U_DIM :].set(0.1),
        jnp.full((m_t,), 1.0, dtype),
        jnp.full((m_t,), 0.1, dtype),
        jnp.asarray(False),
    )

    def obs_forecast(t, horizon):
        ts = t + control_dt * jnp.arange(horizon + 1, dtype=dtype)
        s = jax.vmap(lambda c: jnp.polyval(c, ts))(obs_s_coef)
        ey = jax.vmap(lambda c: jnp.polyval(c, ts))(obs_ey_coef)
        vs = jax.vmap(lambda c: jnp.polyval(c, ts))(obs_vs)
        vey = jax.vmap(lambda c: jnp.polyval(c, ts))(obs_vey)
        zeros = jnp.zeros_like(s)
        return jnp.stack([vs, vey, zeros, zeros, s, ey], axis=2)

    def lmpc_branch(op):
        (x, t, ss1, lin_points, lin_input, u_prev, z_warm, warm_ma, old_dir,
         _interest) = op
        curvs = track_ops.curvature_batch(track, jnp.mod(lin_points[:N, 4], L))
        A_tv, B_tv, C_tv = _ll.estimate_abc_horizon(
            lin_points[:N], lin_input[:N], jnp.stack([ss_prev2, ss1]), u_data,
            valid, curvs, jnp.asarray(control_dt, dtype),
        )
        pts1, q1 = _ll.select_points(ss1, qfun_prev, x, K_per, lmpc_param.shift)
        pts2, q2 = _ll.select_points(ss_prev2, qfun_prev2, x, K_per, lmpc_param.shift)
        U, X, sol = controllers.lmpc(
            x, lmpc_param, A_tv, B_tv, C_tv,
            jnp.concatenate([pts1, pts2], axis=1), jnp.concatenate([q1, q2]),
            u_prev, sys_param, L, W, z_warm=z_warm, num_horizon=N,
        )
        lin_points_next = jnp.concatenate([X[1:], X[-1:]], axis=0)
        lin_input_next = jnp.concatenate([U[1:], U[-1:]], axis=0)
        z_warm_next = jnp.concatenate([U[1:].reshape(-1), U[-1], sol.z[n_u:]])
        # the overtake episode (if any) ended: tracker restarts cold, the
        # direction hysteresis resets (host: policies.py LMPC branch)
        return (
            U[0], lin_points_next, lin_input_next, U[0], z_warm_next,
            warm_ma_cold, jnp.asarray(-1, jnp.int32),
        )

    def overtake_branch(op):
        """The overtake step, restricted to the vehicles-of-interest
        subset exactly as the host loop: compaction via stable argsort
        keeps the ey-descending order, branch validity / neighbor gates
        follow the active count m, the tracker sees the host's
        MAX_OBSTACLES-row zero-padded obstacle layout.  The tracker solve
        selects its configuration AT RUNTIME (mpc_multi_agents
        warm_select): the episode-first step takes the host's COLD
        configuration (warm=None init + the cold iteration budget), later
        steps the shifted warm triple + the warm budget
        (policies.py:600-601) — one traced solve, bit-identical per
        configuration, so vmapped fleets run one tracker per lane."""
        (x, t, ss1, lin_points, lin_input, u_prev, z_warm, warm_ma, old_dir,
         interest) = op
        m = jnp.sum(interest)  # >= 1 on this branch
        # active vehicles to the front; obstacles are pre-sorted by ey
        # descending, so the compacted subset keeps that order (the
        # host re-sorts the interest dict, overtake.py:337-340)
        order = jnp.argsort(jnp.logical_not(interest), stable=True)
        active = jnp.arange(n_veh) < m

        obs_trajs = obs_forecast(t, Np)[order]  # (n_veh, Np+1, X) compacted
        veh_infos = jnp.stack(
            [
                obs_trajs[:, 0, 4],
                obs_trajs[:, :, 5].max(axis=1),
                obs_trajs[:, :, 5].min(axis=1),
            ],
            axis=1,
        )
        max_delta_v = jnp.max(
            jnp.where(active, jnp.abs(x[0] - obs_trajs[:, 0, 0]), -jnp.inf)
        )
        cp = bezier_mod.corridor_control_points(
            n_veh, x, veh_infos, max_delta_v, L, W, veh_wid,
            opti_traj_xcurv, rg_param.planning_prediction_factor,
            num_active=m,
        )
        bez = bezier_mod.sample_corridors(cp, Np + 1)  # (n_br, Np+1, 2)

        # neighbor rows + gates (planning/overtake.py get_local_traj);
        # the m+1 branches of the host problem are rows 0..m here,
        # rows > m are finite garbage masked out of the selection
        s_pred = x[4] + jnp.arange(Np + 1, dtype=dtype) * control_dt * x[0]
        obs_s_w = jnp.mod(obs_trajs[:, :, 4], L)  # (n_veh, Np+1)
        obs_ey = obs_trajs[:, :, 5]
        gate_of = (
            jnp.abs(s_pred[None] - obs_s_w)
            <= veh_len + rg_param.corridor_hold
        )  # (n_veh, Np+1)
        br = jnp.arange(n_br)
        li = jnp.clip(br - 1, 0, n_veh - 1)
        ri = jnp.clip(br, 0, n_veh - 1)
        br_valid = br <= m
        left_valid = (br >= 1) & br_valid
        right_valid = br < m
        left_ey = obs_ey[li]
        left_gate = gate_of[li] & left_valid[:, None]
        right_ey = obs_ey[ri]
        right_gate = gate_of[ri] & right_valid[:, None]

        X_all, _, conv, _ = _ov._solve_branch_batch(
            x, rg_param.A, rg_param.B, W, veh_wid, bez,
            left_ey[:, :Np], left_gate[:, :Np],
            right_ey[:, :Np], right_gate[:, :Np],
            num_horizon=Np,
        )
        # kinematic fallback for unconverged branches
        # (overtake_traj_planner.py:365-374)
        X_kin = jax.vmap(
            lambda bez_b: _ov.kinematic_fallback_traj(x, bez_b, Np, dt=control_dt)
        )(bez)
        X_all = jnp.where(conv[:, None, None], X_all, X_kin)

        # branch selection through the SHARED cost the host path uses
        # (overtake_traj_planner.py:205-244); invalid branches -> +inf
        cost_sel = jax.vmap(
            lambda Xb, ls, le, rs, re, lv, rv, b: _ov.branch_selection_cost(
                Xb, ls, le, rs, re, lv, rv, veh_len, veh_wid, old_dir, b
            )
        )(
            X_all, obs_s_w[li], obs_ey[li], obs_s_w[ri], obs_ey[ri],
            left_valid, right_valid, br.astype(jnp.int32),
        )
        cost_sel = jnp.where(br_valid, cost_sel, jnp.inf)
        direction = jnp.argmin(cost_sel)
        target = X_all[direction]  # (Np+1, X)

        # multi-agent CBF tracker on the planned trajectory, on the
        # host's MAX_OBSTACLES-row layout (policies.py:556-604):
        # interest rows compacted to the front, zero rows + unit
        # half-dims beyond, mask = active & gate
        s_stage = jnp.clip(
            x[0] * control_dt * jnp.arange(1, Nc + 1, dtype=dtype) + x[4],
            target[0, 4], target[-1, 4],
        )
        ey_t = jnp.interp(s_stage, target[:, 4], target[:, 5])
        x_targets = (
            jnp.zeros((Nc, X_DIM), dtype).at[:, 0].set(x[0]).at[:, 5].set(ey_t)
        )
        obs_fc = obs_forecast(t, Nc)[order]  # (n_veh, Nc+1, X) compacted
        row = jnp.arange(_N_OBS)
        row_active = row < m
        obs_tr = jnp.where(
            row_active[:, None, None],
            obs_fc[jnp.clip(row, 0, n_veh - 1)],
            0.0,
        )
        obs_halfs_t = jnp.where(row_active[:, None], agent_half[None], 1.0)
        gate = controllers.obstacle_gate_mask(x, obs_tr[:, 0, 4], L)

        # episode-first step: the host's _z_warm_ma is None and it solves
        # COLD with the cold iteration budget (policies.py:600-601); after
        # that the shifted primal-dual triple + warm budget.  old_dir < 0
        # exactly tracks "episode not live" (both reset on the LMPC branch).
        # warm_select merges both configurations into ONE traced solve
        # (bit-identical per configuration, see mpc_multi_agents) so
        # vmapped fleets run one tracker solve per lane, not two branches.
        # A solve that failed (residual above WARM_RES_MAX) seeds nothing:
        # the step after it solves cold, as the host does.
        u0, U, Xp, sol = controllers.mpc_multi_agents(
            x, x_targets, rg_param.A, rg_param.B, rg_param.Q, rg_param.R,
            sys_param, W, obs_tr, row_active & gate, agent_half,
            obs_halfs_t, L,
            iters=tracker_iters_cold,
            warm_select=((old_dir >= 0) & warm_ma[3], warm_ma[:3]),
            iters_warm=tracker_iters,
        )
        warm_ma_next = (*controllers.shift_cbf_warm(sol, Nc, _N_OBS),
                        sol.kkt_res < controllers.WARM_RES_MAX)
        lin_points_next = jnp.concatenate([Xp[1:], Xp[-1:]], axis=0)
        lin_input_next = jnp.concatenate([U[1:], U[-1:]], axis=0)
        pad_p = N + 1 - lin_points_next.shape[0]
        pad_u = N - lin_input_next.shape[0]
        lin_points_next = jnp.concatenate(
            [lin_points_next] + [lin_points_next[-1:]] * pad_p, axis=0
        )
        lin_input_next = jnp.concatenate(
            [lin_input_next] + [lin_input_next[-1:]] * pad_u, axis=0
        )
        # u_prev (the LMPC input-rate anchor) and the LMPC warm start are
        # NOT advanced during overtakes (host: u_pred/_z_warm only set on
        # the LMPC branch; _z_warm invalidated -> cold restart after the
        # episode)
        return (
            u0, lin_points_next, lin_input_next, u_prev, z_warm_cold,
            warm_ma_next, direction.astype(jnp.int32),
        )


    def step(carry, k):
        (xcurv, xglob, ss1, lin_points, lin_input, u_prev, z_warm, warm_ma,
         old_dir, done) = carry
        x = xcurv.at[4].set(jnp.mod(xcurv[4], L))
        t = k.astype(dtype) * control_dt

        # overtake trigger (check_ego_agent_distance, planner_helper.py:218-266)
        obs_now = obs_forecast(t, 0)[:, 0]  # (n_veh, X)
        s_a = jnp.mod(obs_now[:, 4], L)
        s_e = x[4]
        delta_v = jnp.abs(x[0] - obs_now[:, 0])
        front = rg_param.safety_factor * veh_len + rg_param.planning_prediction_factor * delta_v
        behind = veh_len
        within = lambda d, lim: (d >= 0) & (d <= lim)
        interest = (
            within(s_a - s_e, front)
            | within(s_a + L - s_e, front)
            | within(s_e - s_a, behind)
            | within(s_e + L - s_a, behind)
        )
        overtake = jnp.any(interest)

        op = (
            x, t, ss1, lin_points, lin_input, u_prev, z_warm, warm_ma, old_dir,
            interest,
        )
        (u, lin_points_n, lin_input_n, u_prev_n, z_warm_n, warm_ma_n, old_dir_n) = (
            jax.lax.cond(overtake, overtake_branch, lmpc_branch, op)
        )

        xglob_next, xcurv_next = dynamics.propagate(
            track, bike_params, xglob, xcurv, u,
            control_dt=control_dt, sub_dt=sub_dt, unroll=dynamics_unroll,
        )
        done_next = done | (xcurv_next[4] >= L)

        idx = jnp.clip(counter + k + 1, 0, P - 1)
        appended = x + jnp.zeros(X_DIM, dtype).at[4].set(L)
        ss1_next = jnp.where(done, ss1, ss1.at[idx].set(appended))

        frozen = lambda new, old: jnp.where(done, old, new)
        carry_next = (
            frozen(xcurv_next, xcurv),
            frozen(xglob_next, xglob),
            ss1_next,
            frozen(lin_points_n, lin_points),
            frozen(lin_input_n, lin_input),
            frozen(u_prev_n, u_prev),
            frozen(z_warm_n, z_warm),
            jax.tree.map(frozen, warm_ma_n, warm_ma),
            jnp.where(done, old_dir, old_dir_n),
            done_next,
        )
        return carry_next, (xcurv, u, overtake & ~done, done)

    init = (
        xcurv0, xglob0, ss_prev, lin_points0, lin_input0,
        jnp.zeros(U_DIM, dtype), z_warm_cold, warm_ma_cold,
        jnp.asarray(-1, jnp.int32), jnp.asarray(False),
    )
    final, (xcurvs, us, ot_flags, dones) = jax.lax.scan(step, init, jnp.arange(n_steps))
    xcurvs = jnp.concatenate([xcurvs, final[0][None]], axis=0)
    lap_steps = jnp.sum(~dones)
    return xcurvs, us, ot_flags, lap_steps


@partial(
    numerics.jit,
    static_argnames=(
        "n_steps", "control_dt", "sub_dt", "tracker_iters", "tracker_iters_cold",
        "dynamics_unroll",
    ),
)
def rollout_racing_game_batch(
    track, bike_params, lmpc_param, rg_param, sys_param,
    xcurv0_batch, xglob0_batch,  # (B, X_DIM) per-scenario starts
    ss_prev, qfun_prev, ss_prev2, qfun_prev2,
    u_prev_lap, u_prev2_lap, valid_prev, valid_prev2, counter,
    lin_points0, lin_input0, obs_s_coef, obs_ey_coef, opti_traj_xcurv,
    n_steps: int = 300, control_dt: float = 0.1, sub_dt: float = 0.001,
    tracker_iters: int = 20, tracker_iters_cold: int = 40, dynamics_unroll: int = 1,
):
    """vmap of :func:`rollout_racing_game` over a batch of initial states —
    a fleet of simultaneous racing games on one chip (scenario DP on the
    flagship path; shard the batch across a mesh with
    parallel/mesh.fleet_rollout).  Shared safe sets and traffic; under
    vmap the LMPC/overtake ``lax.cond`` lowers to a select (both branches
    execute for every lane), the price of divergent per-lane dispatch.

    ``dynamics_unroll`` defaults to 1 like the single-lane rollout it
    vmaps, keeping the public batch entry point bitwise-consistent with
    it (unroll changes XLA fusion and drifts closed loops — golden-
    breaking elsewhere in the repo).  parallel/mesh.fleet_rollout opts
    into ``dynamics_unroll=10``, which shortens the substep scan's
    sequential chain where the scan runs; on CUDA the integrator kernel
    runs instead and the knob has no effect (see ops/dynamics.propagate)."""
    fn = lambda xc, xg: rollout_racing_game(
        track, bike_params, lmpc_param, rg_param, sys_param, xc, xg,
        ss_prev, qfun_prev, ss_prev2, qfun_prev2,
        u_prev_lap, u_prev2_lap, valid_prev, valid_prev2, counter,
        lin_points0, lin_input0, obs_s_coef, obs_ey_coef, opti_traj_xcurv,
        n_steps=n_steps, control_dt=control_dt, sub_dt=sub_dt,
        tracker_iters=tracker_iters, tracker_iters_cold=tracker_iters_cold,
        dynamics_unroll=dynamics_unroll,
    )
    return jax.vmap(fn)(xcurv0_batch, xglob0_batch)


@partial(
    numerics.jit,
    static_argnames=("n_laps", "n_steps", "control_dt", "sub_dt", "dynamics_unroll"),
)
def rollout_lmpc_learning_batch(
    track, bike_params, lmpc_param, sys_param,
    xcurv0_batch, xglob0_batch,  # (B, X_DIM) per-lane starts
    ss_prev, qfun_prev, u_prev_lap, t_prev,
    ss_prev2, qfun_prev2, u_prev2_lap, t_prev2,
    lin_points0, lin_input0,
    n_laps: int = 3, n_steps: int = 600,
    control_dt: float = 0.1, sub_dt: float = 0.001,
    dynamics_unroll: int = 1,
):
    """vmap of :func:`rollout_lmpc_learning` over a batch of initial
    states: B independent multi-lap learning curves from shared seed
    columns (scenario DP over the learning protocol itself; shard across
    a mesh with parallel/mesh.learning_fleet).  Like the racing-game
    fleet, defaults to ``dynamics_unroll=1`` for bitwise consistency with
    the per-lane rollout; throughput call sites opt into 10."""
    fn = lambda xc, xg: rollout_lmpc_learning(
        track, bike_params, lmpc_param, sys_param, xc, xg,
        ss_prev, qfun_prev, u_prev_lap, t_prev,
        ss_prev2, qfun_prev2, u_prev2_lap, t_prev2,
        lin_points0, lin_input0,
        n_laps=n_laps, n_steps=n_steps, control_dt=control_dt,
        sub_dt=sub_dt, dynamics_unroll=dynamics_unroll,
    )
    return jax.vmap(fn)(xcurv0_batch, xglob0_batch)


@partial(numerics.jit, static_argnames=("n_steps", "control_dt", "sub_dt"))
def rollout_mpc_tracking_batch(
    track, bike_params, mpc_param, sys_param, xtarget, xcurv0_batch, xglob0_batch,
    n_steps: int = 100, control_dt: float = 0.1, sub_dt: float = 0.001,
):
    """vmap of :func:`rollout_mpc_tracking` over a batch of initial states —
    many simultaneous closed-loop simulations on one chip (scenario DP)."""
    fn = lambda xc, xg: rollout_mpc_tracking(
        track, bike_params, mpc_param, sys_param, xtarget, xc, xg,
        n_steps=n_steps, control_dt=control_dt, sub_dt=sub_dt,
    )
    return jax.vmap(fn)(xcurv0_batch, xglob0_batch)
