"""Controller solve functions — pure, jitted, vmappable.

Each controller from the reference's control layer
(car_racing/control/control.py) re-built accelerator-first:

- :func:`pid`      (reference control.py:15-25)
- :func:`lqr`      (control.py:28-61)   — Riccati fixed point via lax.scan
- :func:`mpc_lti`  (control.py:198-248) — condensed QP -> interior point
- :func:`ilqr`     (control.py:64-195)  — scan-based iLQR with CBF cost
- :func:`mpccbf`   (control.py:476-607) — NLP with discrete CBF rows -> IPM
- :func:`lmpc`     (control.py:610-730) — convex-safe-set QP -> IPM

Where the reference gates obstacles / builds constraint topology with
Python-side conditionals, these use static-shape masks (inactive rows are
replaced with trivially-satisfied constraints), so one compiled program
covers every obstacle configuration.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..ops import ipm, ocp, riccati
from ..utils import numerics
from ..utils.constants import U_DIM, X_DIM
from ..utils.params import (
    ILQRParam,
    LMPCParam,
    LQRParam,
    MPCCBFParam,
    MPCParam,
    SystemParam,
)


def target_state(vt, eyt, dtype=jnp.float32):
    return jnp.array([vt, 0.0, 0.0, 0.0, 0.0, eyt], dtype=dtype)


# ---------------------------------------------------------------------------
# PID (control.py:15-25)
# ---------------------------------------------------------------------------


@numerics.jit
def pid(xcurv: jax.Array, xtarget: jax.Array) -> jax.Array:
    delta = -0.6 * (xcurv[5] - xtarget[5]) - 0.9 * xcurv[3]
    a = 1.5 * (xtarget[0] - xcurv[0])
    return jnp.stack([delta, a])


# ---------------------------------------------------------------------------
# LQR (control.py:28-61)
# ---------------------------------------------------------------------------


@numerics.jit
def lqr(xcurv: jax.Array, xtarget: jax.Array, param: LQRParam) -> jax.Array:
    _, K = riccati.dare_iterate(param.A, param.B, param.Q, param.R, param.max_iter)
    return -K @ (xcurv - xtarget)


# ---------------------------------------------------------------------------
# MPC-LTI tracking (control.py:198-248)
# ---------------------------------------------------------------------------


def _tracking_qp(param, sys_param: SystemParam, track_width, x0, xtarget, extra_cost=None):
    """Condensed QP shared by MPC-LTI (and the CBF problem's convex part)."""
    N = param.num_horizon
    phi, G = ocp.condense_lti(param.A, param.B, N, x0)
    x_targets = jnp.broadcast_to(xtarget, (N, X_DIM))
    H, g = ocp.quadratic_tracking_cost(phi, G, param.Q, param.R, x_targets, N)
    n_z = N * U_DIM
    u_min = jnp.stack([-sys_param.delta_max, -sys_param.a_max])
    u_max = jnp.stack([sys_param.delta_max, sys_param.a_max])
    C_u, d_u = ocp.input_box_rows(N, U_DIM, u_min, u_max, n_z)
    C_vx, d_vx = ocp.state_bound_rows(G, phi, 0, sys_param.v_min, sys_param.v_max, n_z)
    C_ey, d_ey = ocp.state_bound_rows(G, phi, 5, -track_width, track_width, n_z)
    C, d = ocp.stack_rows((C_u, d_u), (C_vx, d_vx), (C_ey, d_ey))
    E = jnp.zeros((0, n_z), H.dtype)
    e = jnp.zeros((0,), H.dtype)
    return ipm.QP(H=H, g=g, C=C, d=d, E=E, e=e), phi, G


@partial(numerics.jit, static_argnames=("return_traj", "kkt"))
def mpc_lti(
    xcurv: jax.Array,
    xtarget: jax.Array,
    param: MPCParam,
    sys_param: SystemParam,
    track_width: jax.Array,
    u_warm: jax.Array | None = None,
    return_traj: bool = False,
    kkt: str = "dense",
):
    """MPC tracking QP: LTI dynamics, box input/state rows, track width.

    ``kkt`` selects the Newton-step factorization: "dense" condenses onto U
    and factorizes the (N*U_DIM)^2 system; "riccati" solves the same QP via
    the stage-structured block-tridiagonal path (ipm.solve_ocp_qp) — O(N)
    time/memory per IPM iteration; "riccati_parallel" is the same path
    with the associative-scan (O(log N) depth) backward pass and rollout
    (riccati.tvlqr_backward_parallel — SURVEY §5.7's horizon-parallel
    factorization).  All return the same solution (parity tests:
    tests/test_ipm.py); ``python -m car_racing_tpu.utils.crossover``
    measures the crossover on the attached device.

    Returns u_0 (and optionally (U, X) open-loop trajectories).
    """
    N = param.num_horizon
    if kkt in ("riccati", "riccati_parallel"):
        u_min = jnp.stack([-sys_param.delta_max, -sys_param.a_max])
        u_max = jnp.stack([sys_param.delta_max, sys_param.a_max])
        U0 = (
            u_warm.reshape(N, U_DIM)
            if u_warm is not None
            else jnp.zeros((N, U_DIM), xcurv.dtype)
        )
        U, X, sol = ipm.solve_ocp_qp(
            param.A, param.B, param.Q, param.R, xcurv, xtarget,
            u_min, u_max, sys_param.v_min, sys_param.v_max,
            jnp.asarray(track_width, xcurv.dtype), U0,
            num_horizon=N, iters=30,
            stage_parallel=(kkt == "riccati_parallel"),
        )
        if return_traj:
            return U[0], U, X
        return U[0]
    qp, phi, G = _tracking_qp(param, sys_param, track_width, xcurv, xtarget)
    z0 = u_warm if u_warm is not None else jnp.zeros(N * U_DIM, qp.H.dtype)
    sol = ipm.solve_qp(qp, z0, iters=30)
    U = sol.z.reshape(N, U_DIM)
    if return_traj:
        X = ocp.unpack_states(phi, G, sol.z, xcurv)
        return U[0], U, X
    return U[0]


# ---------------------------------------------------------------------------
# iLQR with CBF repelling cost (control.py:64-195, ilqr_helper.py)
# ---------------------------------------------------------------------------


def _ilqr_cost_terms(param, xvar, uvar, xtarget, obs_traj, agent_half, obs_half):
    """Stage cost derivatives incl. the CBF repelling term
    (reference ilqr_helper.get_cost_derivation, ilqr_helper.py:4-48).

    xvar: (N+1, X_DIM) current trajectory; obs_traj: (N, X_DIM) obstacle
    positions over the horizon (the reference keeps only the final listed
    obstacle, control.py:100-105 — callers replicate that by passing it).
    """
    N = uvar.shape[0]
    Q, R = param.Q, param.R
    safety_margin = 0.15
    q1 = q2 = 2.5
    l_half, w_half = agent_half[0] + obs_half[0], agent_half[1] + obs_half[1]
    P_diag = jnp.array([0.0, 0.0, 0.0, 0.0, 1.0 / l_half**2, 1.0 / w_half**2])

    def stage(xk, uk, obs_k):
        dx = xk - xtarget
        l_x = 2 * Q @ dx
        l_xx = 2 * Q
        l_u = 2 * R @ uk
        l_uu = 2 * R
        diff = jnp.array([0.0, 0.0, 0.0, 0.0, xk[4] - obs_k[4], xk[5] - obs_k[5]])
        h = 1.0 + safety_margin - jnp.sum(P_diag * diff * diff)
        h_dot = -2.0 * P_diag * diff
        b_dot = q1 * q2 * jnp.exp(q2 * h) * h_dot
        b_ddot = q1 * q2**2 * jnp.exp(q2 * h) * jnp.outer(h_dot, h_dot)
        return l_x + b_dot, l_xx + b_ddot, l_u, l_uu

    l_x, l_xx, l_u, l_uu = jax.vmap(stage)(xvar[:N], uvar, obs_traj[:N])
    return l_x, l_u, l_xx, l_uu


@partial(numerics.jit, static_argnames=("return_seq",))
def ilqr(
    xcurv: jax.Array,
    xtarget: jax.Array,
    param: ILQRParam,
    obs_traj: jax.Array,
    agent_half: jax.Array,
    obs_half: jax.Array,
    u_init: jax.Array | None = None,
    return_seq: bool = False,
):
    """iLQR on the LTI model with a CBF repelling obstacle cost.

    Mirrors the reference solve (control.py:111-191): forward rollout,
    eigen-regularized backward pass, accept/reject with a Levenberg lambda
    schedule (x10 up / /10 down, capped at 1000) — all under one
    lax.while_loop with masked accept/reject instead of Python
    break/continue.

    ``u_init`` warm-starts the control sequence (the reference restarts
    from zeros every call, control.py:97; closed-loop callers shift the
    previous step's solution instead — warm solves exit the Levenberg loop
    in a few iterations, cold ones in ~10-20).  With ``return_seq`` the
    full ``(u0, uvar, iters)`` comes back so callers can shift-warm the
    next solve and log real iteration counts.
    """
    N = param.num_horizon
    A, B = param.A, param.B
    dtype = xcurv.dtype

    def rollout(uvar):
        def body(x, u):
            x_next = A @ x + B @ u
            return x_next, x

        xT, xs = jax.lax.scan(body, xcurv, uvar)
        return jnp.concatenate([xs, xT[None]], axis=0)

    def total_cost(xvar, uvar):
        dx = xvar - xtarget
        cx = jnp.einsum("ki,ij,kj->", dx, param.Q, dx)
        cu = jnp.einsum("ki,ij,kj->", uvar, param.R, uvar)
        return cx + cu

    def iteration(carry):
        uvar, xvar, cost, lamb, done, it = carry
        l_x, l_u, l_xx, l_uu = _ilqr_cost_terms(
            param, xvar, uvar, xtarget, obs_traj, agent_half, obs_half
        )
        Vx_T = 2 * param.Q @ (xvar[N] - xtarget)
        Vxx_T = 2 * param.Q
        f_x = jnp.broadcast_to(A, (N,) + A.shape)
        f_u = jnp.broadcast_to(B, (N,) + B.shape)
        ks, Ks = riccati.tvlqr_backward(f_x, f_u, l_x, l_u, l_xx, l_uu, Vx_T, Vxx_T, lamb)
        xs_new, us_new = riccati.tvlqr_rollout(A, B, xcurv, uvar, xvar[:N], ks, Ks)
        cost_new = total_cost(xs_new, us_new)
        accept = cost_new < cost
        conv = jnp.abs((cost_new - cost) / jnp.maximum(jnp.abs(cost), 1e-12)) < 0.01
        uvar = jnp.where(accept & ~done, us_new, uvar)
        xvar = jnp.where(accept & ~done, xs_new, xvar)
        cost = jnp.where(accept & ~done, cost_new, cost)
        lamb_next = jnp.where(accept, lamb / 10.0, lamb * 10.0)
        done = done | (accept & conv) | (lamb_next > 1000.0)
        lamb = jnp.where(done, lamb, lamb_next)
        return (uvar, xvar, cost, lamb, done, it + 1)

    u0 = jnp.zeros((N, U_DIM), dtype) if u_init is None else u_init.astype(dtype)
    x0_traj = rollout(u0)
    init = (
        u0,
        x0_traj,
        total_cost(x0_traj, u0),
        jnp.asarray(1.0, dtype),
        jnp.asarray(False),
        jnp.asarray(0, jnp.int32),
    )
    # while_loop (not scan): converged solves exit after ~10-20 iterations
    # instead of always paying the full max_iter=150 sequential sweeps
    # (reference breaks out of its Python loop the same way, control.py:183-191).
    final = jax.lax.while_loop(
        lambda c: (~c[4]) & (c[5] < param.max_iter), iteration, init
    )
    uvar, iters = final[0], final[5]
    if return_seq:
        return uvar[0], uvar, iters
    return uvar[0]


# ---------------------------------------------------------------------------
# MPC-CBF (control.py:476-607)
# ---------------------------------------------------------------------------


# warm-start sanitization caps (see _cbf_nlp): primal slacks and IPM slack
# estimates restart from moderate values after deeply-violated episodes
# (their 1e4-5e4 barrier-scale magnitudes NaN the f32 Newton solve), while
# the multiplier cap stays ABOVE the 1e4 slack-penalty weight — the
# slack-positivity duals legitimately sit at that scale at stationarity,
# and capping them below it re-stalls the warm solve.
WARM_SLACK_MAX = 10.0
WARM_LAM_MAX = 2e4
WARM_S_MAX = 100.0
# A tracker solve whose KKT residual ends above this failed: its iterate
# is nowhere near the feasible set, and warm-starting the next step from
# it compounds (a racing-game lane on the GPU went from 2.9e6 to 1e8 over
# ten steps, steering decaying to zero, and left the track).  The caller
# solves the next step cold instead.  Healthy solves, converged or not,
# end below it: 4209 tracker solves in 32 CPU fleet lanes peaked at 6.0e4.
WARM_RES_MAX = 1e5


def obstacle_gate_mask(xcurv, obs_first_s, lap_length, safety_time=2.0):
    """Nearby-obstacle gating (control.py:499-523) as a mask: obstacle k is
    considered iff its wrapped s is within +-(vx * safety_time) of ego's."""
    margin = xcurv[0] * safety_time
    dist_ego = jnp.mod(xcurv[4], lap_length)
    dist_obs = jnp.mod(obs_first_s, lap_length)
    return (dist_ego > dist_obs - margin) & (dist_ego < dist_obs + margin)


def _cbf_nlp(
    xcurv,
    x_targets,  # (N, X_DIM) per-stage targets for x_1..x_N
    A,
    B,
    Q,
    R,
    N: int,
    sys_param: SystemParam,
    track_width,
    obs_trajs,
    obs_mask,
    agent_half,
    obs_halfs,
    lap_length,
    alpha,
    safety_margin,
    warm,  # None | (z, lam, s) previous primal-dual iterate
    iters: int,
    warm_select=None,  # (use_warm traced bool, (z, lam, s)) runtime config
    iters_warm: int | None = None,  # warm-side cap when warm_select is used
):
    """Shared CBF-constrained MPC core used by :func:`mpccbf` (margin 0.2,
    alpha from the param) and :func:`mpc_multi_agents` (margin 0.15,
    alpha 0.6, interpolated targets) — reference control.py:476-607 and
    control.py:251-473.

    Accelerator-first structure: the decision vector z = [U; slacks] enters the
    CBF rows only through the 2(N+1) scalars (s_k, ey_k) = affine maps of
    U — so the constraint values AND Jacobians are written in closed form
    (powers of the offsets chained through the condensed rows) and handed
    to :func:`ipm.solve_qp_nl` with the constant Gauss-Newton objective
    Hessian.  No autodiff through the constraint closure, no eigh in the
    loop: an order-of-magnitude smaller traced graph than the generic NLP
    path, with identical closed-loop behavior (tests/test_mpccbf.py)."""
    n_obs = obs_trajs.shape[0]
    dtype = xcurv.dtype
    degree = 6

    phi, G = ocp.condense_lti(A, B, N, xcurv)
    n_u = N * U_DIM
    n_slack = n_obs * (N + 1)
    n_z = n_u + n_slack
    num_cycle_ego = jnp.floor(xcurv[4] / lap_length)

    # stage maps: t_s = p_s + G_s U, t_ey likewise, stages 0..N (stage 0 const)
    sel_s = jnp.arange(N) * X_DIM + 4
    sel_ey = jnp.arange(N) * X_DIM + 5
    zrow = jnp.zeros((1, n_u), dtype)
    G_s_all = jnp.concatenate([zrow, G[sel_s]], axis=0)  # (N+1, n_u)
    G_ey_all = jnp.concatenate([zrow, G[sel_ey]], axis=0)
    p_s_all = jnp.concatenate([xcurv[4:5], phi[sel_s]])
    p_ey_all = jnp.concatenate([xcurv[5:6], phi[sel_ey]])

    def states_of(z):
        return ocp.unpack_states(phi, G, z[:n_u], xcurv)

    # ---- quadratic objective over z -----------------------------------
    x_t_flat = x_targets.reshape(N * X_DIM)
    Qbar = jnp.kron(jnp.eye(N, dtype=dtype), Q)
    Rbar = jnp.kron(jnp.eye(N, dtype=dtype), R)
    H_u = 2.0 * (G.T @ Qbar @ G + Rbar)
    g_u = 2.0 * (G.T @ (Qbar @ (phi - x_t_flat)))
    H = jnp.zeros((n_z, n_z), dtype).at[:n_u, :n_u].set(H_u)
    H = H + 1e-9 * jnp.eye(n_z, dtype=dtype)
    slack_w = jnp.where(obs_mask[:, None], 1e4, 0.0) * jnp.ones((n_obs, N + 1), dtype)
    g = jnp.concatenate([g_u, slack_w.reshape(-1)])

    # ---- linear rows: input box, state bounds, slack >= 0 -------------
    I_u = jnp.zeros((n_u, n_z), dtype).at[:, :n_u].set(jnp.eye(n_u, dtype=dtype))
    sel_vx = jnp.arange(N) * X_DIM + 0
    Gv = jnp.zeros((N, n_z), dtype).at[:, :n_u].set(G[sel_vx])
    Ge = jnp.zeros((N, n_z), dtype).at[:, :n_u].set(G[sel_ey])
    I_sl = jnp.zeros((n_slack, n_z), dtype).at[:, n_u:].set(jnp.eye(n_slack, dtype=dtype))
    u_lo = jnp.tile(jnp.stack([-sys_param.delta_max, -sys_param.a_max]), N)
    u_hi = jnp.tile(jnp.stack([sys_param.delta_max, sys_param.a_max]), N)
    C_lin = jnp.concatenate([I_u, -I_u, -Gv, Gv, -Ge, Ge, I_sl], axis=0)
    d_lin = jnp.concatenate(
        [
            u_lo,
            -u_hi,
            phi[sel_vx] - sys_param.v_max,
            sys_param.v_min - phi[sel_vx],
            phi[sel_ey] - track_width,
            -track_width - phi[sel_ey],
            jnp.zeros(n_slack, dtype),
        ]
    )

    # ---- nonlinear CBF rows with closed-form Jacobian -----------------
    L6 = (agent_half[0] + obs_halfs[:, 0]) ** degree  # (n_obs,)
    W6 = (agent_half[1] + obs_halfs[:, 1]) ** degree
    num_cycle_obs = jnp.floor(obs_trajs[:, 0, 4] / lap_length)
    wrap_off = (num_cycle_ego - num_cycle_obs) * lap_length  # (n_obs,)
    o_s = obs_trajs[:, :, 4]  # (n_obs, N+1)
    o_ey = obs_trajs[:, :, 5]

    def c_nl(z):
        t_s = p_s_all + G_s_all @ z[:n_u]  # (N+1,)
        t_ey = p_ey_all + G_ey_all @ z[:n_u]
        sl = z[n_u:].reshape(n_obs, N + 1)
        # offsets: h_k gets the lap-wrap shift, h_{k+1} does not
        # (reference control.py:539-543)
        ds_k = t_s[None, :N] - o_s[:, :N] - wrap_off[:, None]  # (n_obs, N)
        ds_n = t_s[None, 1:] - o_s[:, 1:]
        de_k = t_ey[None, :N] - o_ey[:, :N]
        de_n = t_ey[None, 1:] - o_ey[:, 1:]
        h_k = ds_k**degree / L6[:, None] + de_k**degree / W6[:, None] - 1.0 - safety_margin - sl[:, :N]
        h_n = ds_n**degree / L6[:, None] + de_n**degree / W6[:, None] - 1.0 - safety_margin - sl[:, 1:]
        vals = h_n - (1.0 - alpha) * h_k  # (n_obs, N)
        vals = jnp.where(obs_mask[:, None], vals, 1.0)

        # d vals / d t_s[k+1] etc., chained through G rows
        dv_dts_n = degree * ds_n ** (degree - 1) / L6[:, None]  # (n_obs, N)
        dv_dts_k = -(1.0 - alpha) * degree * ds_k ** (degree - 1) / L6[:, None]
        dv_dte_n = degree * de_n ** (degree - 1) / W6[:, None]
        dv_dte_k = -(1.0 - alpha) * degree * de_k ** (degree - 1) / W6[:, None]
        # J_U[i,k,:] = dv_dts_n*G_s[k+1] + dv_dts_k*G_s[k] + (ey terms)
        J_U = (
            dv_dts_n[:, :, None] * G_s_all[None, 1:]
            + dv_dts_k[:, :, None] * G_s_all[None, :N]
            + dv_dte_n[:, :, None] * G_ey_all[None, 1:]
            + dv_dte_k[:, :, None] * G_ey_all[None, :N]
        )  # (n_obs, N, n_u)
        # slack derivatives: d vals / d sl[:, k+1] = -1 ; d / d sl[:, k] = (1-alpha)
        eyeN1 = jnp.eye(N + 1, dtype=dtype)
        J_sl_stage = -eyeN1[1:] + (1.0 - alpha) * eyeN1[:N]  # (N, N+1)
        J_sl = jnp.zeros((n_obs, N, n_obs, N + 1), dtype)
        J_sl = J_sl.at[jnp.arange(n_obs), :, jnp.arange(n_obs), :].set(
            jnp.broadcast_to(J_sl_stage, (n_obs, N, N + 1))
        )
        J = jnp.concatenate(
            [J_U.reshape(n_obs * N, n_u), J_sl.reshape(n_obs * N, n_slack)], axis=1
        )
        J = jnp.where(obs_mask.repeat(N)[:, None], J, 0.0)
        return vals.reshape(-1), J

    if warm_select is not None:
        # runtime cold/warm selection in ONE traced solve (ipm.solve_qp_nl
        # warm_if/iters_cap): per configuration the executed updates are
        # bit-identical to the two-branch version, but under vmap a mixed
        # fleet runs one tracker solve per lane instead of both branches
        if warm is not None:
            raise ValueError(
                "pass either warm (static config) or warm_select (runtime "
                "cold/warm selection), not both — warm would be silently "
                "ignored"
            )
        use_warm, (zw, lamw, sw) = warm_select
        z_cold = jnp.zeros(n_z, dtype).at[n_u:].set(0.1)
        zw = zw.at[n_u:].set(jnp.clip(zw[n_u:], 0.1, WARM_SLACK_MAX))
        z0 = jnp.where(use_warm, zw, z_cold)
        lam0 = jnp.clip(lamw, 1e-3, WARM_LAM_MAX)
        s0 = jnp.clip(sw, 1e-2, WARM_S_MAX)
        sol = ipm.solve_qp_nl(
            H, g, C_lin, d_lin, c_nl, z0, lam0=lam0, s0=s0, iters=iters,
            warm_if=use_warm,
            iters_cap=jnp.where(
                use_warm, iters if iters_warm is None else iters_warm, iters
            ),
        )
        U = sol.z[:n_u].reshape(N, U_DIM)
        return U, states_of(sol.z), sol
    if warm is None:
        z0 = jnp.zeros(n_z, dtype).at[n_u:].set(0.1)
        lam0 = s0 = None
    else:
        # Sanitize the warm iterate.  After a deeply violated episode the
        # previous solve's slacks/duals reach the 1e4-5e4 range (the
        # degree-6 barrier magnitudes); warm-starting f32 from there NaNs
        # the Newton solve, while clamped restarts converge as well as a
        # cold start on the same problems (measured on a captured failing
        # racing-game step).  Nominal warm iterates sit far below these
        # caps and pass through untouched.
        z0, lam0, s0 = warm
        z0 = z0.at[n_u:].set(jnp.clip(z0[n_u:], 0.1, WARM_SLACK_MAX))
        lam0 = jnp.clip(lam0, 1e-3, WARM_LAM_MAX)
        s0 = jnp.clip(s0, 1e-2, WARM_S_MAX)
    sol = ipm.solve_qp_nl(H, g, C_lin, d_lin, c_nl, z0, lam0=lam0, s0=s0, iters=iters)
    U = sol.z[:n_u].reshape(N, U_DIM)
    return U, states_of(sol.z), sol


@partial(numerics.jit, static_argnames=("return_traj", "iters"))
def mpccbf(
    xcurv: jax.Array,
    xtarget: jax.Array,
    param: MPCCBFParam,
    sys_param: SystemParam,
    track_width: jax.Array,
    obs_trajs: jax.Array,  # (n_obs, N+1, X_DIM) obstacle predictions
    obs_mask: jax.Array,  # (n_obs,) bool — False rows are ignored
    agent_half: jax.Array,  # (2,) ego (length/2, width/2)
    obs_halfs: jax.Array,  # (n_obs, 2)
    lap_length: jax.Array,
    warm=None,  # None | (z, lam, s) previous primal-dual iterate
    return_traj: bool = False,
    iters: int = 40,
):
    """MPC with discrete-time control-barrier-function rows per obstacle.

    Degree-6 superellipse barrier h and rows ``h_{k+1} - h_k >= -alpha h_k``
    with slack (>=0, 1e4-weighted in cost) exactly as control.py:524-562;
    obstacle gating becomes ``obs_mask`` (static shapes, masked rows).
    """
    N = param.num_horizon
    x_targets = jnp.broadcast_to(xtarget, (N, X_DIM))
    U, X, sol = _cbf_nlp(
        xcurv,
        x_targets,
        param.A,
        param.B,
        param.Q,
        param.R,
        N,
        sys_param,
        track_width,
        obs_trajs,
        obs_mask,
        agent_half,
        obs_halfs,
        lap_length,
        param.alpha,
        0.2,
        warm,
        iters=iters,
    )
    if return_traj:
        return U[0], U, X, sol
    return U[0]


@partial(numerics.jit, static_argnames=("iters", "iters_warm"))
def mpc_multi_agents(
    xcurv: jax.Array,
    x_targets: jax.Array,  # (N, X_DIM) interpolated overtake targets
    racing_game_A: jax.Array,
    racing_game_B: jax.Array,
    racing_game_Q: jax.Array,
    racing_game_R: jax.Array,
    sys_param: SystemParam,
    track_width: jax.Array,
    obs_trajs: jax.Array,
    obs_mask: jax.Array,
    agent_half: jax.Array,
    obs_halfs: jax.Array,
    lap_length: jax.Array,
    warm=None,  # None | (z, lam, s) previous primal-dual iterate
    iters: int = 40,
    warm_select=None,  # (use_warm traced bool, (z, lam, s)) runtime config
    iters_warm: int | None = None,
):
    """Racing-game overtake tracker (reference mpc_multi_agents,
    control.py:251-473, with its hardcoded CBF_Flag=True branch: safety
    margin 0.15, alpha 0.6; the non-CBF geometric no-overlap rows at
    control.py:383-445 are dead code in the reference and not rebuilt).
    Targets interpolate the planner trajectory's ey over predicted s
    (control.py:277,373-382).  Returns (u0, U, X, sol).

    ``warm_select=(use_warm, triple)`` with ``iters_warm`` merges the
    episode-first-cold / then-warm protocol into one traced solve (cold:
    warm=None init + the ``iters`` budget; warm: the triple + the
    ``iters_warm`` cap), selected at runtime — per configuration
    bit-identical to two separate calls; used by the fused racing game so
    vmapped fleets don't execute both tracker branches."""
    N = x_targets.shape[0]
    U, X, sol = _cbf_nlp(
        xcurv,
        x_targets,
        racing_game_A,
        racing_game_B,
        racing_game_Q,
        racing_game_R,
        N,
        sys_param,
        track_width,
        obs_trajs,
        obs_mask,
        agent_half,
        obs_halfs,
        lap_length,
        jnp.asarray(0.6, xcurv.dtype),
        0.15,
        warm,
        iters=iters,
        warm_select=warm_select,
        iters_warm=iters_warm,
    )
    return U[0], U, X, sol


@numerics.jit
def mpc_multi_agents_nocbf(
    xcurv: jax.Array,
    x_targets: jax.Array,  # (N, X_DIM) interpolated overtake targets
    A: jax.Array,
    B: jax.Array,
    Q: jax.Array,
    R: jax.Array,
    sys_param: SystemParam,
    track_width: jax.Array,
    agent_half: jax.Array,  # (2,) ego (length/2, width/2)
    left_bound: jax.Array,  # () 1.2 * ey_min of the left neighbor
    left_gate: jax.Array,  # (N,) bool — stage row active (overlap check)
    right_bound: jax.Array,  # () 1.2 * ey_max of the right neighbor
    right_gate: jax.Array,  # (N,) bool
):
    """Racing-game tracker with the reference's NON-CBF geometric
    no-overlap rows (control.py:383-445): per stage,

        ey_k + l/2 sin(epsi_k) + w/2 cos(epsi_k) <= left_bound   (left nbr)
        ey_k - l/2 sin(epsi_k) - w/2 cos(epsi_k) >= right_bound  (right nbr)

    whenever the constant-velocity-predicted ego footprint longitudinally
    overlaps the neighbor (the gates — computed by the caller from
    get_agent_range/ego_agent_overlap_checker, planning/overtake.py:46-63,
    exactly like the reference's Python-side build-time conditionals).
    This branch is DEAD CODE in the reference (CBF_Flag hardcoded True at
    control.py:281) and is provided for constraint-topology parity; the
    trigonometric rows get closed-form Jacobians chained through the
    condensed prediction rows, like the CBF rows do.

    Returns (u0, U, X)."""
    N = x_targets.shape[0]
    dtype = xcurv.dtype
    phi, G = ocp.condense_lti(A, B, N, xcurv)
    n_u = N * U_DIM
    l_half, w_half = agent_half[0], agent_half[1]

    sel_e = jnp.arange(N) * X_DIM + 3  # epsi rows of x_1..x_N
    sel_ey = jnp.arange(N) * X_DIM + 5
    G_e, p_e = G[sel_e], phi[sel_e]
    G_ey, p_ey = G[sel_ey], phi[sel_ey]

    x_t_flat = x_targets.reshape(N * X_DIM)
    Qbar = jnp.kron(jnp.eye(N, dtype=dtype), Q)
    Rbar = jnp.kron(jnp.eye(N, dtype=dtype), R)
    H = 2.0 * (G.T @ Qbar @ G + Rbar) + 1e-9 * jnp.eye(n_u, dtype=dtype)
    g = 2.0 * (G.T @ (Qbar @ (phi - x_t_flat)))

    # linear rows: input box, vx bounds, track width
    sel_vx = jnp.arange(N) * X_DIM
    I_u = jnp.eye(n_u, dtype=dtype)
    u_lo = jnp.tile(jnp.stack([-sys_param.delta_max, -sys_param.a_max]), N)
    u_hi = jnp.tile(jnp.stack([sys_param.delta_max, sys_param.a_max]), N)
    C = jnp.concatenate([I_u, -I_u, -G[sel_vx], G[sel_vx], -G_ey, G_ey], axis=0)
    d = jnp.concatenate(
        [
            u_lo,
            -u_hi,
            phi[sel_vx] - sys_param.v_max,
            sys_param.v_min - phi[sel_vx],
            p_ey - track_width,
            -track_width - p_ey,
        ]
    )

    def c_nl(z):
        e = p_e + G_e @ z  # (N,) epsi_1..epsi_N
        ey = p_ey + G_ey @ z
        se, ce = jnp.sin(e), jnp.cos(e)
        edge = l_half * se + w_half * ce
        c_left = left_bound - (ey + edge)
        c_right = (ey - edge) - right_bound
        vals = jnp.concatenate(
            [
                jnp.where(left_gate, c_left, 1.0),
                jnp.where(right_gate, c_right, 1.0),
            ]
        )
        dedge = (l_half * ce - w_half * se)[:, None] * G_e  # (N, n_u)
        J_left = jnp.where(left_gate[:, None], -(G_ey + dedge), 0.0)
        J_right = jnp.where(right_gate[:, None], G_ey - dedge, 0.0)
        return vals, jnp.concatenate([J_left, J_right], axis=0)

    z0 = jnp.zeros(n_u, dtype)
    sol = ipm.solve_qp_nl(H, g, C, d, c_nl, z0, iters=40)
    U = sol.z.reshape(N, U_DIM)
    X = ocp.unpack_states(phi, G, sol.z, xcurv)
    return U[0], U, X


def _stage_shift(a: jax.Array, axis: int = 0) -> jax.Array:
    """Shift one stage forward along ``axis``, repeating the final stage."""
    n = a.shape[axis]
    idx = jnp.concatenate([jnp.arange(1, n), jnp.array([n - 1])])
    return jnp.take(a, idx, axis=axis)


@partial(numerics.jit, static_argnames=("N", "n_obs"))
def shift_cbf_warm(sol: ipm.IPMSolution, N: int, n_obs: int):
    """Shift a CBF-problem primal-DUAL iterate one control period forward
    (repeat the last stage) — the warm start for the next step's solve,
    matching the reference's warm-start-from-previous-solution at
    control.py:702-707.

    Primal z = [U (N*U_DIM); slack (n_obs*(N+1))].  The multipliers and
    slacks follow _cbf_nlp's inequality row layout: u-box lo/hi
    (2 x N x U_DIM), vx lo/hi + ey lo/hi (4 x N), slack>=0 (n_obs x (N+1)),
    CBF (n_obs x N).  Shifting the duals too is what makes warm starting
    work: a lam re-init (0.1/s) sits ~5 orders of magnitude below the
    1e4-scale slack-penalty multipliers and the solve stalls (measured;
    see ipm.solve_qp_nl)."""
    n_u = N * U_DIM

    def shift_all(vec):
        parts = []
        o = 0
        for shape, axis in (
            ((N, U_DIM), 0),  # u lower
            ((N, U_DIM), 0),  # u upper
            ((N,), 0),  # vx upper
            ((N,), 0),  # vx lower
            ((N,), 0),  # ey upper
            ((N,), 0),  # ey lower
            ((n_obs, N + 1), 1),  # slack >= 0
            ((n_obs, N), 1),  # CBF rows
        ):
            sz = 1
            for dim in shape:
                sz *= dim
            parts.append(_stage_shift(vec[o : o + sz].reshape(shape), axis).reshape(-1))
            o += sz
        return jnp.concatenate(parts)

    u_shift = _stage_shift(sol.z[:n_u].reshape(N, U_DIM)).reshape(-1)
    sl_shift = _stage_shift(sol.z[n_u:].reshape(n_obs, N + 1), axis=1).reshape(-1)
    z = jnp.concatenate([u_shift, sl_shift])
    return (z, shift_all(sol.lam), shift_all(sol.s))


# ---------------------------------------------------------------------------
# LMPC (control.py:610-730)
# ---------------------------------------------------------------------------


@partial(numerics.jit, static_argnames=("num_horizon",))
def lmpc(
    xcurv: jax.Array,
    param: LMPCParam,
    A_seq: jax.Array,  # (N, X, X) TV linearization
    B_seq: jax.Array,  # (N, X, U)
    C_seq: jax.Array,  # (N, X)
    ss_points: jax.Array,  # (X_DIM, K) selected safe-set points
    Qfun_points: jax.Array,  # (K,) their cost-to-go
    u_prev: jax.Array,  # (U_DIM,) previous applied input
    sys_param: SystemParam,
    lap_length: jax.Array,
    lap_width: jax.Array,
    z_warm: jax.Array | None = None,
    num_horizon: int = 12,
):
    """LMPC step: QP with convex-safe-set terminal constraint.

    Decision z = [U (N*U_DIM); lambda (K)].  Terminal equality
    x_N = SS @ lambda, 1'lambda = 1, lambda >= 0; cost = input + input-rate +
    Qfun . lambda (the reference's slack is constrained to zero at
    control.py:693-694, so it is omitted).  Returns (u_pred (N,U), x_pred
    (N+1,X), converged flag).
    """
    N = num_horizon
    K = Qfun_points.shape[0]
    dtype = xcurv.dtype
    phi, G = ocp.condense(A_seq, B_seq, C_seq, xcurv)
    n_u = N * U_DIM
    n_z = n_u + K

    x_track = jnp.array([5.0, 0, 0, 0, 0, 0], dtype)
    x_targets = jnp.broadcast_to(x_track, (N, X_DIM))
    H_u, g_u = ocp.quadratic_tracking_cost(phi, G, param.Q, param.R, x_targets, N)
    H_dr, g_dr = ocp.input_rate_cost(param.dR, N, u_prev)
    H = jnp.zeros((n_z, n_z), dtype)
    H = H.at[:n_u, :n_u].set(H_u + H_dr)
    g = jnp.zeros(n_z, dtype).at[:n_u].set(g_u + g_dr)
    g = g.at[n_u:].set(Qfun_points)

    # terminal equality: x_N(U) - SS lambda = 0 ; sum lambda = 1
    GN = G[-X_DIM:]  # rows of x_N
    phiN = phi[-X_DIM:]
    E = jnp.zeros((X_DIM + 1, n_z), dtype)
    E = E.at[:X_DIM, :n_u].set(GN)
    E = E.at[:X_DIM, n_u:].set(-ss_points)
    E = E.at[X_DIM, n_u:].set(1.0)
    e = jnp.concatenate([-phiN, jnp.ones(1, dtype)])

    # inequalities: u box; vx <= vmax, |ey| <= width for k=1..N-1 (the
    # reference constrains stages 0..N-1, control.py:652-666 — stage 0 is
    # fixed, stage N is in the safe-set hull); lambda >= 0
    u_min = jnp.stack([-sys_param.delta_max, -sys_param.a_max])
    u_max = jnp.stack([sys_param.delta_max, sys_param.a_max])
    C_u, d_u = ocp.input_box_rows(N, U_DIM, u_min, u_max, n_z)
    sel = jnp.arange(N - 1) * X_DIM  # x_1..x_{N-1}
    G_vx = jnp.zeros((N - 1, n_z), dtype).at[:, :n_u].set(G[sel + 0])
    G_ey = jnp.zeros((N - 1, n_z), dtype).at[:, :n_u].set(G[sel + 5])
    p_vx = phi[sel + 0]
    p_ey = phi[sel + 5]
    C_lam = jnp.zeros((K, n_z), dtype).at[:, n_u:].set(jnp.eye(K, dtype=dtype))
    C = jnp.concatenate([C_u, -G_vx, G_ey, -G_ey, C_lam], axis=0)
    d = jnp.concatenate(
        [
            d_u,
            p_vx - sys_param.v_max,
            -lap_width - p_ey,
            p_ey - lap_width,
            jnp.zeros(K, dtype),
        ]
    )

    qp = ipm.QP(H=H, g=g, C=C, d=d, E=E, e=e)
    z0 = (
        z_warm
        if z_warm is not None
        else jnp.zeros(n_z, dtype).at[n_u:].set(1.0 / K)
    )
    sol = ipm.solve_qp(qp, z0, iters=40)
    U = sol.z[:n_u].reshape(N, U_DIM)
    X = ocp.unpack_states(phi, G, sol.z[:n_u], xcurv)
    return U, X, sol
