"""LMPC learning ops: cost-to-go, safe-set selection, local regression.

Accelerator-first rebuild of the reference's lmpc_helper (car_racing/control/
lmpc_helper.py):

- :func:`compute_cost`    (lmpc_helper.py:11-23)  — reverse lax.scan DP.
- :func:`select_points`   (lmpc_helper.py:267-282) — fixed-size dynamic-slice
  window around the nearest safe-set point.  (The reference's else-branch
  has a latent NameError, lmpc_helper.py:280-281; we clamp the window start
  to 0 instead.)
- :func:`local_regression` (lmpc_helper.py:26-264,343-366) — the
  Epanechnikov-kernel-weighted local linear fit.  The reference solves an
  *unconstrained* cvxopt QP per output channel (lmpc_helper.py:358-366);
  that QP is just a linear system, solved here in closed form and vmapped
  over the horizon — replacing both cvxopt and the serial per-stage Python
  loop (base.py:603, whose pathos Pool at base.py:443 was never used).
- Frenet rows 3..5 come from autodiff of the kinematic update instead of the
  hand-derived lines at lmpc_helper.py:149-187 (fixing the ``den * 2`` vs
  ``den ** 2`` typo at lmpc_helper.py:172 for free).

Safe-set storage mirrors the reference's preallocated sentinel arrays
(base.py:430-439): ss_xcurv (P, X, laps) filled with 1e4, u_ss likewise,
Qfun (P, laps) zero-filled then backfilled.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..utils import numerics
from ..utils.constants import U_DIM, X_DIM

SENTINEL = 1e4


@numerics.jit
def compute_cost(xcurv: jax.Array, lap_length: jax.Array) -> jax.Array:
    """Backward-DP cost-to-go: steps remaining until s crosses lap_length
    (lmpc_helper.py:11-23).  xcurv: (T, X_DIM). Returns (T,)."""

    def body(carry, x):
        nxt = carry
        cost = jnp.where(x[4] < lap_length, nxt + 1.0, 0.0)
        return cost, cost

    T = xcurv.shape[0]
    # last point has cost 0
    _, costs = jax.lax.scan(body, -1.0, xcurv[:-1], reverse=True)
    return jnp.concatenate([costs, jnp.zeros(1, xcurv.dtype)])


def compute_cost_host(xcurv, lap_length) -> "np.ndarray":
    """Numpy :func:`compute_cost` for the host lap-close path.

    Lap lengths vary per lap, so the traced version recompiles at every
    ``add_trajectory`` — a latency spike inside the realtime controller's
    lap-boundary tick.  The host loop calls this shape-proof variant
    instead; equivalence is pinned in tests/test_lmpc_learning.py."""
    import numpy as np

    xcurv = np.asarray(xcurv)
    T = xcurv.shape[0]
    costs = np.zeros(T)
    nxt = -1.0
    for k in range(T - 2, -1, -1):
        nxt = nxt + 1.0 if xcurv[k, 4] < lap_length else 0.0
        costs[k] = nxt
    return costs


@partial(numerics.jit, static_argnames=("num_points",))
def select_points(
    ss_iter: jax.Array,  # (P, X_DIM) safe set of one iteration (sentinel-padded)
    qfun_iter: jax.Array,  # (P,)
    xcurv: jax.Array,  # (X_DIM,)
    num_points: int,
    shift: int = 0,
):
    """Window of ``num_points`` safe-set points ahead of the nearest point to
    xcurv (1-norm, lmpc_helper.py:267-282). Returns (points (X_DIM, num), q)."""
    norm = jnp.sum(jnp.abs(ss_iter - xcurv), axis=1)
    start = jnp.argmin(norm) + shift
    start = jnp.clip(start, 0, ss_iter.shape[0] - num_points)
    pts = jax.lax.dynamic_slice(ss_iter, (start, 0), (num_points, X_DIM))
    q = jax.lax.dynamic_slice(qfun_iter, (start,), (num_points,))
    return pts.T, q


# ---------------------------------------------------------------------------
# local linear regression (estimate_ABC)
# ---------------------------------------------------------------------------

_H_KERNEL = 5.0
_STATE_FEATURES = jnp.array([0, 1, 2])
_SCALING = jnp.diag(jnp.array([0.1, 1.0, 1.0, 1.0, 1.0]))


def _kernel_weights(data_zu: jax.Array, valid: jax.Array, x_lin: jax.Array, max_pts: int):
    """Select up to max_pts nearest (scaled l1) points and their Epanechnikov
    weights (lmpc_helper.py:192-226). data_zu: (P, 5) rows [vx,vy,wz,u0,u1].
    Returns (idx (max_pts,), w (max_pts,)) with w=0 for masked entries."""
    diff = (data_zu - x_lin) @ _SCALING.astype(data_zu.dtype)
    norm = jnp.sum(jnp.abs(diff), axis=1)
    norm = jnp.where(valid, norm, jnp.inf)
    # top_k instead of argsort: a full bitonic sort over all P rows per
    # stage was the dominant cost of estimate_ABC; top_k returns the
    # same max_pts nearest points (tie ORDER may differ — weights are equal
    # on ties, so the fit is unchanged)
    neg_norm, idx = jax.lax.top_k(-norm, max_pts)
    sel_norm = -neg_norm
    w = jnp.where(sel_norm < _H_KERNEL, (1.0 - (sel_norm / _H_KERNEL) ** 2) * 0.75, 0.0)
    w = jnp.where(jnp.isfinite(sel_norm), w, 0.0)
    return idx, w


def _weighted_fit(Z: jax.Array, w: jax.Array, y: jax.Array):
    """argmin_beta sum_i w_i (Z_i . beta - y_i)^2 via normal equations —
    the closed form of the reference's unconstrained cvxopt QP.

    The ridge is *relative* to the Gram matrix's scale and dtype-aware:
    on steady-state lap segments the nearest-neighbor rows are nearly
    identical, so the Gram matrix is numerically rank-1 — a fixed 1e-9
    ridge sits below f32 resolution at that scale and the solve NaNs
    (observed in the fused f32 LMPC lap at corner-entry stages)."""
    M = jnp.concatenate([Z, jnp.ones((Z.shape[0], 1), Z.dtype)], axis=1)
    Q = (M.T * w) @ M
    eps = 1e-10 if Z.dtype == jnp.float64 else 2e-5
    scale = jnp.trace(Q) / Q.shape[0] + 1.0
    Q = Q + (eps * scale) * jnp.eye(M.shape[1], dtype=Z.dtype)
    b = (M.T * w) @ y
    return jnp.linalg.solve(Q, b)


def _kinematic_rows(curv, xcurv, dt):
    """Rows 3..5 of (A, C): exact Jacobian of the Frenet kinematic update at
    frozen curvature (autodiff replacement of lmpc_helper.py:149-187)."""

    def kin(x):
        vx, vy, wz, epsi, s, ey = x
        den = 1.0 - curv * ey
        s_dot = (vx * jnp.cos(epsi) - vy * jnp.sin(epsi)) / den
        return jnp.array(
            [
                epsi + dt * (wz - s_dot * curv),
                s + dt * s_dot,
                ey + dt * (vx * jnp.sin(epsi) + vy * jnp.cos(epsi)),
            ]
        )

    A_rows = jax.jacfwd(kin)(xcurv)
    C_rows = kin(xcurv) - A_rows @ xcurv
    return A_rows, C_rows


@partial(numerics.jit, static_argnames=("max_pts",))
def regression_and_linearization(
    x_lin_state: jax.Array,  # (X_DIM,) linearization state (lin_points[i])
    u_lin: jax.Array,  # (U_DIM,) linearization input
    ss_data: jax.Array,  # (L, P, X_DIM) safe-set states of the laps used
    u_data: jax.Array,  # (L, P, U_DIM) inputs of the laps used
    valid: jax.Array,  # (L, P) bool — rows with a successor sample
    curv: jax.Array,  # () curvature at x_lin_state
    dt: jax.Array,
    max_pts: int = 40,
):
    """One-stage (A_i, B_i, C_i) estimate (lmpc_helper.py:26-189).

    Rows 0..2 (vx, vy, wz) are kernel-weighted local least squares on the
    lap data; rows 3..5 are the exact kinematic Jacobian.  The reference
    loops laps and stages in Python and calls cvxopt per channel; here lap
    data is stacked and the three channel fits are closed-form solves (the
    caller vmaps this over the horizon).
    """
    dtype = x_lin_state.dtype
    L, P, _ = ss_data.shape
    x_lin = jnp.concatenate([x_lin_state[:3], u_lin])

    flat_states = ss_data.reshape(L * P, X_DIM)
    flat_u = u_data.reshape(L * P, U_DIM)
    flat_valid = valid.reshape(L * P)
    data_zu = jnp.concatenate([flat_states[:, :3], flat_u], axis=1)

    idx, w = _kernel_weights(data_zu, flat_valid, x_lin, max_pts)
    # successor states y = x_{k+1}; the flat layout keeps lap-local order so
    # idx+1 within a lap is the successor; validity already excludes lap ends
    succ = jnp.clip(idx + 1, 0, L * P - 1)

    A = jnp.zeros((X_DIM, X_DIM), dtype)
    B = jnp.zeros((X_DIM, U_DIM), dtype)
    C = jnp.zeros((X_DIM,), dtype)

    # vx channel: features [vx,vy,wz, a]
    Z_vx = jnp.concatenate(
        [flat_states[idx][:, :3], flat_u[idx][:, 1:2]], axis=1
    )
    beta = _weighted_fit(Z_vx, w, flat_states[succ][:, 0])
    A = A.at[0, :3].set(beta[:3])
    B = B.at[0, 1].set(beta[3])
    C = C.at[0].set(beta[4])

    # vy, wz channels: features [vx,vy,wz, delta]
    Z_lat = jnp.concatenate(
        [flat_states[idx][:, :3], flat_u[idx][:, 0:1]], axis=1
    )
    for row in (1, 2):
        beta = _weighted_fit(Z_lat, w, flat_states[succ][:, row])
        A = A.at[row, :3].set(beta[:3])
        B = B.at[row, 0].set(beta[3])
        C = C.at[row].set(beta[4])

    A_kin, C_kin = _kinematic_rows(curv, x_lin_state, dt)
    A = A.at[3:6, :].set(A_kin)
    C = C.at[3:6].set(C_kin)
    return A, B, C


def estimate_abc_horizon(
    lin_points: jax.Array,  # (N, X_DIM)
    lin_inputs: jax.Array,  # (N, U_DIM)
    ss_data: jax.Array,  # (L, P, X_DIM)
    u_data: jax.Array,  # (L, P, U_DIM)
    valid: jax.Array,  # (L, P)
    curvs: jax.Array,  # (N,) curvature at each linearization point
    dt: jax.Array,
    max_pts: int = 40,
):
    """vmap of :func:`regression_and_linearization` over the horizon —
    replaces the serial loop at base.py:603-621."""
    fn = lambda x, u, c: regression_and_linearization(
        x, u, ss_data, u_data, valid, c, dt, max_pts=max_pts
    )
    return jax.vmap(fn)(lin_points, lin_inputs, curvs)
