"""The complete LMPC learning protocol from a standing start, on-device.

The reference's ``lmpc_test.py`` protocol (lmpc_test.py:58-139) is: drive a
PID lap and an MPC-LTI lap to seed the safe set, promote both via
``add_trajectory``, then run LMPC learning laps.  The host runs this as
hundreds of per-step Python->solver round-trips; here each stage is ONE
fused on-device rollout —

  PID seed lap  ->  MPC-LTI seed lap  ->  rollout_lmpc_learning(n_laps)

— with the only host work being the numpy lap-cut + column construction
between stages (exactly the host ``add_trajectory`` semantics pinned by
tests/test_fused.py::test_fused_lmpc_learning_matches_host_protocol).

``run_learning_protocol`` is the zero-to-learned-raceline story: from a
zero state it returns the full learning curve (lap step counts per
iteration, PID seed first) plus the final trajectories.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..models import controllers
from ..ops import dynamics, track as track_ops
from ..utils import numerics
from ..utils.constants import U_DIM, X_DIM
from ..utils.params import LMPCParam, MPCParam, SystemParam
from . import fused

SENTINEL = 1e4


@partial(numerics.jit, static_argnames=("n_steps", "control_dt", "sub_dt"))
def rollout_pid(
    track: track_ops.Track,
    bike_params: dynamics.BicycleParams,
    xtarget: jax.Array,
    xcurv0: jax.Array,
    xglob0: jax.Array,
    n_steps: int = 400,
    control_dt: float = 0.1,
    sub_dt: float = 0.001,
):
    """Closed-loop PID tracking in one scan (reference control.py:15-25
    inside the offboard loop).  Returns (xcurv_traj, u_traj)."""

    def step(carry, _):
        xcurv, xglob = carry
        u = controllers.pid(xcurv, xtarget)
        xglob_next, xcurv_next = dynamics.propagate(
            track, bike_params, xglob, xcurv, u, control_dt=control_dt, sub_dt=sub_dt
        )
        return (xcurv_next, xglob_next), (xcurv, u)

    (xcurv_T, _), (xcurvs, us) = jax.lax.scan(step, (xcurv0, xglob0), None, length=n_steps)
    return jnp.concatenate([xcurvs, xcurv_T[None]], axis=0), us


def cut_first_lap(xc: np.ndarray, us: np.ndarray, lap_length: float):
    """Cut the first completed lap out of a rollout trajectory.

    Returns (lap_xc (T+1, X) with the crossing row un-wrapped, lap_u (T, U),
    T, wrapped crossing state) — the wrapped state seeds the next stage.
    """
    xc = np.asarray(xc)
    us = np.asarray(us)
    crossed = np.nonzero(xc[:, 4] >= lap_length)[0]
    if len(crossed) == 0:
        raise RuntimeError("rollout never completed a lap; raise n_steps")
    T = int(crossed[0])  # first row with s >= L == end_iter steps
    x_wrapped = np.array(xc[T], copy=True)
    x_wrapped[4] -= lap_length
    return xc[: T + 1], us[:T], T, x_wrapped


def lap_column_from_traj(lap_xc: np.ndarray, lap_u: np.ndarray, P: int):
    """Build a safe-set column from a cut lap with host ``add_trajectory``
    semantics (racing/policies.py:407-433): rows 0..T-1 = in-lap states,
    row T = the crossing state with s un-wrapped; u rows 0..T-1;
    Qfun = (T-1) - arange(P) (the backfill loop's value everywhere,
    including the crossing row's -1 quirk)."""
    T = len(lap_xc) - 1
    ss = np.full((P, X_DIM), SENTINEL)
    uu = np.full((P, U_DIM), SENTINEL)
    ss[: T + 1] = lap_xc
    uu[:T] = lap_u
    q = (T - 1) - np.arange(P, dtype=float)
    return ss, uu, q


def run_learning_protocol(
    track: track_ops.Track,
    bike_params: dynamics.BicycleParams | None = None,
    lmpc_param: LMPCParam | None = None,
    mpc_param: MPCParam | None = None,
    sys_param: SystemParam | None = None,
    n_laps: int = 3,
    seed_vt: float = 0.7,
    P: int | None = None,
    n_steps_seed: int | None = None,
    n_steps_learn: int | None = None,
):
    """Zero state -> PID lap -> MPC lap -> n_laps of fused LMPC learning.

    ``P`` (safe-set column rows), ``n_steps_seed`` and ``n_steps_learn``
    auto-size from the track length / measured seed laps when omitted, so
    the protocol runs unmodified on all four layouts (l_shape 19.2 m
    through m_shape 49.8 m).

    Returns a dict with the learning curve ``lap_steps`` ([PID, MPC,
    lmpc_1..n]), the learning rollout's trajectory/inputs, and the final
    safe-set columns (checkpointable via utils/checkpoint.py).
    """
    bike_params = bike_params or dynamics.BicycleParams.default()
    lmpc_param = lmpc_param or LMPCParam.default()
    mpc_param = mpc_param or MPCParam.default(vt=seed_vt)
    sys_param = sys_param or SystemParam.default()
    L = float(track.lap_length)
    N = lmpc_param.num_horizon
    xtarget = jnp.asarray([seed_vt, 0, 0, 0, 0, 0.0])
    # 1.8x the steady-state lap at seed_vt covers the standing-start ramp
    # (is-None checks: an explicit 0 must error downstream, not silently
    # fall back to the auto-sized default)
    if n_steps_seed is None:
        n_steps_seed = int(L / seed_vt / 0.1 * 1.8)

    # stage 1: PID seed lap (reference lap 0)
    xc, us = rollout_pid(
        track, bike_params, xtarget, jnp.zeros(X_DIM), jnp.zeros(X_DIM),
        n_steps=n_steps_seed,
    )
    lap_xc0, lap_u0, t0, x_w = cut_first_lap(xc, us, L)

    # stage 2: MPC-LTI seed lap (reference lap 1), continuing from the wrap
    xg_w = np.asarray(track_ops.frenet_to_global_state(track, jnp.asarray(x_w)))
    xc, us = fused.rollout_mpc_tracking(
        track, bike_params, mpc_param, sys_param, xtarget,
        jnp.asarray(x_w), jnp.asarray(xg_w), n_steps=n_steps_seed,
    )
    lap_xc1, lap_u1, t1, x_w = cut_first_lap(xc, us, L)

    # column rows: lap iter-1's column must also hold the next lap's
    # add_point appendix (rows t1+1 .. t1+T_next, T_next <= t1)
    if P is None:
        P = 2 * max(t0, t1) + N + 3
    # the promotion indices inside rollout_lmpc_learning clip to P-1; an
    # undersized P would silently overwrite the last row and corrupt the
    # learned safe set, so enforce the capacity requirement here
    assert P >= t1 + max(t0, t1) + 2, (
        f"safe-set column capacity P={P} cannot hold the appendix of a lap "
        f"up to {max(t0, t1)} steps after the {t1}-step seed lap "
        "(need P >= t_prev + lap_steps + 1)"
    )
    ss0, u0, q0 = lap_column_from_traj(lap_xc0, lap_u0, P)
    ss1, u1, q1 = lap_column_from_traj(lap_xc1, lap_u1, P)
    if n_steps_learn is None:
        n_steps_learn = n_laps * t1 + 10

    # stage 3: the fused multi-lap learning rollout (laps 2..)
    # lin seed = host add_trajectory's iter==0 branch (policies.py:428-431)
    lin_points0 = jnp.asarray(ss0[1 : N + 2])
    lin_input0 = jnp.asarray(u0[1 : N + 1])
    xg_w = np.asarray(track_ops.frenet_to_global_state(track, jnp.asarray(x_w)))
    xc, us, lap_steps, laps_done = fused.rollout_lmpc_learning(
        track, bike_params, lmpc_param, sys_param,
        jnp.asarray(x_w), jnp.asarray(xg_w),
        jnp.asarray(ss1), jnp.asarray(q1), jnp.asarray(u1), jnp.asarray(t1, jnp.int32),
        jnp.asarray(ss0), jnp.asarray(q0), jnp.asarray(u0), jnp.asarray(t0, jnp.int32),
        lin_points0, lin_input0, n_laps=n_laps, n_steps=n_steps_learn,
    )
    if int(laps_done) < n_laps:
        raise RuntimeError(
            f"learning rollout finished only {int(laps_done)}/{n_laps} laps; "
            "raise n_steps_learn"
        )
    return {
        "lap_steps": [t0, t1] + [int(v) for v in np.asarray(lap_steps)],
        "xcurv": np.asarray(xc),
        "u": np.asarray(us),
        "seed_columns": {"ss0": ss0, "q0": q0, "ss1": ss1, "q1": q1},
    }


def export_learned_raceline(out: dict, track, layout: str, data_dir: str = "data"):
    """Export the fastest learned lap of a ``run_learning_protocol`` result
    as optimal-trajectory CSVs, the reference's save-trajectory format
    (lmpc_test.py:166-178; host analog: utils/checkpoint.export_raceline).

    Returns the (protocol-wide) iteration index of the exported lap."""
    import os

    lap_steps = out["lap_steps"]
    learned = lap_steps[2:]
    best = int(np.argmin(learned))
    off = int(np.sum(learned[:best], dtype=int))
    T = learned[best]
    xc = out["xcurv"]
    L = float(track.lap_length)
    # lap rows off..off+T-1 (wrapped states) + the crossing row un-wrapped
    # (the learning rollout's carry wraps s at the boundary)
    lap = np.array(xc[off : off + T + 1], copy=True)
    lap[T, 4] += L
    xg = np.stack(
        [np.asarray(track_ops.frenet_to_global_state(track, jnp.asarray(row)))
         for row in lap]
    )
    os.makedirs(f"{data_dir}/optimal_traj", exist_ok=True)
    np.savetxt(f"{data_dir}/optimal_traj/xcurv_{layout}_learned.csv", lap, delimiter=",")
    np.savetxt(f"{data_dir}/optimal_traj/xglob_{layout}_learned.csv", xg, delimiter=",")
    return 2 + best
