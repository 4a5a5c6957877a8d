"""Cubic Bezier reference curves for overtake corridors.

Rebuild of the reference's Bezier machinery (car_racing/planning/
planner_helper.py:28-153) as array ops: control-point construction is
vectorized over corridors, curve evaluation over sample points — both
jittable, so the whole corridor batch is produced on-device.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..utils import numerics


@numerics.jit
def bezier_curve(control_points: jax.Array, t: jax.Array) -> jax.Array:
    """Evaluate a cubic Bezier at parameters t.

    control_points: (4, 2) rows (s, ey); t: (T,).  Returns (T, 2).
    (reference get_bezier_curve, planner_helper.py:138-153)
    """
    c0, c1, c2, c3 = control_points
    t = t[:, None]
    return (
        c0 * (1 - t) ** 3
        + 3 * c1 * t * (1 - t) ** 2
        + 3 * c2 * t**2 * (1 - t)
        + c3 * t**3
    )


def interp_ey(bezier_samples: jax.Array, s_query: jax.Array) -> jax.Array:
    """Linear interpolation ey(s) over sampled (s, ey) rows, clipping the
    query into the sampled range (the reference uses scipy interp1d after
    np.clip; jnp.interp already clamps at the ends)."""
    return jnp.interp(s_query, bezier_samples[:, 0], bezier_samples[:, 1])


def corridor_control_points(
    num_veh: int,
    xcurv_ego: jax.Array,
    veh_info: jax.Array,  # (num_veh, 3): [s, max ey over pred, min ey over pred]
    max_delta_v: jax.Array,
    lap_length: jax.Array,
    track_width: jax.Array,
    veh_width: jax.Array,
    optimal_traj_xcurv: jax.Array,  # (T, X_DIM) stored raceline
    prediction_factor: jax.Array,
    num_active=None,
):
    """Control points for the num_veh+1 passing corridors
    (reference get_bezier_control_points, planner_helper.py:28-135).

    Corridor 0 passes left of every vehicle, corridor i (0<i<num_veh)
    between vehicles i-1 and i (sorted by ey descending), corridor num_veh
    right of all.  Lap-wrap of the end point is handled exactly as the
    reference: when s3 < s0, s3 += lap_length and s1/s2 interpolate across
    the start line.  Returns (num_veh+1, 4, 2).

    ``num_active`` (optional, may be a TRACED scalar) restricts the
    corridor problem to the first ``num_active`` rows of ``veh_info`` —
    the vehicles-of-interest subset, compacted to the front in ey-
    descending order (overtake_traj_planner.py:70-92 builds corridors
    only around the interest set).  Shapes stay static at num_veh+1
    corridors; rows with index > num_active are finite garbage the
    caller must mask out of branch selection.  Defaults to num_veh
    (every row active — the host planner path, which sizes the arrays
    to the interest set before calling).
    """
    dtype = xcurv_ego.dtype
    n_cor = num_veh + 1
    if num_active is None:
        num_active = num_veh
    num_active = jnp.asarray(num_active)
    opt_s = optimal_traj_xcurv[:, 4]
    opt_ey = optimal_traj_xcurv[:, 5]

    def opt_ey_at(s):
        # below the stored range -> first stored value (planner_helper.py:91-94)
        s_w = jnp.where(s < 0, s + lap_length, s)
        return jnp.where(
            s_w <= opt_s[0], opt_ey[0], jnp.interp(s_w, opt_s, opt_ey)
        )

    s0 = jnp.full((n_cor,), xcurv_ego[4], dtype)
    s3 = s0 + prediction_factor * max_delta_v + 4.0
    wraps = s0 > s3  # reference's "s3 ahead of start line" branch is s0>s3
    span = jnp.where(wraps, s3 + lap_length - s0, s3 - s0)
    s1 = s0 + span / 3.0
    s2 = s0 + 2.0 * span / 3.0
    s3 = jnp.where(wraps, s3 + lap_length, s3)

    ey0 = jnp.full((n_cor,), xcurv_ego[5], dtype)

    idx = jnp.arange(n_cor)
    # mid control ey per corridor (planner_helper.py:98-119); the bottom
    # vehicle is row num_active-1 (the last ACTIVE row) — a traced index
    # when the caller passes a runtime interest count
    ey_top = 0.8 * track_width - (-veh_info[0, 1] - 0.5 * veh_width) * 0.2
    ey_bot = -0.8 * track_width + (
        jnp.take(veh_info[:, 1], num_active - 1) - 0.5 * veh_width
    ) * 0.2
    below = jnp.clip(idx, 0, num_active - 1)  # vehicle below corridor idx
    above = jnp.clip(idx - 1, 0, num_active - 1)  # vehicle above corridor idx
    ey_mid_between = 0.7 * (jnp.take(veh_info[:, 1], below) + 0.5 * veh_width) + 0.3 * (
        jnp.take(veh_info[:, 1], above) - 0.5 * veh_width
    )
    ey_mid = jnp.where(
        idx == 0, ey_top, jnp.where(idx == num_active, ey_bot, ey_mid_between)
    )

    # terminal ey from the stored raceline, wrapped (planner_helper.py:121-134)
    s3_w = jnp.where(s3 >= lap_length, s3 - lap_length, s3)
    ey3 = jax.vmap(opt_ey_at)(s3_w)

    cp = jnp.stack(
        [
            jnp.stack([s0, ey0], axis=-1),
            jnp.stack([s1, ey_mid], axis=-1),
            jnp.stack([s2, ey_mid], axis=-1),
            jnp.stack([s3, ey3], axis=-1),
        ],
        axis=1,
    )  # (n_cor, 4, 2)
    return cp


def sample_corridors(control_points: jax.Array, num_samples: int) -> jax.Array:
    """Sample each corridor's Bezier at num_samples uniform parameters.
    Returns (n_cor, num_samples, 2)."""
    t = jnp.linspace(0.0, 1.0, num_samples, dtype=control_points.dtype)
    return jax.vmap(lambda cp: bezier_curve(cp, t))(control_points)
