"""Closed-track geometry as pure, jittable array ops.

Re-design of the reference's track layer (car_racing/utils/racing_env.py):
the reference walks Python ``while`` loops and data-dependent ``if`` branches
per query (racing_env.py:6-246); here the track is a pytree of per-segment
arrays and every query (curvature, Frenet<->global) is a masked, vectorized
computation over all segments — static shapes, no data-dependent control
flow, so everything jits, vmaps and differentiates.

Track representation. A track spec is rows of ``[segment_length, radius]``
(radius 0 => straight; signed radius => arc, positive = left turn), identical
to the reference's ``data/track_layout/*.csv``. ``build_track`` precomputes,
per segment: start/end points, start tangent, cumulative arc length, length,
signed curvature and (for arcs) the circle center — the same quantities the
reference stores in ``point_and_tangent`` rows (racing_env.py:341-457), laid
out as struct-of-arrays.

Conventions: curvilinear position ``(s, ey)`` with ``ey > 0`` to the left of
the centerline tangent; ``epsi`` the heading error versus the tangent.

Note on arc tangents: the reference's ``get_orientation`` (racing_env.py:125)
returns ``theta + pi/2`` for every arc, which is wrong by pi for right-hand
arcs (direction = -1); it goes unnoticed upstream because the consumers draw
rectangles, which are invariant under a pi rotation.  We implement the correct
tangent ``theta + direction * pi/2``.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from ..utils import numerics

_S_TOL = 1e-3  # segment-membership tolerance, matches racing_env.py:12


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class Track:
    """Closed track as struct-of-arrays over segments (pytree)."""

    start_xy: jax.Array  # (n_seg, 2) segment start point
    end_xy: jax.Array  # (n_seg, 2) segment end point
    psi_start: jax.Array  # (n_seg,) tangent angle at segment start
    s0: jax.Array  # (n_seg,) cumulative arc length at segment start
    seg_len: jax.Array  # (n_seg,) segment length
    curv: jax.Array  # (n_seg,) signed curvature (0 => straight)
    center_xy: jax.Array  # (n_seg, 2) arc center (unused for straights)
    lap_length: jax.Array  # () total lap length
    width: jax.Array  # () track half-width bound on |ey|

    @property
    def num_segments(self) -> int:
        return self.start_xy.shape[0]


def build_track(spec: np.ndarray, width: float = 0.8) -> Track:
    """Build a :class:`Track` from ``[length, radius]`` spec rows.

    Mirrors the construction walk of the reference (racing_env.py:329-457):
    segments are chained head-to-tail starting at the origin with tangent 0,
    and a final straight segment closes the loop back to the origin.
    """
    spec = np.asarray(spec, dtype=np.float64)
    n = spec.shape[0]
    start_xy = np.zeros((n + 1, 2))
    end_xy = np.zeros((n + 1, 2))
    psi_start = np.zeros(n + 1)
    s0 = np.zeros(n + 1)
    seg_len = np.zeros(n + 1)
    curv = np.zeros(n + 1)
    center_xy = np.zeros((n + 1, 2))

    pos = np.zeros(2)
    ang = 0.0
    s_cum = 0.0
    for i in range(n):
        length, radius = spec[i]
        start_xy[i] = pos
        psi_start[i] = ang
        s0[i] = s_cum
        seg_len[i] = length
        if radius == 0.0:
            end_xy[i] = pos + length * np.array([np.cos(ang), np.sin(ang)])
            curv[i] = 0.0
            pos = end_xy[i]
        else:
            direction = 1.0 if radius >= 0 else -1.0
            R = abs(radius)
            center = pos + R * np.array(
                [np.cos(ang + direction * np.pi / 2), np.sin(ang + direction * np.pi / 2)]
            )
            center_xy[i] = center
            span = length / R
            theta0 = np.arctan2(pos[1] - center[1], pos[0] - center[0])
            theta1 = theta0 + direction * span
            end_xy[i] = center + R * np.array([np.cos(theta1), np.sin(theta1)])
            curv[i] = 1.0 / radius
            ang = _wrap(ang + direction * span)
            pos = end_xy[i]
        s_cum += length
    # closing straight segment back to the origin (racing_env.py:434-454)
    start_xy[n] = pos
    end_xy[n] = np.zeros(2)
    psi_start[n] = ang
    s0[n] = s_cum
    seg_len[n] = float(np.hypot(*pos))
    curv[n] = 0.0
    s_cum += seg_len[n]

    f = lambda a: jnp.asarray(a, dtype=jnp.float64 if jax.config.jax_enable_x64 else jnp.float32)
    return Track(
        start_xy=f(start_xy),
        end_xy=f(end_xy),
        psi_start=f(psi_start),
        s0=f(s0),
        seg_len=f(seg_len),
        curv=f(curv),
        center_xy=f(center_xy),
        lap_length=f(s_cum),
        width=f(width),
    )


def load_track(layout: str, width: float = 0.8, data_dir: str = "data") -> Track:
    """Load one of the stock layouts (l_shape, m_shape, goggle, ellipse)."""
    spec = np.genfromtxt(f"{data_dir}/track_layout/{layout}.csv", delimiter=",")
    return build_track(spec, width)


def _wrap(angle):
    """Wrap angle to (-pi, pi]."""
    return np.arctan2(np.sin(angle), np.cos(angle))


def wrap_angle(angle: jax.Array) -> jax.Array:
    return jnp.arctan2(jnp.sin(angle), jnp.cos(angle))


def wrap_s(track: Track, s: jax.Array) -> jax.Array:
    """Wrap arc length onto [0, lap_length) (replaces the while loops at
    racing_env.py:12-15 with modular arithmetic)."""
    return jnp.mod(s, track.lap_length)


def _segment_mask(track: Track, s: jax.Array) -> jax.Array:
    """One-hot (first-match) segment membership for wrapped s."""
    inside = (s >= track.s0) & (s < track.s0 + track.seg_len + _S_TOL)
    # first matching segment wins, like np.where(...)[0][0] in the reference
    idx = jnp.argmax(inside)
    return jax.nn.one_hot(idx, track.num_segments, dtype=s.dtype)


@numerics.jit
def curvature(track: Track, s: jax.Array) -> jax.Array:
    """Signed curvature at arc length s (reference racing_env.py:225-246).

    Gather, not a masked sum: this runs once per Euler substep inside every
    hot loop, and a float reduction here is both slower and fusion-order
    dependent — XLA tiles reductions differently per compilation context,
    which broke bitwise fused-vs-host agreement once the substep scan was
    unrolled.  argmax-over-bools + gather is integer-exact everywhere."""
    s = wrap_s(track, s)
    inside = (s >= track.s0) & (s < track.s0 + track.seg_len + _S_TOL)
    return track.curv[jnp.argmax(inside)]


def _arc_geometry(track: Track):
    """Per-segment arc quantities with straight-segment guards."""
    is_arc = track.curv != 0.0
    safe_curv = jnp.where(is_arc, track.curv, 1.0)
    R = jnp.abs(1.0 / safe_curv)
    direction = jnp.sign(safe_curv)
    theta0 = jnp.arctan2(
        track.start_xy[:, 1] - track.center_xy[:, 1],
        track.start_xy[:, 0] - track.center_xy[:, 0],
    )
    return is_arc, R, direction, theta0


@numerics.jit
def frenet_to_global_xy(track: Track, s: jax.Array, ey: jax.Array) -> jax.Array:
    """(s, ey) -> (X, Y) (reference get_global_position, racing_env.py:6-69)."""
    s = wrap_s(track, s)
    mask = _segment_mask(track, s)
    ds = s - track.s0

    # straight candidate
    frac = ds / track.seg_len
    n_hat = jnp.stack(
        [jnp.cos(track.psi_start + jnp.pi / 2), jnp.sin(track.psi_start + jnp.pi / 2)], axis=-1
    )
    straight = (
        track.start_xy
        + frac[:, None] * (track.end_xy - track.start_xy)
        + ey * n_hat
    )

    # arc candidate
    is_arc, R, direction, theta0 = _arc_geometry(track)
    span = ds / R
    theta = theta0 + direction * span
    radial = jnp.stack([jnp.cos(theta), jnp.sin(theta)], axis=-1)
    arc = track.center_xy + (R - direction * ey)[:, None] * radial

    cand = jnp.where(is_arc[:, None], arc, straight)
    return jnp.sum(mask[:, None] * cand, axis=0)


@numerics.jit
def frenet_to_global_psi(track: Track, s: jax.Array, ey: jax.Array) -> jax.Array:
    """Centerline tangent angle at s (reference get_orientation,
    racing_env.py:72-127; see module docstring for the right-arc fix)."""
    s = wrap_s(track, s)
    mask = _segment_mask(track, s)
    ds = s - track.s0
    is_arc, R, direction, theta0 = _arc_geometry(track)
    theta = theta0 + direction * (ds / R)
    psi_arc = theta + direction * jnp.pi / 2
    cand = jnp.where(is_arc, psi_arc, track.psi_start)
    psi = jnp.sum(mask * cand)
    return wrap_angle(psi)


@numerics.jit
def frenet_to_global_state(track: Track, xcurv: jax.Array) -> jax.Array:
    """Full xcurv -> xglob conversion ([vx,vy,wz,epsi,s,ey] ->
    [vx,vy,wz,psi,X,Y]); psi = tangent + epsi."""
    xy = frenet_to_global_xy(track, xcurv[4], xcurv[5])
    psi = frenet_to_global_psi(track, xcurv[4], xcurv[5]) + xcurv[3]
    return jnp.concatenate([xcurv[:3], jnp.array([psi]), xy])


@numerics.jit
def global_to_frenet(track: Track, x: jax.Array, y: jax.Array, psi: jax.Array):
    """(X, Y, psi) -> (s, ey, epsi, ok) (reference get_local_position,
    racing_env.py:130-222), as a masked scan over all segments.

    Returns the first segment (in track order) whose perpendicular/arc
    projection contains the point with |ey| <= width; ``ok`` is False if no
    segment matches (point off track).
    """
    p = jnp.stack([x, y])

    # ---- straight candidates ----
    v1 = p - track.start_xy  # (n,2)
    seg_vec = track.end_xy - track.start_xy
    seg_norm = jnp.maximum(jnp.linalg.norm(seg_vec, axis=-1), 1e-12)
    t_hat = seg_vec / seg_norm[:, None]
    s_local_st = v1[:, 0] * t_hat[:, 0] + v1[:, 1] * t_hat[:, 1]
    ey_st = -v1[:, 0] * t_hat[:, 1] + v1[:, 1] * t_hat[:, 0]
    valid_st = (s_local_st >= -_S_TOL) & (s_local_st <= track.seg_len + _S_TOL)
    epsi_st = wrap_angle(psi - track.psi_start)

    # ---- arc candidates ----
    is_arc, R, direction, theta0 = _arc_geometry(track)
    v = p - track.center_xy
    theta_p = jnp.arctan2(v[:, 1], v[:, 0])
    arc2 = wrap_angle(theta_p - theta0)  # signed angle travelled from start
    span_full = track.seg_len / R  # unsigned total span
    same_side = jnp.sign(arc2) == direction
    valid_arc = same_side & (jnp.abs(arc2) <= span_full + _S_TOL)
    s_local_arc = jnp.abs(arc2) * R
    ey_arc = -direction * (jnp.linalg.norm(v, axis=-1) - R)
    epsi_arc = wrap_angle(psi - (track.psi_start + arc2))

    s_local = jnp.where(is_arc, s_local_arc, s_local_st)
    ey = jnp.where(is_arc, ey_arc, ey_st)
    epsi = jnp.where(is_arc, epsi_arc, epsi_st)
    valid = jnp.where(is_arc, valid_arc, valid_st) & (jnp.abs(ey) <= track.width)

    idx = jnp.argmax(valid)  # first valid segment in track order
    ok = jnp.any(valid)
    pick = lambda a: a[idx]
    s = jnp.where(ok, pick(track.s0) + pick(s_local), 1e4)
    return (
        jnp.where(ok, s, 1e4),
        jnp.where(ok, pick(ey), 1e4),
        jnp.where(ok, pick(epsi), 1e4),
        ok,
    )


# vectorized conveniences -----------------------------------------------------

curvature_batch = jax.vmap(curvature, in_axes=(None, 0))
frenet_to_global_xy_batch = jax.vmap(frenet_to_global_xy, in_axes=(None, 0, 0))
frenet_to_global_psi_batch = jax.vmap(frenet_to_global_psi, in_axes=(None, 0, 0))
frenet_to_global_state_batch = jax.vmap(frenet_to_global_state, in_axes=(None, 0))


def sample_boundaries(track: Track, points_per_meter: int = 100):
    """Sample inner/center/outer boundary polylines for plotting (reference
    plot_track, racing_env.py:286-318). Host-side helper."""
    n_pts = int(np.floor(points_per_meter * float(track.lap_length)))
    s = jnp.asarray(np.arange(n_pts) / points_per_meter, dtype=track.s0.dtype)
    w = track.width
    outer = frenet_to_global_xy_batch(track, s, jnp.full_like(s, w))
    center = frenet_to_global_xy_batch(track, s, jnp.zeros_like(s))
    inner = frenet_to_global_xy_batch(track, s, jnp.full_like(s, -w))
    return np.asarray(inner), np.asarray(center), np.asarray(outer)
