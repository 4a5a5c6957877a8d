"""Dynamic bicycle model with Pacejka tire forces as pure jittable functions.

Re-design of the reference's dynamics layer:
- one Euler step of both global and curvilinear state
  (reference car_racing/system/vehicle_dynamics.py:4-49);
- a control-period propagation of fine Euler substeps, which the reference
  runs as a Python ``while`` loop of 100 iterations per control step
  (car_racing/utils/base.py:897-942) and we run as one ``lax.scan``;
- truncated-Gaussian process noise on (vx, vy, wz) with the reference's
  clipping semantics (base.py:930-939), driven by a jax PRNG key;
- analytic linearizations of the reference (lmpc_helper.py:149-187) replaced
  by one `jax.jacfwd` call on the curvilinear step.

Parameters are a pytree so everything vmaps over fleets of vehicles.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp

from ..ops import track as track_ops
from ..utils import numerics
from ..utils.constants import X_DIM


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class BicycleParams:
    """Bicycle + Pacejka tire parameters (reference utils/base.py:659-696)."""

    m: jax.Array
    lf: jax.Array
    lr: jax.Array
    Iz: jax.Array
    Df: jax.Array
    Cf: jax.Array
    Bf: jax.Array
    Dr: jax.Array
    Cr: jax.Array
    Br: jax.Array

    @staticmethod
    def default() -> "BicycleParams":
        f = jnp.asarray
        return BicycleParams(
            m=f(1.98),
            lf=f(0.125),
            lr=f(0.125),
            Iz=f(0.024),
            Df=f(0.8 * 1.98 * 9.81 / 2.0),
            Cf=f(1.25),
            Bf=f(1.0),
            Dr=f(0.8 * 1.98 * 9.81 / 2.0),
            Cr=f(1.25),
            Br=f(1.0),
        )


def tire_forces(params: BicycleParams, xcurv: jax.Array, delta: jax.Array):
    """Front/rear lateral tire forces (vehicle_dynamics.py:25-30).

    Note the reference computes the rear slip angle with ``lf`` (not ``lr``)
    at vehicle_dynamics.py:26; with the default symmetric geometry
    (lf == lr == 0.125) the two are identical.  We use ``lr``.
    """
    vx, vy, wz = xcurv[0], xcurv[1], xcurv[2]
    alpha_f = delta - jnp.arctan2(vy + params.lf * wz, vx)
    alpha_r = -jnp.arctan2(vy - params.lr * wz, vx)
    Fyf = 2 * params.Df * jnp.sin(params.Cf * jnp.arctan(params.Bf * alpha_f))
    Fyr = 2 * params.Dr * jnp.sin(params.Cr * jnp.arctan(params.Br * alpha_r))
    return Fyf, Fyr


def step(
    params: BicycleParams,
    curv: jax.Array,
    xglob: jax.Array,
    xcurv: jax.Array,
    dt: jax.Array,
    u: jax.Array,
):
    """One explicit-Euler step of (xglob, xcurv) (vehicle_dynamics.py:4-49)."""
    delta, a = u[0], u[1]
    vx, vy, wz = xcurv[0], xcurv[1], xcurv[2]
    epsi, s, ey = xcurv[3], xcurv[4], xcurv[5]
    psi = xglob[3]

    Fyf, Fyr = tire_forces(params, xcurv, delta)
    dvx = a - Fyf * jnp.sin(delta) / params.m + wz * vy
    dvy = (Fyf * jnp.cos(delta) + Fyr) / params.m - wz * vx
    dwz = (params.lf * Fyf * jnp.cos(delta) - params.lr * Fyr) / params.Iz

    den = 1.0 - curv * ey
    s_dot = (vx * jnp.cos(epsi) - vy * jnp.sin(epsi)) / den
    xcurv_next = jnp.array(
        [
            vx + dt * dvx,
            vy + dt * dvy,
            wz + dt * dwz,
            epsi + dt * (wz - s_dot * curv),
            s + dt * s_dot,
            ey + dt * (vx * jnp.sin(epsi) + vy * jnp.cos(epsi)),
        ]
    )
    xglob_next = jnp.array(
        [
            vx + dt * dvx,
            vy + dt * dvy,
            wz + dt * dwz,
            psi + dt * wz,
            xglob[4] + dt * (vx * jnp.cos(psi) - vy * jnp.sin(psi)),
            xglob[5] + dt * (vx * jnp.sin(psi) + vy * jnp.cos(psi)),
        ]
    )
    return xglob_next, xcurv_next


def curv_step(track: track_ops.Track, params: BicycleParams, xcurv, u, dt):
    """Curvilinear-only Euler step with on-track curvature lookup; the
    function every linearization/jacobian in the framework differentiates."""
    curv = track_ops.curvature(track, xcurv[4])
    _, xcurv_next = step(params, curv, jnp.zeros(X_DIM), xcurv, dt, u)
    return xcurv_next


@partial(numerics.jit, static_argnames=("control_dt", "sub_dt", "unroll", "backend"))
def propagate(
    track: track_ops.Track,
    params: BicycleParams,
    xglob: jax.Array,
    xcurv: jax.Array,
    u: jax.Array,
    control_dt: float = 0.1,
    sub_dt: float = 0.001,
    unroll: int = 1,
    backend: str = "auto",
):
    """Propagate one control period with fine Euler substeps.

    Replaces the reference's host-side ``while`` loop of 100 substeps per
    control step (base.py:909-928) with one ``lax.scan``; curvature is
    re-looked-up every substep as in the reference.

    ``unroll``: lets XLA fuse that many substeps per scan iteration.  The
    default stays 1 because unrolling changes XLA's fusion/FMA contraction
    choices *differently per compilation context*, which breaks the
    framework's bitwise fused-vs-host agreement and the pinned goldens;
    throughput paths with no host twin (the sharded fleets) opt in.  Only
    the scan reads it: ``"auto"`` on CUDA runs the kernel and drops it.

    ``backend``: ``"scan"`` is the ``lax.scan`` above; ``"pallas"`` runs the
    whole period as ONE GPU kernel (ops/pallas_kernels.propagate_fused),
    numerically equivalent to the scan but not bitwise identical.
    ``"auto"`` (the default) picks by the platform the computation is
    lowered for — that is, where its inputs live, not the process default:
    the kernel on CUDA, the scan everywhere else.  The CPU goldens and
    bitwise fused-vs-host gates therefore certify the scan, and the
    ``gpu``-marked tests gate the kernel against it.
    """
    if backend == "auto":
        return jax.lax.platform_dependent(
            track, params, xglob, xcurv, u,
            cuda=partial(propagate, control_dt=control_dt, sub_dt=sub_dt,
                         backend="pallas"),
            default=partial(propagate, control_dt=control_dt, sub_dt=sub_dt,
                            unroll=unroll, backend="scan"),
        )
    if backend == "pallas":
        from . import pallas_kernels

        return pallas_kernels.propagate_fused(
            track, params, xglob, xcurv, u, control_dt=control_dt,
            sub_dt=sub_dt,
        )
    if backend != "scan":
        raise ValueError(f"unknown dynamics backend {backend!r}")
    n_sub = int(round(control_dt / sub_dt))

    def body(carry, _):
        xg, xc = carry
        curv = track_ops.curvature(track, xc[4])
        xg, xc = step(params, curv, xg, xc, sub_dt, u)
        return (xg, xc), None

    (xglob, xcurv), _ = jax.lax.scan(
        body, (xglob, xcurv), None, length=n_sub, unroll=min(unroll, n_sub)
    )
    return xglob, xcurv


@numerics.jit
def process_noise(key: jax.Array, xcurv: jax.Array) -> jax.Array:
    """Truncated-Gaussian process noise on (vx, vy, wz) with the reference's
    scale/clip constants (base.py:930-939)."""
    k1, k2, k3 = jax.random.split(key, 3)
    noise = jnp.array(
        [
            jnp.clip(jax.random.normal(k1) * 0.01, -0.05, 0.05),
            jnp.clip(jax.random.normal(k2) * 0.01, -0.1, 0.1),
            jnp.clip(jax.random.normal(k3) * 0.005, -0.05, 0.05),
        ]
    )
    return xcurv.at[:3].add(0.5 * noise)


def linearize(track: track_ops.Track, params: BicycleParams, xcurv, u, dt):
    """Exact (A, B, C) of the curvilinear Euler step around (xcurv, u):
    ``x+ ~= A x + B u + C``.  One autodiff call replaces the reference's
    hand-derived rows (lmpc_helper.py:149-187) and CasADi symbolics."""
    f = lambda x, uu: curv_step(track, params, x, uu, dt)
    A = jax.jacfwd(f, argnums=0)(xcurv, u)
    B = jax.jacfwd(f, argnums=1)(xcurv, u)
    C = f(xcurv, u) - A @ xcurv - B @ u
    return A, B, C


@partial(numerics.jit, static_argnames=("dt", "n_steps"))
def const_velocity_prediction(track: track_ops.Track, xcurv, xglob, dt, n_steps: int):
    """n-step constant-velocity (zero-input kinematic) prediction used for
    obstacle forecasting (reference racing/offboard.py:51-94): velocities
    frozen, Frenet/global kinematics integrated at the control period.
    Returns (xcurv_traj, xglob_traj) with shape (n_steps, X_DIM); s wrapped."""

    def body(carry, _):
        xc, xg = carry
        curv = track_ops.curvature(track, xc[4])
        den = 1.0 - curv * xc[5]
        s_dot = (xc[0] * jnp.cos(xc[3]) - xc[1] * jnp.sin(xc[3])) / den
        xc_next = jnp.array(
            [
                xc[0],
                xc[1],
                xc[2],
                xc[3] + dt * (xc[2] - s_dot * curv),
                jnp.mod(xc[4] + dt * s_dot, track.lap_length),
                xc[5] + dt * (xc[0] * jnp.sin(xc[3]) + xc[1] * jnp.cos(xc[3])),
            ]
        )
        xg_next = jnp.array(
            [
                xg[0],
                xg[1],
                xg[2],
                xg[3] + dt * xg[2],
                xg[4] + dt * (xg[0] * jnp.cos(xg[3]) - xg[1] * jnp.sin(xg[3])),
                xg[5] + dt * (xg[0] * jnp.sin(xg[3]) + xg[1] * jnp.cos(xg[3])),
            ]
        )
        return (xc_next, xg_next), (xc, xg)

    _, (xc_traj, xg_traj) = jax.lax.scan(body, (xcurv, xglob), None, length=n_steps)
    return xc_traj, xg_traj
