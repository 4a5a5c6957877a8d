"""Kernels for the closed-loop hot paths: the fused control-period
integrator (a Pallas kernel for the GPU, Triton route) and the batched SPD
solves of the interior-point Newton systems (plain JAX).

**Fused integrator** (:func:`propagate_fused`).  Every closed-loop step of
every controller integrates one control period as 100 sequential Euler
substeps of ~30 scalar flops each.  As a ``lax.scan`` that is one loop
iteration (a kernel launch plus the loop-condition round trip) per substep;
here the whole period is one kernel.  One thread carries one vehicle's
9-float state in registers through a ``fori_loop`` over the substeps.  All
per-lane inputs (state, input, lap length, tire parameters and the track's
segment table) are packed as rows of one ``(rows, lanes)`` array, so a
vmapped fleet becomes ONE kernel over a grid of lane blocks
(``custom_vmap``) instead of one program per lane.  The tire model uses
``jnp.arctan2``/``jnp.arctan`` like the scan; they lower to libdevice, whose
last-ulp results differ from XLA's, so the kernel is numerically equivalent
to the scan (about 1e-6 per period) but not bitwise identical.

**Batched SPD solves** (:func:`solve_batched`, :func:`solve_multi_batched`).
``jnp.linalg.cholesky`` + ``cho_solve``, which XLA hands to cuSOLVER/cuBLAS
on the GPU.  These wrappers are the one call site the batched IPM uses.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from . import track as track_ops


def solve_batched(A: jax.Array, b: jax.Array) -> jax.Array:
    """Batched SPD solve: A (B, n, n), b (B, n) -> (B, n)."""
    L = jnp.linalg.cholesky(A)
    return jax.scipy.linalg.cho_solve((L, True), b[..., None])[..., 0]


def solve_multi_batched(A: jax.Array, Brhs: jax.Array) -> jax.Array:
    """Multi-RHS batched SPD solve: A (B, n, n), Brhs (B, n, r) -> (B, n, r)
    (one block-eliminated KKT step has r = 1 + p right-hand sides)."""
    L = jnp.linalg.cholesky(A)
    return jax.scipy.linalg.cho_solve((L, True), Brhs)


# ---------------------------------------------------------------------------
# Fused control-period integrator.
#
# Packed lane rows: 0-8 state (vx vy wz epsi s ey psi X Y), 9-10 input
# (delta a), 11 lap length, 12-21 tire/body parameters, then the segment
# table as three groups of K rows (start s, end s + tolerance, curvature).
# ---------------------------------------------------------------------------

_N_STATE = 9
_ROW_U = 9
_ROW_LAP = 11
_ROW_PAR = 12
_ROW_SEG = 22
_OUT_ROWS = 16  # power of two >= _N_STATE (Triton block shapes)
_MAX_LANE_BLOCK = 128


def _lane_block(n_lanes: int) -> int:
    """Lanes per program: a power of two in [16, 128], one thread each."""
    return min(_MAX_LANE_BLOCK, max(16, pl.next_power_of_2(n_lanes)))


def _integrator_kernel(x_ref, o_ref, *, n_seg: int, n_sub: int, sub_dt: float):
    row = lambda r: x_ref[r, :]
    state = tuple(row(i) for i in range(_N_STATE))
    delta, a = row(_ROW_U), row(_ROW_U + 1)
    lap = row(_ROW_LAP)
    m, lf, lr, Iz, Df, Cf, Bf, Dr, Cr, Br = (row(_ROW_PAR + i) for i in range(10))
    # the segment table, read once per program and kept in registers
    s0 = [row(_ROW_SEG + k) for k in range(n_seg)]
    hi = [row(_ROW_SEG + n_seg + k) for k in range(n_seg)]
    seg_curv = [row(_ROW_SEG + 2 * n_seg + k) for k in range(n_seg)]
    sin_d, cos_d = jnp.sin(delta), jnp.cos(delta)
    dt = jnp.float32(sub_dt)

    def substep(_, carry):
        vx, vy, wz, epsi, s, ey, psi, X, Y = carry
        # track.curvature: the first segment containing s wins; no match
        # falls back to segment 0 like argmax over all-False
        s_w = jnp.mod(s, lap)
        curv = seg_curv[0]
        for k in reversed(range(n_seg)):
            inside = (s_w >= s0[k]) & (s_w < hi[k])
            curv = jnp.where(inside, seg_curv[k], curv)
        # dynamics.step, term for term
        alpha_f = delta - jnp.arctan2(vy + lf * wz, vx)
        alpha_r = -jnp.arctan2(vy - lr * wz, vx)
        Fyf = 2 * Df * jnp.sin(Cf * jnp.arctan(Bf * alpha_f))
        Fyr = 2 * Dr * jnp.sin(Cr * jnp.arctan(Br * alpha_r))
        dvx = a - Fyf * sin_d / m + wz * vy
        dvy = (Fyf * cos_d + Fyr) / m - wz * vx
        dwz = (lf * Fyf * cos_d - lr * Fyr) / Iz
        den = 1.0 - curv * ey
        s_dot = (vx * jnp.cos(epsi) - vy * jnp.sin(epsi)) / den
        return (
            vx + dt * dvx,
            vy + dt * dvy,
            wz + dt * dwz,
            epsi + dt * (wz - s_dot * curv),
            s + dt * s_dot,
            ey + dt * (vx * jnp.sin(epsi) + vy * jnp.cos(epsi)),
            psi + dt * wz,
            X + dt * (vx * jnp.cos(psi) - vy * jnp.sin(psi)),
            Y + dt * (vx * jnp.sin(psi) + vy * jnp.cos(psi)),
        )

    out = jax.lax.fori_loop(0, n_sub, substep, state)
    for i, v in enumerate(out):
        o_ref[i, :] = v


def _integrate_lanes(x: jax.Array, n_seg: int, n_sub: int, sub_dt: float,
                     interpret: bool) -> jax.Array:
    """x: (rows, B) packed lanes -> (9, B) integrated states."""
    rows, n = x.shape
    blk = _lane_block(n)
    pad = (-n) % blk
    if pad:  # replicate the last lane: padded lanes stay finite
        x = jnp.pad(x, ((0, 0), (0, pad)), mode="edge")
    out = pl.pallas_call(
        functools.partial(_integrator_kernel, n_seg=n_seg, n_sub=n_sub, sub_dt=sub_dt),
        out_shape=jax.ShapeDtypeStruct((_OUT_ROWS, n + pad), jnp.float32),
        grid=((n + pad) // blk,),
        in_specs=[pl.BlockSpec((rows, blk), lambda i: (0, i))],
        out_specs=pl.BlockSpec((_OUT_ROWS, blk), lambda i: (0, i)),
        compiler_params=plgpu.CompilerParams(num_warps=max(1, blk // 32), num_stages=1),
        backend="triton",
        interpret=interpret,
        name="propagate_fused",
    )(x)
    return out[:_N_STATE, :n]


@functools.lru_cache(maxsize=None)
def _lanes_op(n_seg: int, n_sub: int, sub_dt: float, interpret: bool):
    """(..., rows) packed lanes -> (..., 9), batched as one kernel call.

    Under ``vmap`` the batch rule folds the mapped axis into the lane
    dimension and calls the same op again, so nested vmaps (fleet x
    scenario) still end in a single kernel over all lanes."""

    @jax.custom_batching.custom_vmap
    def lanes(x):
        lead = x.shape[:-1]
        flat = x.reshape(-1, x.shape[-1]).T
        out = _integrate_lanes(flat, n_seg, n_sub, sub_dt, interpret)
        return out.T.reshape(lead + (_N_STATE,))

    @lanes.def_vmap
    def _rule(axis_size, in_batched, x):
        if not in_batched[0]:
            x = jnp.broadcast_to(x, (axis_size,) + x.shape)
        return lanes(x), True

    return lanes


def propagate_fused(track, params, xglob, xcurv, u, control_dt=0.1,
                    sub_dt=0.001, interpret: bool = False):
    """One control period of Euler substeps as a single Pallas kernel.

    Same semantics as ``dynamics.propagate`` (which dispatches here on the
    GPU); computes in f32.  The kernel is compiled for the GPU through
    Triton; ``interpret=True`` runs it on any backend (CPU tests).  An
    explicit call lowered for another platform without ``interpret`` fails
    at lowering — there is no silent fallback."""
    n_sub = int(round(control_dt / sub_dt))
    f32 = lambda a: jnp.asarray(a, jnp.float32)
    hi = track.s0 + track.seg_len + track_ops._S_TOL
    par = [params.m, params.lf, params.lr, params.Iz, params.Df, params.Cf,
           params.Bf, params.Dr, params.Cr, params.Br]
    cols = [xcurv, xglob[3:6], u, track.lap_length[None],
            jnp.stack(par), track.s0, hi, track.curv]
    x = jnp.concatenate([f32(c) for c in cols])
    rows = pl.next_power_of_2(x.shape[0])
    x = jnp.pad(x, (0, rows - x.shape[0]))
    out = _lanes_op(int(track.s0.shape[0]), n_sub, float(sub_dt), bool(interpret))(x)
    xcurv_next = out[:6].astype(xcurv.dtype)
    xglob_next = jnp.concatenate([out[:3], out[6:]]).astype(xglob.dtype)
    return xglob_next, xcurv_next
