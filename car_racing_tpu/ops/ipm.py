"""Primal-dual interior-point NLP/QP solver, from scratch, in JAX.

This replaces every foreign-solver call in the
reference (CasADi ``Opti``/IPOPT at car_racing/control/control.py:241,449,
595,699 and planning/overtake_{path,traj}_planner.py; cvxopt at
control/lmpc_helper.py:360): one jittable, vmappable solver for

    min_z  f(z)     s.t.   c_ineq(z) >= 0,   c_eq(z) = 0.

Design notes (accelerator-first):
- **Fixed iteration count, masked convergence.** No data-dependent Python
  control flow: the solver runs ``iters`` Newton iterations under
  ``lax.scan`` and freezes the iterate once the KKT residual passes ``tol``
  (so converged problems in a vmapped batch do no harmful extra work).
- **Derivatives by autodiff.** Gradients/Jacobians/Lagrangian Hessians come
  from jacfwd/hessian on the user's closures — replacing CasADi's symbolic
  AD.  For QPs the Hessian is constant and XLA hoists it out of the loop.
- **Convexification.** The Lagrangian Hessian is eigenvalue-clamped (the
  same device as the reference's iLQR Quu regularization, control.py:155-158)
  so nonconvex constraint curvature (degree-6 CBF barriers) cannot break the
  Newton solve.
- **Branch-free line search.** A small fixed set of step fractions is
  evaluated in parallel and the best (by merit) selected with argmin —
  no backtracking loop.
- **Batched.** Everything is shaped for ``vmap`` over problem batches
  (overtake branches, vehicles, scenarios); the batched inner dense solves
  map onto XLA's batched factorizations.

The condensed-OCP adapters living in :mod:`car_racing_tpu.ops.ocp` reduce
receding-horizon problems to this dense form; the horizon-structured
(Riccati / block-tridiagonal) KKT path is in :mod:`car_racing_tpu.ops.riccati`.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp

from ..utils import numerics


# ---------------------------------------------------------------------------
# Convergence grading.  ``tol`` drives the in-loop iterate freeze (strict:
# iteration stops improving a problem once its KKT residual passes tol).
# The ``converged`` flag reported to callers uses a LOOSER acceptance band,
# because fixed-iteration solvers routinely park a perfectly usable iterate
# slightly above the strict tol, and downstream fallback logic (planner
# kinematic fallback, warm-start reuse) must not discard it.  Two bands,
# deliberately:
#
# - GRADE_QP (1e3 x tol) — the convex QP family (solve_qp, solve_qp_batch,
#   solve_ocp_qp).  Condensed tracking/corridor/LMPC QPs carry rows spanning
#   ~4 orders of magnitude (progress weights 200, penalty weights 1e4), so
#   the inf-norm KKT residual of a solution whose decision variables are
#   accurate to f32 precision can sit ~1e2-1e3 x tol; empirically usable
#   solves land under this band while genuinely failed ones (infeasible
#   corridors) sit orders of magnitude above it.
# - GRADE_NL (1e2 x tol) — the nonlinear family (solve, solve_qp_nl).  The
#   flag gates CBF warm-start reuse and safety fallbacks, where accepting a
#   poor iterate is dangerous; nonconvex solves either converge well within
#   1e2 x tol or fail badly, so the tighter band costs nothing.
#
# The contract conv == (kkt_res < GRADE_* x tol) is pinned by
# tests/test_ipm.py::test_convergence_grading_bands.
# ---------------------------------------------------------------------------

GRADE_QP = 1e3
GRADE_NL = 1e2


class IPMSolution(NamedTuple):
    z: jax.Array  # primal solution
    lam: jax.Array  # inequality multipliers (>= 0)
    nu: jax.Array  # equality multipliers
    s: jax.Array  # inequality slacks (> 0)
    converged: jax.Array  # bool
    kkt_res: jax.Array  # final KKT residual (inf-norm)
    iterations: jax.Array  # iterations actually used (first pass under tol)


def _clamp_psd(H: jax.Array, floor: float) -> jax.Array:
    """Project a symmetric matrix to have eigenvalues >= floor (eigh)."""
    H = 0.5 * (H + H.T)
    w, V = jnp.linalg.eigh(H)
    w = jnp.maximum(w, floor)
    return (V * w) @ V.T


def _gershgorin_shift(H: jax.Array, floor: float) -> jax.Array:
    """Cheap PSD-ification: shift by the Gershgorin lower-bound deficit.

    delta = max(0, floor - min_i(H_ii - sum_{j != i} |H_ij|)) guarantees all
    eigenvalues >= floor without an eigendecomposition — O(n^2), tiny
    compile footprint.  NOTE: far from the constraint boundary the degree-6
    CBF curvature makes this bound so conservative that Newton steps
    degenerate (measured: the barrier test stalls), so the eigh clamp stays
    the default; use this only where compile time dominates and the problem
    is near-convex.
    """
    H = 0.5 * (H + H.T)
    diag = jnp.diag(H)
    off = jnp.sum(jnp.abs(H), axis=1) - jnp.abs(diag)
    lower = jnp.min(diag - off)
    delta = jnp.maximum(0.0, floor - lower)
    return H + delta * jnp.eye(H.shape[0], dtype=H.dtype)


def _eps_for(dtype):
    """Division/complementarity floors: f32 cannot represent the f64 path's
    1e-12-scale barriers without overflowing lam/s ratios."""
    if dtype == jnp.float64:
        return 1e-12, 1e-14
    return 1e-8, 3e-8


def _sigma_cap(dtype):
    """Cap on the barrier ratio lam/s: keeps Hbar's condition number inside
    what the dtype's dense solve can take (the LMPC equality-KKT block goes
    NaN in f32 otherwise)."""
    return 1e14 if dtype == jnp.float64 else 1e6


def _eq_reg(dtype):
    """Regularization of the equality block in the KKT matrix."""
    return 1e-10 if dtype == jnp.float64 else 1e-6


def _kkt_residual(grad_L, c_i, c_e, s, lam):
    comp = s * lam
    return jnp.max(
        jnp.concatenate(
            [
                jnp.abs(grad_L),
                jnp.abs(c_i - s),
                jnp.abs(c_e) if c_e.shape[0] else jnp.zeros(1, grad_L.dtype),
                jnp.abs(comp),
            ]
        )
    )


@partial(
    numerics.jit,
    static_argnames=("f", "c_ineq", "c_eq", "iters", "hessian_floor", "gauss_newton", "hessian_reg"),
)
def solve(
    f: Callable,
    c_ineq: Callable,
    z0: jax.Array,
    c_eq: Callable | None = None,
    *,
    iters: int = 40,
    tol: float | None = None,
    mu0: float = 1e-1,
    sigma: float = 0.2,
    tau: float = 0.995,
    hessian_floor: float = 1e-8,
    gauss_newton: bool = False,
    hessian_reg: str = "eigh",
) -> IPMSolution:
    """Solve ``min f(z) s.t. c_ineq(z) >= 0, c_eq(z) = 0``.

    All callables must be jax-traceable functions of ``z`` alone (close over
    problem data). ``gauss_newton=True`` drops constraint curvature from the
    Lagrangian Hessian (exact for problems with linear constraints — skips
    the m extra Hessians).
    """
    if c_eq is None:
        c_eq = lambda z: jnp.zeros((0,), dtype=z0.dtype)

    n = z0.shape[0]
    m = jax.eval_shape(c_ineq, z0).shape[0]
    p = jax.eval_shape(c_eq, z0).shape[0]
    dtype = z0.dtype
    if tol is None:
        tol = 1e-7 if dtype == jnp.float64 else 1e-3
    eps_div, mu_floor = _eps_for(dtype)

    grad_f = jax.grad(f)
    jac_i = jax.jacfwd(c_ineq)
    jac_e = jax.jacfwd(c_eq)

    if gauss_newton:
        hess_L = lambda z, lam, nu: jax.hessian(f)(z)
    else:

        def hess_L(z, lam, nu):
            L = lambda zz: f(zz) - lam @ c_ineq(zz) + (nu @ c_eq(zz) if p else 0.0)
            return jax.hessian(L)(z)

    # ---- initialization -----------------------------------------------------
    c0 = c_ineq(z0)
    s = jnp.maximum(c0, 1e-2)
    lam = jnp.full((m,), mu0, dtype) / s
    nu = jnp.zeros((p,), dtype)
    mu = jnp.asarray(mu0, dtype)

    alphas = jnp.asarray([1.0, 0.5, 0.2, 0.05], dtype)

    def step(carry, _):
        z, s, lam, nu, mu, best_res, done_iter, k = carry

        ci = c_ineq(z)
        ce = c_eq(z)
        Ji = jac_i(z)
        Je = jac_e(z)
        gL = grad_f(z) - Ji.T @ lam + (Je.T @ nu if p else 0.0)
        res = _kkt_residual(gL, ci, ce, s, lam)
        converged_now = res < tol
        done_iter = jnp.where(converged_now & (done_iter < 0), k, done_iter)

        reg = _clamp_psd if hessian_reg == "eigh" else _gershgorin_shift
        H = reg(hess_L(z, lam, nu), hessian_floor)

        # eliminate (ds, dlam):
        #   dlam = (mu - s*lam)/s - (lam/s) * (Ji dz + ci - s)
        sl = jnp.minimum(lam / jnp.maximum(s, eps_div), _sigma_cap(dtype))
        r_bar = (mu - s * lam) / jnp.maximum(s, eps_div) - sl * (ci - s)
        Hbar = H + (Ji.T * sl) @ Ji
        g_bar = -gL + Ji.T @ r_bar

        if p:
            M = jnp.block([[Hbar, Je.T], [Je, -_eq_reg(dtype) * jnp.eye(p, dtype=dtype)]])
            rhs = jnp.concatenate([g_bar, -ce])
            sol = jnp.linalg.solve(M, rhs)
            dz, dnu = sol[:n], sol[n:]
        else:
            # LU (not Cholesky) on purpose: the eigenvalue-clamped Lagrangian
            # Hessian of a nonconvex problem can sit exactly at the PSD floor,
            # where f32 Cholesky pivots may round negative and NaN the solve.
            dz = jnp.linalg.solve(Hbar + 1e-12 * jnp.eye(n, dtype=dtype), g_bar)
            dnu = jnp.zeros((0,), dtype)

        ds = Ji @ dz + (ci - s)
        dlam = r_bar - sl * (Ji @ dz)

        # fraction-to-boundary limits
        neg = lambda d, v: jnp.where(d < 0, -tau * v / jnp.minimum(d, -1e-30), jnp.inf)
        a_s = jnp.minimum(1.0, jnp.min(neg(ds, s))) if m else jnp.asarray(1.0, dtype)
        a_l = jnp.minimum(1.0, jnp.min(neg(dlam, lam))) if m else jnp.asarray(1.0, dtype)

        # pure fraction-to-boundary stepping (Mehrotra-style practical IPM:
        # a merit line search demonstrably stalls on degree-6 constraint
        # curvature); a parallel finiteness sweep guards against divergence.
        def finite(a):
            z_t = z + a * a_s * dz
            val = f(z_t) + jnp.sum(c_ineq(z_t))
            return jnp.isfinite(val) & jnp.all(jnp.isfinite(z_t))

        finites = jax.vmap(finite)(alphas)
        a = alphas[jnp.argmax(finites)]  # largest finite alpha (alphas sorted desc)
        ok = jnp.any(finites)
        a = jnp.where(ok, a, 0.0)

        upd = (~converged_now) & ok
        z = jnp.where(upd, z + a * a_s * dz, z)
        s = jnp.where(upd, s + a * a_s * ds, s)
        lam = jnp.where(upd, lam + a * a_l * dlam, lam)
        nu = jnp.where(upd, nu + a * a_l * dnu, nu)

        # slack reset: where the constraint is strictly satisfied, snap the
        # slack onto it.  This zeroes |c_i - s| for feasible rows so the
        # merit line search stops rejecting long steps over the second-order
        # remainder of very nonlinear constraints (degree-6 CBF barriers) —
        # the same role as IPOPT's slack correction.
        ci_new = c_ineq(z)
        s = jnp.where(upd & (ci_new > 1e-12), ci_new, s)

        duality = jnp.sum(s * lam) / jnp.maximum(m, 1)
        mu = jnp.where(upd, jnp.maximum(sigma * duality, mu_floor), mu)
        best_res = jnp.minimum(best_res, res)
        return (z, s, lam, nu, mu, best_res, done_iter, k + 1), None

    init = (
        z0,
        s,
        lam,
        nu,
        mu,
        jnp.asarray(jnp.inf, dtype),
        jnp.asarray(-1, jnp.int32),
        jnp.asarray(0, jnp.int32),
    )
    # early exit once converged (iterate frozen -> bitwise identical)
    (z, s, lam, nu, mu, best_res, done_iter, _) = jax.lax.while_loop(
        lambda c: (c[6] < 0) & (c[7] < iters), lambda c: step(c, None)[0], init
    )

    # final residual
    ci = c_ineq(z)
    ce = c_eq(z)
    gL = grad_f(z) - jac_i(z).T @ lam + (jac_e(z).T @ nu if p else 0.0)
    res = _kkt_residual(gL, ci, ce, s, lam)
    return IPMSolution(
        z=z,
        lam=lam,
        nu=nu,
        s=s,
        converged=res < jnp.asarray(tol * GRADE_NL, dtype),
        kkt_res=res,
        iterations=jnp.where(done_iter < 0, iters, done_iter),
    )


# ---------------------------------------------------------------------------
# Dense convex QP fast path:  min 1/2 z'Hz + g'z  s.t.  Cz >= d, Ez = e.
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class QP:
    """Dense QP data (a pytree via register_dataclass below)."""

    H: jax.Array  # (n, n)
    g: jax.Array  # (n,)
    C: jax.Array  # (m, n) inequality Cz >= d
    d: jax.Array  # (m,)
    E: jax.Array  # (p, n) equality Ez = e
    e: jax.Array  # (p,)


jax.tree_util.register_dataclass(QP)


@partial(numerics.jit, static_argnames=("iters",))
def solve_qp(qp: QP, z0: jax.Array, *, iters: int = 30, tol: float | None = None) -> IPMSolution:
    """Specialized primal-dual IPM for dense convex QPs.

    Identical algorithm to :func:`solve` but with the derivatives inlined as
    matrix products (no autodiff retrace, no eigendecomposition) — this is
    the hot path for MPC-LTI / LMPC / path-planner QPs.
    """
    H, g, C, d, E, e = qp.H, qp.g, qp.C, qp.d, qp.E, qp.e
    n = H.shape[0]
    m = C.shape[0]
    p = E.shape[0]
    dtype = H.dtype
    if tol is None:
        tol = 1e-8 if dtype == jnp.float64 else 1e-3
    eps_div, mu_floor = _eps_for(dtype)

    s = jnp.maximum(C @ z0 - d, 1e-2)
    lam = jnp.full((m,), 0.1, dtype) / s
    nu = jnp.zeros((p,), dtype)
    mu = jnp.asarray(1e-1, dtype)
    tau = 0.995

    def step(carry, _):
        z, s, lam, nu, mu, done_iter, k = carry
        ci = C @ z - d
        ce = E @ z - e
        gL = H @ z + g - C.T @ lam + (E.T @ nu if p else 0.0)
        res = _kkt_residual(gL, ci, ce, s, lam)
        converged_now = res < tol
        done_iter = jnp.where(converged_now & (done_iter < 0), k, done_iter)

        sl = jnp.minimum(lam / jnp.maximum(s, eps_div), _sigma_cap(dtype))
        r_bar = (mu - s * lam) / jnp.maximum(s, eps_div) - sl * (ci - s)
        Hbar = H + (C.T * sl) @ C + 1e-10 * jnp.eye(n, dtype=dtype)
        g_bar = -gL + C.T @ r_bar

        if p:
            # full LU on the indefinite KKT matrix, NOT Cholesky+Schur
            # elimination: the LMPC QP's lambda block leaves Hbar near-
            # singular whenever most safe-set multipliers are inactive, and
            # the Schur path NaNs there (measured on the realtime staged-
            # protocol test) while saving only ~0.02 ms/iteration.
            M = jnp.block([[Hbar, E.T], [E, -_eq_reg(dtype) * jnp.eye(p, dtype=dtype)]])
            rhs = jnp.concatenate([g_bar, -ce])
            sol = jnp.linalg.solve(M, rhs)
            dz, dnu = sol[:n], sol[n:]
        else:
            # Hbar is SPD by construction (H convex + sl >= 0 + ridge):
            # Cholesky halves the factorization cost vs LU and lowers well.
            L = jnp.linalg.cholesky(Hbar)
            dz = jax.scipy.linalg.cho_solve((L, True), g_bar[:, None])[:, 0]
            dnu = jnp.zeros((0,), dtype)

        ds = C @ dz + (ci - s)
        dlam = r_bar - sl * (C @ dz)

        neg = lambda dv, v: jnp.where(dv < 0, -tau * v / jnp.minimum(dv, -1e-30), jnp.inf)
        a_s = jnp.minimum(1.0, jnp.min(neg(ds, s)))
        a_l = jnp.minimum(1.0, jnp.min(neg(dlam, lam)))

        # non-finite step guard (same containment as solve_qp_nl): an
        # accelerator's f32 LU on the bordered LMPC KKT can emit NaN when
        # the selected safe-set points degenerate (near the lap wrap:
        # clamped select_points windows repeat rows, the hull block goes
        # singular; CPU f32 survives with large-but-finite pivots).  Skip
        # the step instead of poisoning the iterate —
        # the caller gets the last finite point with converged=False and
        # closed loops continue on the warm start.
        ok = (
            jnp.all(jnp.isfinite(dz))
            & jnp.all(jnp.isfinite(ds))
            & jnp.all(jnp.isfinite(dlam))
            & jnp.all(jnp.isfinite(dnu))
        )
        upd = (~converged_now) & ok
        z = jnp.where(upd, z + a_s * dz, z)
        s = jnp.where(upd, s + a_s * ds, s)
        lam = jnp.where(upd, lam + a_l * dlam, lam)
        nu = jnp.where(upd, nu + a_l * dnu, nu)
        duality = jnp.sum(s * lam) / jnp.maximum(m, 1)
        mu = jnp.where(upd, jnp.maximum(0.1 * duality, mu_floor), mu)
        return (z, s, lam, nu, mu, done_iter, k + 1), None

    init = (z0, s, lam, nu, mu, jnp.asarray(-1, jnp.int32), jnp.asarray(0, jnp.int32))
    # early exit once converged (done_iter set): the iterate is frozen from
    # that point, so exiting is bitwise identical to finishing the budget
    (z, s, lam, nu, mu, done_iter, _) = jax.lax.while_loop(
        lambda c: (c[5] < 0) & (c[6] < iters), lambda c: step(c, None)[0], init
    )

    ci = C @ z - d
    ce = E @ z - e
    gL = H @ z + g - C.T @ lam + (E.T @ nu if p else 0.0)
    res = _kkt_residual(gL, ci, ce, s, lam)
    return IPMSolution(
        z=z,
        lam=lam,
        nu=nu,
        s=s,
        converged=res < jnp.asarray(tol * GRADE_QP, dtype),
        kkt_res=res,
        iterations=jnp.where(done_iter < 0, iters, done_iter),
    )


# ---------------------------------------------------------------------------
# Batched QP solver over leading batch dims; the Newton systems go through
# the batched SPD solves of ops/pallas_kernels.py.
# ---------------------------------------------------------------------------


@partial(numerics.jit, static_argnames=("iters",))
def solve_qp_batch(qp: QP, z0: jax.Array, *, iters: int = 30, tol: float | None = None) -> IPMSolution:
    """Batched :func:`solve_qp`: every QP field carries a leading batch dim.

    The same primal-dual iteration, written with batched contractions; the
    per-iteration Newton systems for the whole batch go through one
    batched Cholesky (pallas_kernels.solve_batched / solve_multi_batched) —
    this is the hot path of branch sweeps (hundreds of tiny QPs per step).
    Equality constraints are handled by block elimination: with
    W = Hbar^-1 [g_bar, E^T], the p x p Schur system gives dnu, then dz.
    """
    from . import pallas_kernels

    H, g, C, d, E, e = qp.H, qp.g, qp.C, qp.d, qp.E, qp.e
    B, n, _ = H.shape
    m = C.shape[1]
    p = E.shape[1]
    dtype = H.dtype
    if tol is None:
        # dtype-aware: float32 cannot reach the f64 KKT tolerance
        tol = 1e-8 if dtype == jnp.float64 else 1e-3
    eps_div, mu_floor = _eps_for(dtype)
    tau = 0.995

    bmm = lambda M, v: jnp.einsum("bij,bj->bi", M, v)
    bmT = lambda M, v: jnp.einsum("bij,bi->bj", M, v)

    s = jnp.maximum(bmm(C, z0) - d, 1e-2)
    lam = jnp.full((B, m), 0.1, dtype) / s
    nu = jnp.zeros((B, p), dtype)
    mu = jnp.full((B,), 1e-1, dtype)

    def kkt_res(z, s, lam, nu):
        ci = bmm(C, z) - d
        gL = bmm(H, z) + g - bmT(C, lam) + (bmT(E, nu) if p else 0.0)
        parts = [jnp.abs(gL), jnp.abs(ci - s), jnp.abs(s * lam)]
        if p:
            parts.append(jnp.abs(bmm(E, z) - e))
        return jnp.max(jnp.concatenate(parts, axis=1), axis=1)

    def step(carry, _):
        z, s, lam, nu, mu, done, done_iter, k = carry
        ci = bmm(C, z) - d
        gL = bmm(H, z) + g - bmT(C, lam) + (bmT(E, nu) if p else 0.0)
        res = kkt_res(z, s, lam, nu)
        done = done | (res < tol)
        done_iter = jnp.where(done & (done_iter < 0), k, done_iter)

        sl = jnp.minimum(lam / jnp.maximum(s, eps_div), _sigma_cap(dtype))
        r_bar = (mu[:, None] - s * lam) / jnp.maximum(s, eps_div) - sl * (ci - s)
        Hbar = H + jnp.einsum("bki,bk,bkj->bij", C, sl, C)
        Hbar = Hbar + 1e-9 * jnp.eye(n, dtype=dtype)
        g_bar = -gL + bmT(C, r_bar)

        if p:
            rhs = jnp.concatenate(
                [g_bar[:, :, None], jnp.transpose(E, (0, 2, 1))], axis=2
            )  # (B, n, 1+p)
            W = pallas_kernels.solve_multi_batched(Hbar, rhs)
            W_g = W[:, :, 0]
            W_E = W[:, :, 1:]  # (B, n, p)
            ce = bmm(E, z) - e
            S = jnp.einsum("bpi,bik->bpk", E, W_E) + _eq_reg(dtype) * jnp.eye(p, dtype=dtype)
            rhs_nu = bmm(E, W_g) + ce
            dnu = jnp.linalg.solve(S, rhs_nu[..., None])[..., 0]
            dz = W_g - jnp.einsum("bip,bp->bi", W_E, dnu)
        else:
            dz = pallas_kernels.solve_batched(Hbar, g_bar)
            dnu = nu

        ds = bmm(C, dz) + (ci - s)
        dlam = r_bar - sl * bmm(C, dz)

        neg = lambda dv, v: jnp.where(dv < 0, -tau * v / jnp.minimum(dv, -1e-30), jnp.inf)
        a_s = jnp.minimum(1.0, jnp.min(neg(ds, s), axis=1))
        a_l = jnp.minimum(1.0, jnp.min(neg(dlam, lam), axis=1))

        # per-problem non-finite step guard (see solve_qp): freeze a
        # problem whose Newton step went NaN instead of poisoning it
        ok = (
            jnp.all(jnp.isfinite(dz), axis=1)
            & jnp.all(jnp.isfinite(ds), axis=1)
            & jnp.all(jnp.isfinite(dlam), axis=1)
            & (jnp.all(jnp.isfinite(dnu), axis=1) if p else True)
        )
        upd = ((~done) & ok)[:, None]
        z = jnp.where(upd, z + a_s[:, None] * dz, z)
        s = jnp.where(upd, s + a_s[:, None] * ds, s)
        lam = jnp.where(upd, lam + a_l[:, None] * dlam, lam)
        if p:
            nu_new = nu + a_l[:, None] * dnu
            nu = jnp.where(upd, nu_new, nu)
        duality = jnp.sum(s * lam, axis=1) / m
        mu = jnp.where(upd[:, 0], jnp.maximum(0.1 * duality, mu_floor), mu)
        return (z, s, lam, nu, mu, done, done_iter, k + 1), None

    done0 = jnp.zeros((B,), bool)
    di0 = jnp.full((B,), -1, jnp.int32)
    # while_loop with an all-converged early exit instead of a fixed-length
    # scan: converged problems' iterates are frozen (upd masks), so exiting
    # once every problem is done is BITWISE identical to running the full
    # budget — but the batch pays max(needed) iterations, not `iters`
    # (corridor batches converge at p50=10/max~22 vs the 30 budget).
    (z, s, lam, nu, mu, done, done_iter, _) = jax.lax.while_loop(
        lambda c: (~jnp.all(c[5])) & (c[7] < iters),
        lambda c: step(c, None)[0],
        (z0, s, lam, nu, mu, done0, di0, jnp.asarray(0, jnp.int32)),
    )
    res = kkt_res(z, s, lam, nu)
    return IPMSolution(
        z=z,
        lam=lam,
        nu=nu,
        s=s,
        converged=res < tol * GRADE_QP,
        kkt_res=res,
        # real per-problem Newton-iteration counts (first pass under tol) —
        # "solver iters/s", a BASELINE.md metric, is computed from these
        iterations=jnp.where(done_iter < 0, iters, done_iter),
    )


# ---------------------------------------------------------------------------
# Stage-structured (Riccati) KKT path: the survey's horizon-parallel
# factorization (SURVEY §5.7).  The KKT system of the tracking OCP is
# block-tridiagonal in the stage index; with stage-local inequality rows
# (input box, per-stage state bounds) the barrier term keeps it block-
# tridiagonal, so every IPM Newton step is ONE TV-LQR Riccati sweep —
# O(N n^3) time and O(N) memory per iteration, vs the dense condensed
# path's O((N m)^3) factorization over an O(N^2) matrix.
# ---------------------------------------------------------------------------


@partial(numerics.jit, static_argnames=("num_horizon", "iters", "stage_parallel"))
def solve_ocp_qp(
    A: jax.Array,  # (n, n) LTI dynamics
    B: jax.Array,  # (n, m)
    Q: jax.Array,  # (n, n) state tracking weight
    R: jax.Array,  # (m, m) input weight
    x0: jax.Array,  # (n,)
    xtarget: jax.Array,  # (n,)
    u_min: jax.Array,  # (m,)
    u_max: jax.Array,  # (m,)
    v_min: jax.Array,  # () bound on state component 0, stages 1..N
    v_max: jax.Array,
    ey_bound: jax.Array,  # () |x_5| <= ey_bound, stages 1..N
    U0: jax.Array,  # (N, m) warm start
    num_horizon: int = 10,
    iters: int = 30,
    tol: float | None = None,
    stage_parallel: bool = False,
) -> tuple[jax.Array, jax.Array, IPMSolution]:
    """Tracking-OCP QP via the stage-structured KKT path.

    Solves exactly the problem of :func:`car_racing_tpu.models.controllers.
    mpc_lti` — cost sum_k (x_k - xt)' Q (x_k - xt) + u_k' R u_k, LTI
    dynamics, input box, vx/ey bounds on stages 1..N — but each primal-dual
    Newton step is computed by a Riccati recursion (ops/riccati.py
    tvlqr_backward) on the barrier-augmented stage costs instead of
    factorizing the densely condensed system.  The dynamics stay exactly
    feasible throughout: (X, U) starts on a rollout and the LTI Newton
    directions preserve the equalities for any step length.

    ``stage_parallel=True`` swaps both halves of the Newton step for the
    associative-scan forms (riccati.tvlqr_backward_parallel /
    tvlqr_rollout_parallel): sequential depth O(log N) instead of O(N)
    per IPM iteration — SURVEY §5.7's horizon-PARALLEL factorization.
    Same solution to solver precision (parity: tests/test_ipm.py).

    Returns (U (N, m), X (N+1, n), IPMSolution with z = U.ravel()).
    """
    from . import riccati

    N = num_horizon
    n = A.shape[0]
    m = B.shape[1]
    dtype = x0.dtype
    if tol is None:
        tol = 1e-8 if dtype == jnp.float64 else 1e-3
    eps_div, mu_floor = _eps_for(dtype)
    tau = 0.995
    e0 = jnp.zeros(n, dtype).at[0].set(1.0)
    e5 = jnp.zeros(n, dtype).at[5].set(1.0)

    def rollout(U):
        def body(x, u):
            xn = A @ x + B @ u
            return xn, xn

        _, X1 = jax.lax.scan(body, x0, U)
        return jnp.concatenate([x0[None], X1], axis=0)  # (N+1, n)

    def c_of(X, U):
        """Stage-grouped inequality values, each (N, ...) >= 0 when feasible."""
        Xs = X[1:]  # x_1..x_N
        return (
            U - u_min,  # u lower   (N, m)
            u_max - U,  # u upper   (N, m)
            Xs[:, 0] - v_min,  # vx lower  (N,)
            v_max - Xs[:, 0],  # vx upper  (N,)
            Xs[:, 5] + ey_bound,  # ey lower  (N,)
            ey_bound - Xs[:, 5],  # ey upper  (N,)
        )

    flat = lambda groups: jnp.concatenate([g.reshape(-1) for g in groups])

    def unflat(v):
        o = 0
        out = []
        for sz, shape in ((N * m, (N, m)), (N * m, (N, m)), (N, (N,)), (N, (N,)), (N, (N,)), (N, (N,))):
            out.append(v[o : o + sz].reshape(shape))
            o += sz
        return tuple(out)

    U = U0
    X = rollout(U)
    ci0 = flat(c_of(X, U))
    M = ci0.shape[0]
    s = jnp.maximum(ci0, 1e-2)
    lam = jnp.full((M,), 0.1, dtype) / s
    mu = jnp.asarray(1e-1, dtype)
    reg = jnp.asarray(1e-9 if dtype == jnp.float64 else 1e-7, dtype)
    A_stack = jnp.broadcast_to(A, (N,) + A.shape)
    B_stack = jnp.broadcast_to(B, (N,) + B.shape)

    def kkt_res(X, U, s, lam):
        ci = flat(c_of(X, U))
        l_ulo, l_uhi, l_vlo, l_vhi, l_elo, l_ehi = unflat(lam)
        gL_u = 2.0 * U @ R.T - (l_ulo - l_uhi)  # (N, m)
        # state-gradient part of the Lagrangian enters through the adjoint;
        # an equivalent reduced-gradient check: backpropagate costates.
        gx = 2.0 * (X[1:] - xtarget) @ Q.T
        gx = gx - (l_vlo - l_vhi)[:, None] * e0 - (l_elo - l_ehi)[:, None] * e5

        def body(p_next, inp):
            gxk, gLuk = inp
            p = gxk + A.T @ p_next  # costate p_{k+1}
            gu = gLuk + B.T @ p  # reduced gradient wrt u_k
            return p, gu

        _, gus = jax.lax.scan(
            body, jnp.zeros(n, dtype), (gx, gL_u), reverse=True
        )
        red_grad = gus
        return jnp.max(
            jnp.concatenate(
                [jnp.abs(red_grad).reshape(-1), jnp.abs(ci - s), jnp.abs(s * lam)]
            )
        )

    def step(carry, _):
        X, U, s, lam, mu, done_iter, k = carry
        groups = c_of(X, U)
        ci = flat(groups)
        res = kkt_res(X, U, s, lam)
        converged_now = res < tol
        done_iter = jnp.where(converged_now & (done_iter < 0), k, done_iter)

        sl = jnp.minimum(lam / jnp.maximum(s, eps_div), _sigma_cap(dtype))
        r_bar = (mu - s * lam) / jnp.maximum(s, eps_div) - sl * (ci - s)
        sl_g = unflat(sl)
        r_g = unflat(r_bar)
        lam_g = unflat(lam)

        # barrier-augmented stage costs for the Newton TV-LQR
        luu = 2.0 * R + jax.vmap(jnp.diag)(sl_g[0] + sl_g[1])  # (N, m, m)
        gL_u = 2.0 * U @ R.T - (lam_g[0] - lam_g[1])
        lu = gL_u - (r_g[0] - r_g[1])  # = -g_bar_u

        sx_diag = (sl_g[2] + sl_g[3])[:, None] * e0 + (sl_g[4] + sl_g[5])[:, None] * e5
        lxx_stage = 2.0 * Q + jax.vmap(jnp.diag)(sx_diag)  # (N, n, n) for x_1..x_N
        gL_x = 2.0 * (X[1:] - xtarget) @ Q.T
        gL_x = gL_x - (lam_g[2] - lam_g[3])[:, None] * e0 - (lam_g[4] - lam_g[5])[:, None] * e5
        lx_stage = gL_x - (r_g[2] - r_g[3])[:, None] * e0 - (r_g[4] - r_g[5])[:, None] * e5

        # stage k of tvlqr carries the cost on x_k: x_0 is fixed (dx_0 = 0),
        # x_1..x_{N-1} are interior stages, x_N is the terminal value
        l_x = jnp.concatenate([jnp.zeros((1, n), dtype), lx_stage[: N - 1]], axis=0)
        l_xx = jnp.concatenate([jnp.zeros((1, n, n), dtype), lxx_stage[: N - 1]], axis=0)
        backward = (
            riccati.tvlqr_backward_parallel if stage_parallel
            else riccati.tvlqr_backward
        )
        rollout_fn = (
            riccati.tvlqr_rollout_parallel if stage_parallel
            else riccati.tvlqr_rollout
        )
        ks, Ks = backward(
            A_stack, B_stack, l_x, lu, l_xx, luu, lx_stage[N - 1], lxx_stage[N - 1], reg
        )
        dX, dU = rollout_fn(
            A, B, jnp.zeros(n, dtype), jnp.zeros((N, m), dtype), jnp.zeros((N, n), dtype), ks, Ks
        )

        # J dz per row group
        Jdz = flat((
            dU,
            -dU,
            dX[1:, 0],
            -dX[1:, 0],
            dX[1:, 5],
            -dX[1:, 5],
        ))
        ds = Jdz + (ci - s)
        dlam = r_bar - sl * Jdz

        neg = lambda dv, v: jnp.where(dv < 0, -tau * v / jnp.minimum(dv, -1e-30), jnp.inf)
        a_s = jnp.minimum(1.0, jnp.min(neg(ds, s)))
        a_l = jnp.minimum(1.0, jnp.min(neg(dlam, lam)))

        # non-finite step guard (same containment as the dense solve_qp /
        # solve_qp_batch / solve_qp_nl paths): if the TV-LQR Riccati sweep
        # emits NaN/inf (ill-conditioned barrier-augmented stage cost in
        # f32), freeze the iterate for this step instead of poisoning it —
        # the caller gets the last finite point with converged=False.
        ok = (
            jnp.all(jnp.isfinite(dX))
            & jnp.all(jnp.isfinite(dU))
            & jnp.all(jnp.isfinite(ds))
            & jnp.all(jnp.isfinite(dlam))
        )
        upd = (~converged_now) & ok
        X = jnp.where(upd, X + a_s * dX, X)
        U = jnp.where(upd, U + a_s * dU, U)
        s = jnp.where(upd, s + a_s * ds, s)
        lam = jnp.where(upd, lam + a_l * dlam, lam)
        duality = jnp.sum(s * lam) / M
        mu = jnp.where(upd, jnp.maximum(0.1 * duality, mu_floor), mu)
        return (X, U, s, lam, mu, done_iter, k + 1), None

    init = (X, U, s, lam, mu, jnp.asarray(-1, jnp.int32), jnp.asarray(0, jnp.int32))
    # early exit once converged (iterate frozen -> bitwise identical)
    (X, U, s, lam, mu, done_iter, _) = jax.lax.while_loop(
        lambda c: (c[5] < 0) & (c[6] < iters), lambda c: step(c, None)[0], init
    )

    res = kkt_res(X, U, s, lam)
    sol = IPMSolution(
        z=U.reshape(-1),
        lam=lam,
        nu=jnp.zeros((0,), dtype),
        s=s,
        converged=res < jnp.asarray(tol * GRADE_QP, dtype),
        kkt_res=res,
        iterations=jnp.where(done_iter < 0, iters, done_iter),
    )
    return U, X, sol


# ---------------------------------------------------------------------------
# Mixed-constraint IPM: quadratic objective, explicit linear rows, and
# nonlinear rows whose (values, Jacobian) come from a closed-form callable.
# ---------------------------------------------------------------------------


@partial(numerics.jit, static_argnames=("c_nl", "iters"))
def solve_qp_nl(
    H: jax.Array,
    g: jax.Array,
    C: jax.Array,
    d: jax.Array,
    c_nl: Callable,
    z0: jax.Array,
    *,
    lam0: jax.Array | None = None,
    s0: jax.Array | None = None,
    iters: int = 40,
    tol: float | None = None,
    warm_if: jax.Array | None = None,
    iters_cap: jax.Array | None = None,
) -> IPMSolution:
    """Solve ``min 1/2 z'Hz + g'z  s.t.  Cz >= d,  c_nl(z) >= 0``.

    ``c_nl(z) -> (vals (m2,), jac (m2, n))`` supplies the nonlinear rows
    *with their Jacobian in closed form* — for the CBF controllers this
    replaces jacfwd through the whole constraint closure with a few tiny
    matmuls, cutting the traced graph (and the compile time) by an order
    of magnitude.  Gauss-Newton Hessian (= H, constant PSD).

    ``lam0``/``s0`` enable primal-DUAL warm starting: a primal-only warm
    start re-initializes lam = 0.1/s, which for problems with large penalty
    weights (the 1e4 CBF slack costs) leaves the multipliers ~5 orders of
    magnitude from stationarity — measured: the warm solve stalls at
    kkt_res ~ 1e4 while a cold solve converges.  Passing the previous
    step's (lam, s), pushed away from the boundary, fixes that.

    ``warm_if`` (traced bool, requires lam0/s0) selects AT RUNTIME between
    the warm init above and the cold init (s from the constraint values at
    z0, lam = 0.1/s, mu = 1e-1) — the caller selects z0 itself.  With
    ``iters_cap`` (traced, clamped to the static ``iters``) this merges a
    cold-config and a warm-config solve into ONE traced program: per
    configuration the executed update sequence is bit-identical to the
    corresponding static call, and under vmap mixed batches run one solve
    instead of one per configuration (lax.while_loop's batching rule
    freezes each lane once ITS OWN predicate — convergence or cap —
    fails).  Used by the racing-game tracker's episode-first-cold /
    then-warm protocol (models/controllers._cbf_nlp warm_select).
    """
    if warm_if is not None and (lam0 is None or s0 is None):
        raise ValueError(
            "warm_if selects between the warm (lam0/s0) and cold inits at "
            "runtime — it requires lam0 and s0 to be provided"
        )
    n = H.shape[0]
    m1 = C.shape[0]
    m2 = jax.eval_shape(lambda z: c_nl(z)[0], z0).shape[0]
    m = m1 + m2
    dtype = H.dtype
    if tol is None:
        tol = 1e-8 if dtype == jnp.float64 else 1e-3
    eps_div, mu_floor = _eps_for(dtype)
    tau = 0.995

    def eval_c(z):
        vals_nl, jac_nl = c_nl(z)
        ci = jnp.concatenate([C @ z - d, vals_nl])
        Ji = jnp.concatenate([C, jac_nl], axis=0)
        return ci, Ji

    ci0, _ = eval_c(z0)
    s_cold = jnp.maximum(ci0, 1e-2)
    lam_cold = jnp.full((m,), 0.1, dtype) / s_cold
    mu_cold = jnp.asarray(1e-1, dtype)
    if lam0 is None:
        s, lam, mu = s_cold, lam_cold, mu_cold
    else:
        s = jnp.maximum(s0, 1e-3)
        lam = jnp.maximum(lam0, 1e-3)
        mu = jnp.maximum(jnp.sum(s * lam) / m, mu_floor)
        if warm_if is not None:
            # runtime cold/warm selection; the cold triple comes from the
            # caller-selected z0, which the caller set to ITS cold z0 on
            # the cold side — identical to the lam0-is-None path there
            s = jnp.where(warm_if, s, s_cold)
            lam = jnp.where(warm_if, lam, lam_cold)
            mu = jnp.where(warm_if, mu, mu_cold)

    def step(carry, _):
        z, s, lam, mu, done, done_iter, k = carry
        ci, Ji = eval_c(z)
        gL = H @ z + g - Ji.T @ lam
        res = jnp.max(
            jnp.concatenate([jnp.abs(gL), jnp.abs(ci - s), jnp.abs(s * lam)])
        )
        done = done | (res < tol)
        done_iter = jnp.where(done & (done_iter < 0), k, done_iter)

        sl = jnp.minimum(lam / jnp.maximum(s, eps_div), _sigma_cap(dtype))
        r_bar = (mu - s * lam) / jnp.maximum(s, eps_div) - sl * (ci - s)
        Hbar = H + (Ji.T * sl) @ Ji + 1e-9 * jnp.eye(n, dtype=dtype)
        g_bar = -gL + Ji.T @ r_bar
        # Hbar is SPD (convex QP Hessian + sl-weighted Gram + ridge):
        # Cholesky instead of pivoted LU, whose pivoting serializes.
        dz = jax.scipy.linalg.cho_solve(
            (jnp.linalg.cholesky(Hbar), True), g_bar[:, None]
        )[:, 0]
        ds = Ji @ dz + (ci - s)
        dlam = r_bar - sl * (Ji @ dz)

        neg = lambda dv, v: jnp.where(dv < 0, -tau * v / jnp.minimum(dv, -1e-30), jnp.inf)
        a_s = jnp.minimum(1.0, jnp.min(neg(ds, s)))
        a_l = jnp.minimum(1.0, jnp.min(neg(dlam, lam)))

        # non-finite step guard: an ill-conditioned Newton system (f32 +
        # degree-6 constraint Gram at extreme iterates) can emit NaN; skip
        # the step instead of poisoning the iterate — the caller still gets
        # the best finite point found.
        ok = (
            jnp.all(jnp.isfinite(dz))
            & jnp.all(jnp.isfinite(ds))
            & jnp.all(jnp.isfinite(dlam))
        )
        upd = (~done) & ok
        z = jnp.where(upd, z + a_s * dz, z)
        s = jnp.where(upd, s + a_s * ds, s)
        lam = jnp.where(upd, lam + a_l * dlam, lam)
        # slack reset onto strictly-feasible constraints (see solve())
        ci_new, _ = eval_c(z)
        s = jnp.where(upd & (ci_new > 1e-12), ci_new, s)
        duality = jnp.sum(s * lam) / m
        mu = jnp.where(upd, jnp.maximum(0.2 * duality, mu_floor), mu)
        return (z, s, lam, mu, done, done_iter, k + 1), None

    # early exit once converged: the iterate is frozen (upd masks), so this
    # is bitwise identical to running the remaining budget
    cap = (
        jnp.asarray(iters, jnp.int32)
        if iters_cap is None
        else jnp.minimum(jnp.asarray(iters_cap, jnp.int32), iters)
    )
    (z, s, lam, mu, done, done_iter, _) = jax.lax.while_loop(
        lambda c: (~c[4]) & (c[6] < cap),
        lambda c: step(c, None)[0],
        (z0, s, lam, mu, jnp.asarray(False), jnp.asarray(-1, jnp.int32),
         jnp.asarray(0, jnp.int32)),
    )
    ci, Ji = eval_c(z)
    gL = H @ z + g - Ji.T @ lam
    res = jnp.max(jnp.concatenate([jnp.abs(gL), jnp.abs(ci - s), jnp.abs(s * lam)]))
    return IPMSolution(
        z=z,
        lam=lam,
        nu=jnp.zeros((0,), dtype),
        s=s,
        converged=res < tol * GRADE_NL,
        kkt_res=res,
        # real Newton-iteration count (first pass under tol; = the cap when
        # the budget was exhausted) — feeds the cbf_newton_iters_per_s
        # BASELINE metric; never a constant fill
        iterations=jnp.where(done_iter < 0, cap, done_iter),
    )
