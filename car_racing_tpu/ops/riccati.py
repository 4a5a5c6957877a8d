"""Riccati recursions: the horizon-structured KKT kernels.

The KKT system of a horizon-N linear-quadratic OCP is block-tridiagonal in
the stage index; its LDL' factorization *is* the discrete Riccati recursion.
These kernels provide:

- :func:`dare_iterate` — the fixed-point discrete algebraic Riccati iteration
  used by the LQR tracking controller (reference control/control.py:39-53),
  as a ``lax.scan`` with convergence freezing.
- :func:`tvlqr_backward` / :func:`tvlqr_rollout` — time-varying LQR backward
  pass and affine rollout; the backbone of the iLQR controller
  (control.py:111-191) and of Riccati-structured KKT solves.

All functions are jittable and vmap cleanly over batches (branches,
scenarios, vehicles).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..utils import numerics


@partial(numerics.jit, static_argnames=("max_iter",))
def dare_iterate(A, B, Q, R, max_iter: int = 50, eps: float = 1e-2):
    """Iterate P <- A'PA - A'PB (R + B'PB)^-1 B'PA + Q from P0 = Q.

    Matches the reference's fixed-point loop (control.py:43-53): stops
    updating once max |P_next - P| < eps, runs a fixed max_iter schedule.
    Returns (P, K) with K = (R + B'PB)^-1 B'PA.
    """

    def body(carry, _):
        P, done = carry
        BtP = B.T @ P
        K = jnp.linalg.solve(R + BtP @ B, BtP @ A)
        P_next = A.T @ P @ A - (A.T @ P @ B) @ K + Q
        done_next = done | (jnp.max(jnp.abs(P_next - P)) < eps)
        P = jnp.where(done, P, P_next)
        return (P, done_next), None

    (P, _), _ = jax.lax.scan(body, (Q, jnp.asarray(False)), None, length=max_iter)
    BtP = B.T @ P
    K = jnp.linalg.solve(R + BtP @ B, BtP @ A)
    return P, K


def sym2x2_clamped_inv(M, reg):
    """Inverse of a symmetric 2x2 matrix with eigenvalues clamped to
    ``max(w, 0) + reg`` — closed form via the rotation angle.

    For ``M = [[a, b], [b, c]]`` the eigenpairs are ``m ± r`` with
    ``m = (a+c)/2``, ``r = hypot((a-c)/2, b)`` and eigenvector angle
    ``theta = atan2(2b, a-c)/2`` (smooth at b = 0).  This replaces
    ``jnp.linalg.eigh`` — whose iterative lowering dominated both compile
    time for the iLQR nested scans and runtime — with a handful of fused
    elementwise ops."""
    a, b, c = M[0, 0], 0.5 * (M[0, 1] + M[1, 0]), M[1, 1]
    m = 0.5 * (a + c)
    r = jnp.hypot(0.5 * (a - c), b)
    theta = 0.5 * jnp.arctan2(2.0 * b, a - c)
    ct, st = jnp.cos(theta), jnp.sin(theta)
    w_hi = jnp.maximum(m + r, 0.0) + reg  # eigvec [ct, st]
    w_lo = jnp.maximum(m - r, 0.0) + reg  # eigvec [-st, ct]
    i_hi, i_lo = 1.0 / w_hi, 1.0 / w_lo
    return jnp.array(
        [
            [i_hi * ct * ct + i_lo * st * st, (i_hi - i_lo) * ct * st],
            [(i_hi - i_lo) * ct * st, i_hi * st * st + i_lo * ct * ct],
        ],
        dtype=M.dtype,
    )


def _clamped_inv(M, reg):
    """Eigenvalue-clamped inverse: closed form for 2x2, eigh otherwise."""
    if M.shape == (2, 2):
        return sym2x2_clamped_inv(M, reg)
    w, V = jnp.linalg.eigh(0.5 * (M + M.T))
    w = jnp.maximum(w, 0.0) + reg
    return (V * (1.0 / w)) @ V.T


def tvlqr_backward(f_x, f_u, l_x, l_u, l_xx, l_uu, Vx_T, Vxx_T, reg: jax.Array):
    """TV-LQR backward pass over a horizon (one ``lax.scan``).

    Args (all stage-stacked, length N on the leading axis unless noted):
      f_x: (N, n, n) dynamics state Jacobians
      f_u: (N, n, m) dynamics input Jacobians
      l_x, l_u: (N, n), (N, m) cost gradients
      l_xx, l_uu: (N, n, n), (N, m, m) cost Hessians
      Vx_T, Vxx_T: terminal value gradient/Hessian
      reg: Levenberg regularization added to Quu's clamped eigenvalues
           (reference control.py:155-158).

    Returns (k, K): feedforward (N, m) and feedback (N, m, n) gains.
    """

    def body(carry, inp):
        Vx, Vxx = carry
        fx, fu, lx, lu, lxx, luu = inp
        Qx = lx + fx.T @ Vx
        Qu = lu + fu.T @ Vx
        Qxx = lxx + fx.T @ Vxx @ fx
        Quu = luu + fu.T @ Vxx @ fu
        Qux = fu.T @ Vxx @ fx
        # eigenvalue-clamped regularized inverse (control.py:155-158)
        Quu_inv = _clamped_inv(0.5 * (Quu + Quu.T), reg)
        k = -Quu_inv @ Qu
        K = -Quu_inv @ Qux
        Vx_new = Qx - K.T @ Quu @ k
        Vxx_new = Qxx - K.T @ Quu @ K
        return (Vx_new, Vxx_new), (k, K)

    (_, _), (ks, Ks) = jax.lax.scan(
        body, (Vx_T, Vxx_T), (f_x, f_u, l_x, l_u, l_xx, l_uu), reverse=True
    )
    return ks, Ks


def tvlqr_rollout(A, B, x0, u_ref, x_ref, ks, Ks):
    """Affine rollout u = u_ref + k + K (x - x_ref) through x+ = Ax + Bu.

    A, B may be (n, n)/(n, m) LTI or (N, ...) stacked TV.
    Returns (xs (N+1, n), us (N, m)).
    """
    N = ks.shape[0]
    if A.ndim == 2:
        A = jnp.broadcast_to(A, (N,) + A.shape)
        B = jnp.broadcast_to(B, (N,) + B.shape)

    def body(x, inp):
        Ak, Bk, uk_ref, xk_ref, k, K = inp
        u = uk_ref + k + K @ (x - xk_ref)
        x_next = Ak @ x + Bk @ u
        return x_next, (x, u)

    xT, (xs, us) = jax.lax.scan(body, x0, (A, B, u_ref, x_ref, ks, Ks))
    xs = jnp.concatenate([xs, xT[None]], axis=0)
    return xs, us


# ---------------------------------------------------------------------------
# Temporal-parallel (associative-scan) LQR — SURVEY §5.7's north star: the
# horizon-structured KKT factorization parallelized OVER STAGES, cutting the
# backward pass's sequential depth from O(N) to O(log N).  The per-stage
# matrices are tiny (n=6, m=2) and each sequential scan step costs launch
# latency rather than FLOPs, so depth is exactly what the sequential
# recursion is bound by.
#
# Formulation (public technique: Särkkä & García-Fernández, "Temporal
# Parallelization of Bayesian Smoothers" / parallel LQT, arXiv:1905.13002):
# represent the conditional value function between two stages in dual form
#
#   V_{i,j}(x, y) = sup_l [ l'(y - A x - b) - 1/2 l'C l ] + 1/2 x'J x - e'x
#
# as the element (A, b, C, eta, J).  Two adjacent elements combine by
# minimizing over the shared state — a closed-form quadratic elimination —
# and the combination is ASSOCIATIVE, so all suffix value functions come
# from one jax.lax.associative_scan.  Gains then compute stage-parallel.
# ---------------------------------------------------------------------------


def _lqt_combine(e1, e2):
    """Combine adjacent conditional-value elements (e1 earlier, e2 later).

    Elementwise over a leading batch axis (associative_scan vmaps it)."""
    A1, b1, C1, eta1, J1 = e1
    A2, b2, C2, eta2, J2 = e2
    n = A1.shape[-1]
    I = jnp.eye(n, dtype=A1.dtype)
    # batched matrix-vector: explicit trailing axis (a bare `M @ v` on
    # (B,n,n) @ (B,n) silently mis-broadcasts when B == n)
    mv = lambda M, v: (M @ v[..., None])[..., 0]
    # D = I + C1 J2, shared by every formula; one LU, several solves
    D = I + C1 @ J2
    DiA1 = jnp.linalg.solve(D, A1)
    DiC1 = jnp.linalg.solve(D, C1)
    A12 = A2 @ DiA1
    b12 = mv(A2, jnp.linalg.solve(D, b1[..., None])[..., 0] + mv(DiC1, eta2)) + b2
    C12 = A2 @ DiC1 @ jnp.swapaxes(A2, -1, -2) + C2
    # (I + J2 C1)^{-1} = D^{-T} for symmetric C1, J2
    Dt = I + J2 @ C1
    rhs = (eta2 - mv(J2, b1))[..., None]
    A1T = jnp.swapaxes(A1, -1, -2)
    eta12 = mv(A1T, jnp.linalg.solve(Dt, rhs)[..., 0]) + eta1
    J12 = A1T @ jnp.linalg.solve(Dt, J2) @ A1 + J1
    return (A12, b12, C12, eta12, J12)


def tvlqr_backward_parallel(f_x, f_u, l_x, l_u, l_xx, l_uu, Vx_T, Vxx_T,
                            reg: jax.Array):
    """Associative-scan TV-LQR backward pass — same signature and (for PD
    ``l_uu`` + downstream-convex value functions, the IPM/OCP case) the
    same gains as :func:`tvlqr_backward`, at O(log N) sequential depth.

    Semantics note: the sequential pass applies the eigenvalue-clamped
    ``reg`` inside the value recursion at every stage; here the value
    recursion is exact (clamping is path-dependent and breaks
    associativity) and ``reg`` regularizes only the stage-parallel gain
    computation.  For the convex barrier-augmented Newton systems of
    ops/ipm.solve_ocp_qp the clamp never activates and reg is ~1e-9, so
    the two passes agree to solver precision (asserted in
    tests/test_ipm.py); for nonconvex iLQR Levenberg iterations with
    large ``reg`` use the sequential pass.

    Returns (k, K): feedforward (N, m) and feedback (N, m, n) gains.
    """
    N, n = f_x.shape[0], f_x.shape[1]
    dtype = f_x.dtype

    # stage elements: control eliminated per stage via l_uu^{-1}
    luu_inv_fuT = jnp.linalg.solve(l_uu, jnp.swapaxes(f_u, -1, -2))  # (N, m, n)
    C = f_u @ luu_inv_fuT  # (N, n, n)
    b = -(f_u @ jnp.linalg.solve(l_uu, l_u[..., None]))[..., 0]  # (N, n)
    elems = (
        f_x,
        b,
        C,
        -l_x,  # eta
        l_xx,  # J
    )
    # terminal element: pure value 1/2 x'Vxx x + Vx'x
    zero_n = jnp.zeros((1, n, n), dtype)
    term = (
        zero_n,
        jnp.zeros((1, n), dtype),
        zero_n,
        -Vx_T[None],
        Vxx_T[None],
    )
    elems = jax.tree.map(lambda a, t: jnp.concatenate([a, t], axis=0), elems, term)

    # reverse associative scan: suffix[k] = e_k * e_{k+1} * ... * e_T, so
    # suffix[k+1] carries V_{k+1} — the value the stage-k gains need.
    # reverse=True runs on the flipped sequence, so the operator receives
    # its operands (later, earlier) — swap to keep the combine's
    # (earlier, later) convention
    suffix = jax.lax.associative_scan(
        lambda a, b: _lqt_combine(b, a), elems, reverse=True
    )
    eta_next = suffix[3][1:]  # (N, n)
    J_next = suffix[4][1:]  # (N, n, n)
    Vx_next = -eta_next
    Vxx_next = J_next

    def gains(fx, fu, lu, luu, Vx, Vxx):
        Qu = lu + fu.T @ Vx
        Quu = luu + fu.T @ Vxx @ fu
        Qux = fu.T @ Vxx @ fx
        Quu_inv = _clamped_inv(0.5 * (Quu + Quu.T), reg)
        return -Quu_inv @ Qu, -Quu_inv @ Qux

    return jax.vmap(gains)(f_x, f_u, l_u, l_uu, Vx_next, Vxx_next)


def tvlqr_rollout_parallel(A, B, x0, u_ref, x_ref, ks, Ks):
    """Associative-scan affine rollout — same result as
    :func:`tvlqr_rollout` at O(log N) depth: the closed-loop step
    x+ = (A + B K) x + B (u_ref + k - K x_ref) is an affine map, and
    affine maps compose associatively."""
    N = ks.shape[0]
    if A.ndim == 2:
        A = jnp.broadcast_to(A, (N,) + A.shape)
        B = jnp.broadcast_to(B, (N,) + B.shape)
    M = A + B @ Ks  # (N, n, n)
    v = (B @ (u_ref + ks - (Ks @ x_ref[..., None])[..., 0])[..., None])[..., 0]

    def compose(s1, s2):
        # s1 earlier, s2 later: x -> M2 (M1 x + v1) + v2
        M1, v1 = s1
        M2, v2 = s2
        return (M2 @ M1, (M2 @ v1[..., None])[..., 0] + v2)

    Mp, vp = jax.lax.associative_scan(compose, (M, v))
    xs_tail = (Mp @ x0[..., None])[..., 0] + vp  # x_1..x_N
    xs = jnp.concatenate([x0[None], xs_tail], axis=0)
    us = u_ref + ks + ((Ks @ (xs[:-1] - x_ref)[..., None])[..., 0])
    return xs, us
