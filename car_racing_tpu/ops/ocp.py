"""Condensed optimal-control-problem builders.

Receding-horizon problems over linear (time-varying) dynamics

    x_{k+1} = A_k x_k + B_k u_k + C_k,      k = 0..N-1

are condensed onto the input sequence: with U = [u_0; ...; u_{N-1}],

    X = [x_1; ...; x_N] = Phi(x_0) + G U

where ``Phi`` is the free response (including the affine C_k drift) and ``G``
the block-lower-triangular input map.  All builders run under jit with static
shapes and vmap over batches of problems.

This replaces the CasADi ``Opti`` modelling layer of the reference
(car_racing/control/control.py:204-237,640-696 etc.): a controller describes
its cost/constraints as dense rows over [U] (or [U; extra vars]) and hands
the result to :mod:`car_racing_tpu.ops.ipm`.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..utils.constants import X_DIM


def prediction_matrices(A_seq: jax.Array, B_seq: jax.Array, C_seq: jax.Array, x0: jax.Array):
    """Free response and input map of TV linear dynamics.

    Args:
      A_seq: (N, n, n); B_seq: (N, n, m); C_seq: (N, n); x0: (n,)
    Returns:
      phi: (N, n) with phi[k-1] = free response of x_k (k = 1..N)
      G:   (N, n, N, m) with x_k = phi[k-1] + sum_j G[k-1,:,j,:] @ u_j
    """
    N, n, m = B_seq.shape

    def free_body(x_free, inp):
        A, C = inp
        x_free = A @ x_free + C
        return x_free, x_free

    _, phis = jax.lax.scan(free_body, x0, (A_seq, C_seq))

    # sensitivity of x_{k+1} to u_j: S_j(k) = A_k ... A_{j+1} B_j, built by a
    # masked scan per input index (a select, not a scatter — scatter-in-scan
    # compiles pathologically on some accelerator toolchains)
    def per_input(j):
        Bj = B_seq[j]

        def body(S, inp):
            A, k = inp
            S_next = jnp.where(k == j, Bj, A @ S)
            S_next = jnp.where(k < j, jnp.zeros_like(S_next), S_next)
            return S_next, S_next

        _, Ss = jax.lax.scan(body, jnp.zeros((n, m), x0.dtype), (A_seq, jnp.arange(N)))
        return Ss  # (N, n, m): S at x_{k+1} for k=0..N-1

    G = jax.vmap(per_input)(jnp.arange(N))  # (j, k, n, m)
    G = jnp.transpose(G, (1, 2, 0, 3))  # (k, n, j, m)
    return phis, G


def condense(A_seq, B_seq, C_seq, x0):
    """Flattened prediction matrices: X (N*n) = phi + G @ U (N*m)."""
    phi, G = prediction_matrices(A_seq, B_seq, C_seq, x0)
    N, n, _, m = G.shape
    return phi.reshape(N * n), G.reshape(N * n, N * m)


def condense_lti(A, B, N: int, x0):
    """LTI fast path of :func:`condense` — closed form via matrix powers.

    Avoids the scatter-in-scan pattern of the TV path (which compiles
    pathologically slowly on some accelerator toolchains when vmapped): builds
    P[i] = A^i with one scan, then assembles the block-Toeplitz input map
    G[k, j] = A^(k-1-j) B by gather + mask.  Returns (phi (N*n), G (N*n, N*m)).
    """
    n, m = B.shape

    def body(P, _):
        return A @ P, P

    _, Ps = jax.lax.scan(body, jnp.eye(n, dtype=A.dtype), None, length=N + 1)
    # Ps[i] = A^i, i = 0..N
    phi = jnp.einsum("kij,j->ki", Ps[1:], x0)  # x_k = A^k x0, k=1..N

    k_idx = jnp.arange(N)[:, None]  # block row (x_{k+1})
    j_idx = jnp.arange(N)[None, :]  # input index
    pow_idx = k_idx - j_idx  # A^(k-j) B at block (k, j) for k >= j
    blocks = jnp.einsum("kjab,bc->kjac", Ps[jnp.clip(pow_idx, 0, N)], B)
    blocks = jnp.where((pow_idx >= 0)[:, :, None, None], blocks, 0.0)
    G = jnp.transpose(blocks, (0, 2, 1, 3)).reshape(N * n, N * m)
    return phi.reshape(N * n), G


def lti_sequences(A, B, N, dtype=None):
    """Tile an LTI (A, B) into TV sequences with zero drift."""
    dtype = dtype or A.dtype
    A_seq = jnp.broadcast_to(A, (N,) + A.shape).astype(dtype)
    B_seq = jnp.broadcast_to(B, (N,) + B.shape).astype(dtype)
    C_seq = jnp.zeros((N, A.shape[0]), dtype)
    return A_seq, B_seq, C_seq


def quadratic_tracking_cost(phi, G, Q, R, x_targets, N):
    """H, g of  sum_k (x_k - xt_k)' Q (x_k - xt_k) + u_k' R u_k  over U.

    ``x_targets`` has shape (N, n): target for x_1..x_N (the reference also
    costs x_0 — a constant w.r.t. U, so identical optimizer).
    """
    n = Q.shape[0]
    m = R.shape[0]
    Qbar = jnp.kron(jnp.eye(N, dtype=Q.dtype), Q)
    Rbar = jnp.kron(jnp.eye(N, dtype=R.dtype), R)
    dx = phi - x_targets.reshape(N * n)
    H = 2.0 * (G.T @ Qbar @ G + Rbar)
    g = 2.0 * (G.T @ (Qbar @ dx))
    return H, g


def input_rate_cost(dR, N, u_prev):
    """H, g of  sum_k (u_k - u_{k-1})' dR (u_k - u_{k-1})  with u_{-1}=u_prev
    (the LMPC input-rate cost, control.py:673-681)."""
    m = dR.shape[0]
    D = jnp.eye(N * m, dtype=dR.dtype) - jnp.eye(N * m, k=-m, dtype=dR.dtype)
    dRbar = jnp.kron(jnp.eye(N, dtype=dR.dtype), dR)
    H = 2.0 * D.T @ dRbar @ D
    g = jnp.zeros(N * m, dR.dtype)
    # the u_0 - u_prev term: (u_0 - u_prev)' dR (u_0 - u_prev)
    g = g.at[:m].add(-2.0 * dR @ u_prev)
    return H, g


def input_box_rows(N, m, u_min, u_max, n_z):
    """Rows for u_min <= u_k <= u_max as C z >= d over z whose first N*m
    entries are U."""
    I = jnp.zeros((N * m, n_z)).at[:, : N * m].set(jnp.eye(N * m))
    C = jnp.concatenate([I, -I], axis=0)
    d = jnp.concatenate([jnp.tile(u_min, N), -jnp.tile(u_max, N)])
    return C, d


def state_bound_rows(G, phi, state_idx, lower, upper, n_z):
    """Rows for lower <= x_k[state_idx] <= upper for k = 1..N.

    ``G``/(phi) flattened (N*n, N*m)/(N*n,).  Returns C z >= d rows over z
    whose first N*m entries are U (zeros elsewhere).
    """
    Nn, Nm = G.shape
    n = X_DIM
    N = Nn // n
    sel = jnp.arange(N) * n + state_idx
    Gs = G[sel]  # (N, N*m)
    ps = phi[sel]
    Z = jnp.zeros((N, n_z), G.dtype).at[:, :Nm].set(Gs)
    C = jnp.concatenate([Z, -Z], axis=0)
    d = jnp.concatenate([lower - ps, ps - upper])
    return C, d


def stack_rows(*pairs):
    """Concatenate (C, d) row blocks."""
    Cs, ds = zip(*pairs)
    return jnp.concatenate(Cs, axis=0), jnp.concatenate(ds, axis=0)


def unpack_states(phi, G, U, x0):
    """Recover the state trajectory (N+1, n) from a flat input vector."""
    Nn = phi.shape[0]
    n = X_DIM
    N = Nn // n
    X = (phi + G @ U).reshape(N, n)
    return jnp.concatenate([x0[None, :], X], axis=0)
