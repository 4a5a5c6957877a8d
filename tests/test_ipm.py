"""Solver-core tests: KKT residuals and parity with scipy reference solves.

These are the 'IPOPT-gap' checks from SURVEY §4/§6: the interior-point core
must match an independent high-accuracy solver within tight tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.optimize

from car_racing_tpu.ops import ipm


def random_qp(key, n=12, m=20, p=3):
    rng = np.random.default_rng(key)
    L = rng.normal(size=(n, n))
    H = L @ L.T + n * np.eye(n)
    g = rng.normal(size=n)
    x_feas = rng.normal(size=n)  # one point strictly feasible for everything
    C = rng.normal(size=(m, n))
    d = C @ x_feas - rng.uniform(0.1, 1.0, size=m)
    E = rng.normal(size=(p, n))
    e = E @ x_feas
    qp = ipm.QP(
        H=jnp.asarray(H),
        g=jnp.asarray(g),
        C=jnp.asarray(C),
        d=jnp.asarray(d),
        E=jnp.asarray(E),
        e=jnp.asarray(e),
    )
    return qp, x_feas


def scipy_qp_solution(qp, x_feas):
    H, g = np.asarray(qp.H), np.asarray(qp.g)
    C, d = np.asarray(qp.C), np.asarray(qp.d)
    E, e = np.asarray(qp.E), np.asarray(qp.e)
    cons = [scipy.optimize.LinearConstraint(C, d, np.inf)]
    if E.shape[0]:
        cons.append(scipy.optimize.LinearConstraint(E, e, e))
    res = scipy.optimize.minimize(
        lambda z: 0.5 * z @ H @ z + g @ z,
        x_feas,
        jac=lambda z: H @ z + g,
        hess=lambda z: H,
        constraints=cons,
        method="trust-constr",
        options=dict(maxiter=2000, gtol=1e-12, xtol=1e-14),
    )
    assert res.success or res.status in (1, 2), res.message
    return res.x


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_qp_matches_scipy(seed):
    qp, x_feas = random_qp(seed)
    sol = ipm.solve_qp(qp, jnp.zeros(qp.H.shape[0]), iters=40)
    z_ref = scipy_qp_solution(qp, x_feas)
    assert bool(sol.converged), float(sol.kkt_res)
    obj = lambda z: 0.5 * z @ np.asarray(qp.H) @ z + np.asarray(qp.g) @ z
    # optimality gap within IPOPT-like tolerance
    assert obj(np.asarray(sol.z)) <= obj(z_ref) + 1e-6
    np.testing.assert_allclose(np.asarray(sol.z), z_ref, atol=1e-5)
    # feasibility
    assert np.min(np.asarray(qp.C) @ np.asarray(sol.z) - np.asarray(qp.d)) > -1e-8
    np.testing.assert_allclose(
        np.asarray(qp.E) @ np.asarray(sol.z), np.asarray(qp.e), atol=1e-8
    )


def test_qp_no_equalities():
    rng = np.random.default_rng(42)
    n = 8
    H = jnp.eye(n) * 2.0
    g = jnp.asarray(rng.normal(size=n))
    C = jnp.eye(n)
    d = jnp.full(n, -0.3)  # z >= -0.3
    qp = ipm.QP(H=H, g=g, C=C, d=d, E=jnp.zeros((0, n)), e=jnp.zeros(0))
    sol = ipm.solve_qp(qp, jnp.zeros(n), iters=30)
    # analytic: z = clip(-g/2, -0.3, inf)
    z_ref = np.maximum(-np.asarray(g) / 2.0, -0.3)
    np.testing.assert_allclose(np.asarray(sol.z), z_ref, atol=1e-6)


def test_qp_vmap_batch():
    pairs = [random_qp(s, p=0) for s in range(8)]
    qps = [q for q, _ in pairs]
    batch = jax.tree.map(lambda *xs: jnp.stack(xs), *qps)
    z0 = jnp.zeros((8, qps[0].H.shape[0]))
    sols = jax.vmap(lambda q, z: ipm.solve_qp(q, z, iters=40))(batch, z0)
    for i, (qp, x_feas) in enumerate(pairs):
        z_ref = scipy_qp_solution(qp, x_feas)
        np.testing.assert_allclose(np.asarray(sols.z[i]), z_ref, atol=1e-5)


def test_nlp_nonlinear_constraint():
    """min (x-2)^2 + (y-1)^2  s.t.  x^2 + y^2 <= 1  -> solution on circle."""

    def f(z):
        return (z[0] - 2.0) ** 2 + (z[1] - 1.0) ** 2

    def c(z):
        return jnp.array([1.0 - z[0] ** 2 - z[1] ** 2])

    sol = ipm.solve(f, c, jnp.zeros(2), iters=50)
    z_ref = np.array([2.0, 1.0]) / np.sqrt(5.0)
    np.testing.assert_allclose(np.asarray(sol.z), z_ref, atol=1e-6)
    assert bool(sol.converged)


def test_nlp_with_equality():
    """min x^2 + y^2 s.t. x + y = 1, x >= 0.3 -> (0.5, 0.5) inactive ineq."""

    def f(z):
        return z[0] ** 2 + z[1] ** 2

    def ci(z):
        return jnp.array([z[0] - 0.3])

    def ce(z):
        return jnp.array([z[0] + z[1] - 1.0])

    sol = ipm.solve(f, ci, jnp.asarray([0.6, 0.6]), c_eq=ce, iters=50)
    np.testing.assert_allclose(np.asarray(sol.z), [0.5, 0.5], atol=1e-6)


def test_nlp_degree6_barrier():
    """CBF-shaped degree-6 constraints (the mpccbf problem's hard part)."""
    c = lambda z: jnp.array([(z[0] / 0.6) ** 6 + (z[1] / 0.3) ** 6 - 1.0])

    # active case: target inside the superellipse -> boundary point (0.6, 0)
    f_in = lambda z: jnp.sum((z - jnp.asarray([0.1, 0.0])) ** 2)
    sol = ipm.solve(f_in, c, jnp.asarray([2.0, 0.5]), iters=40)
    z = np.asarray(sol.z)
    assert bool(sol.converged), float(sol.kkt_res)
    assert (z[0] / 0.6) ** 6 + (z[1] / 0.3) ** 6 >= 1.0 - 1e-6
    assert z[0] == pytest.approx(0.6, abs=1e-4)
    assert abs(z[1]) < 1e-3

    # inactive case: target outside -> unconstrained optimum (1, 0)
    f_out = lambda z: jnp.sum((z - jnp.asarray([1.0, 0.0])) ** 2)
    sol = ipm.solve(f_out, c, jnp.asarray([2.0, 0.5]), iters=40)
    np.testing.assert_allclose(np.asarray(sol.z), [1.0, 0.0], atol=1e-5)


def test_riccati_kkt_matches_dense():
    """The stage-structured (Riccati) KKT path must reproduce the dense
    condensed path's solution on the tracking QP — the survey's §5.7
    horizon-structured factorization, validated at machine precision."""
    from car_racing_tpu.models import controllers
    from car_racing_tpu.utils import params

    p = params.MPCParam.default(vt=0.8)
    sysp = params.SystemParam.default()
    rng = np.random.default_rng(0)
    for _ in range(4):
        x = jnp.asarray(np.array([0.5, 0, 0, 0, 1.0, 0.1]) + 0.2 * rng.standard_normal(6))
        xt = jnp.asarray([0.8, 0, 0, 0, 0, 0.0])
        w = jnp.asarray(0.8)
        u_d, U_d, X_d = controllers.mpc_lti(x, xt, p, sysp, w, return_traj=True, kkt="dense")
        u_r, U_r, X_r = controllers.mpc_lti(x, xt, p, sysp, w, return_traj=True, kkt="riccati")
        np.testing.assert_allclose(np.asarray(U_r), np.asarray(U_d), atol=1e-9)
        np.testing.assert_allclose(np.asarray(X_r), np.asarray(X_d), atol=1e-9)


def test_riccati_kkt_long_horizon_feasible():
    """At iLQR-scale horizons (N = 50) the Riccati path must stay exact:
    solution satisfies bounds and dynamics, KKT residual converges."""
    from car_racing_tpu.ops import ipm as ipm_mod
    from car_racing_tpu.utils import params

    p = params.MPCParam.default(vt=0.8)
    sysp = params.SystemParam.default()
    N = 50
    x = jnp.asarray([0.4, 0, 0, 0, 0.5, 0.2])
    xt = jnp.asarray([0.8, 0, 0, 0, 0, 0.0])
    u_min = jnp.stack([-sysp.delta_max, -sysp.a_max])
    u_max = jnp.stack([sysp.delta_max, sysp.a_max])
    U, X, sol = ipm_mod.solve_ocp_qp(
        p.A, p.B, p.Q, p.R, x, xt, u_min, u_max, sysp.v_min, sysp.v_max,
        jnp.asarray(0.8), jnp.zeros((N, 2)), num_horizon=N, iters=40,
    )
    U, X = np.asarray(U), np.asarray(X)
    assert bool(sol.converged), float(sol.kkt_res)
    # dynamics exactly feasible by construction
    A, B = np.asarray(p.A), np.asarray(p.B)
    for k in range(N):
        np.testing.assert_allclose(X[k + 1], A @ X[k] + B @ U[k], atol=1e-10)
    assert (U[:, 0] >= -0.5 - 1e-8).all() and (U[:, 0] <= 0.5 + 1e-8).all()
    assert (np.abs(X[1:, 5]) <= 0.8 + 1e-6).all()


def test_convergence_grading_bands():
    """The converged flag follows the documented two-band contract
    (ipm.GRADE_QP for the convex QP family, ipm.GRADE_NL for the nonlinear
    family): conv == (kkt_res < GRADE * tol), flipping exactly at the
    boundary when tol is swept across the achieved residual."""
    from car_racing_tpu.ops import ipm as ipm_mod

    # a tiny strictly-convex QP the solver polishes to ~machine precision
    n = 4
    H = jnp.eye(n) * 2.0
    g = jnp.asarray([1.0, -2.0, 0.5, 0.0])
    C = jnp.eye(n)
    d = -jnp.ones(n)
    qp = ipm_mod.QP(H=H, g=g, C=C, d=d, E=jnp.zeros((0, n)), e=jnp.zeros(0))
    z0 = jnp.zeros(n)

    sol = ipm_mod.solve_qp(qp, z0, iters=30)
    assert bool(sol.converged)

    # boundary probe: with iters=0 the reported residual is r(z0), fixed
    # regardless of tol, so the flag must flip exactly at the band edge
    r0 = float(ipm_mod.solve_qp(qp, z0, iters=0).kkt_res)
    loose = ipm_mod.solve_qp(qp, z0, iters=0, tol=r0 * 2 / ipm_mod.GRADE_QP)
    tight = ipm_mod.solve_qp(qp, z0, iters=0, tol=r0 * 0.5 / ipm_mod.GRADE_QP)
    assert bool(loose.converged)
    assert not bool(tight.converged)

    # nonlinear family: same probe through solve_qp_nl (trivial nl row)
    c_nl = lambda z: (jnp.sum(z) + 10.0 - jnp.zeros(1), jnp.ones((1, n)))
    soln = ipm_mod.solve_qp_nl(H, g, C, d, c_nl, z0, iters=30)
    assert bool(soln.converged)
    r0n = float(ipm_mod.solve_qp_nl(H, g, C, d, c_nl, z0, iters=0).kkt_res)
    loose = ipm_mod.solve_qp_nl(H, g, C, d, c_nl, z0, iters=0,
                                tol=r0n * 2 / ipm_mod.GRADE_NL)
    tight = ipm_mod.solve_qp_nl(H, g, C, d, c_nl, z0, iters=0,
                                tol=r0n * 0.5 / ipm_mod.GRADE_NL)
    assert bool(loose.converged)
    assert not bool(tight.converged)

    # batched path grades per problem with the same band
    qpb = jax.tree.map(lambda a: jnp.stack([a, a]), qp)
    solb = ipm_mod.solve_qp_batch(qpb, jnp.zeros((2, n)), iters=30)
    assert np.asarray(solb.converged).all()
    r0b = float(np.asarray(ipm_mod.solve_qp_batch(qpb, jnp.zeros((2, n)), iters=0).kkt_res).max())
    tightb = ipm_mod.solve_qp_batch(
        qpb, jnp.zeros((2, n)), iters=0, tol=r0b * 0.5 / ipm_mod.GRADE_QP
    )
    assert not np.asarray(tightb.converged).any()


def test_parallel_riccati_matches_sequential():
    """The associative-scan backward pass and affine rollout
    (riccati.tvlqr_backward_parallel / tvlqr_rollout_parallel — SURVEY
    §5.7's horizon-PARALLEL factorization, O(log N) depth) must reproduce
    the sequential Riccati recursions on random time-varying systems."""
    from car_racing_tpu.ops import riccati

    rng = np.random.default_rng(3)
    for N in (1, 2, 7, 50):
        n, m = 6, 2
        fx = jnp.asarray(np.eye(n) + 0.05 * rng.normal(size=(N, n, n)))
        fu = jnp.asarray(0.3 * rng.normal(size=(N, n, m)))
        lx = jnp.asarray(rng.normal(size=(N, n)))
        lu = jnp.asarray(rng.normal(size=(N, m)))

        def spd(sz):
            X = rng.normal(size=(N, sz, sz))
            return jnp.asarray(np.einsum("nij,nkj->nik", X, X) + 2 * np.eye(sz))

        lxx, luu = spd(n), spd(m)
        VxT = jnp.asarray(rng.normal(size=n))
        VxxT = np.einsum("ij,kj->ik", *(2 * [rng.normal(size=(n, n))])) + 2 * np.eye(n)
        VxxT = jnp.asarray(VxxT)
        reg = jnp.asarray(1e-9)
        k1, K1 = riccati.tvlqr_backward(fx, fu, lx, lu, lxx, luu, VxT, VxxT, reg)
        k2, K2 = riccati.tvlqr_backward_parallel(fx, fu, lx, lu, lxx, luu, VxT, VxxT, reg)
        np.testing.assert_allclose(np.asarray(k2), np.asarray(k1), atol=1e-8)
        np.testing.assert_allclose(np.asarray(K2), np.asarray(K1), atol=1e-8)

        A = jnp.asarray(np.eye(n) + 0.05 * rng.normal(size=(n, n)))
        B = jnp.asarray(0.3 * rng.normal(size=(n, m)))
        x0 = jnp.asarray(rng.normal(size=n))
        u_ref = jnp.asarray(rng.normal(size=(N, m)))
        x_ref = jnp.asarray(rng.normal(size=(N, n)))
        xs1, us1 = riccati.tvlqr_rollout(A, B, x0, u_ref, x_ref, k1, K1)
        xs2, us2 = riccati.tvlqr_rollout_parallel(A, B, x0, u_ref, x_ref, k1, K1)
        np.testing.assert_allclose(np.asarray(xs2), np.asarray(xs1), atol=1e-10)
        np.testing.assert_allclose(np.asarray(us2), np.asarray(us1), atol=1e-10)


def test_stage_parallel_ocp_matches_sequential():
    """solve_ocp_qp(stage_parallel=True) — every IPM Newton step computed
    by associative scans — must land on the same solution as the
    sequential Riccati path AND the dense condensed path."""
    from car_racing_tpu.models import controllers
    from car_racing_tpu.ops import ipm as ipm_mod
    from car_racing_tpu.utils import params

    p = params.MPCParam.default(vt=0.8)
    sysp = params.SystemParam.default()
    u_min = jnp.stack([-sysp.delta_max, -sysp.a_max])
    u_max = jnp.stack([sysp.delta_max, sysp.a_max])
    rng = np.random.default_rng(1)
    for N in (10, 50):
        x = jnp.asarray(np.array([0.5, 0, 0, 0, 1.0, 0.1]) + 0.1 * rng.standard_normal(6))
        xt = jnp.asarray([0.8, 0, 0, 0, 0, 0.0])
        common = (
            p.A, p.B, p.Q, p.R, x, xt, u_min, u_max, sysp.v_min, sysp.v_max,
            jnp.asarray(0.8), jnp.zeros((N, 2)),
        )
        U_s, X_s, sol_s = ipm_mod.solve_ocp_qp(*common, num_horizon=N, iters=40)
        U_p, X_p, sol_p = ipm_mod.solve_ocp_qp(
            *common, num_horizon=N, iters=40, stage_parallel=True
        )
        assert bool(sol_s.converged) and bool(sol_p.converged)
        np.testing.assert_allclose(np.asarray(U_p), np.asarray(U_s), atol=1e-7)
        np.testing.assert_allclose(np.asarray(X_p), np.asarray(X_s), atol=1e-7)
        if N == p.num_horizon:
            # and against the dense condensed path (same problem)
            u_d, U_d, X_d = controllers.mpc_lti(
                x, xt, p, sysp, jnp.asarray(0.8), return_traj=True, kkt="dense"
            )
            np.testing.assert_allclose(np.asarray(U_p), np.asarray(U_d), atol=1e-6)


def test_nonfinite_newton_step_guard():
    """A Newton step that overflows to non-finite (f32 + extreme equality
    scaling; the production trigger was an accelerator's f32 LU on a degenerate LMPC
    hull block near the lap wrap — 2/40 perturbed learning lanes went NaN
    before the guard, 0/40 after) must FREEZE the iterate at the last
    finite point instead of poisoning it: the caller gets a finite
    warm-start iterate with converged=False and closed loops continue."""
    # x64 is enabled in the test config, but dtypes follow the inputs:
    # all-f32 problem data keeps the whole solve in f32
    if True:
        n, m, p = 4, 2, 2
        f32 = jnp.float32
        H = jnp.eye(n, dtype=f32)
        g = jnp.asarray([1.0, -1.0, 0.5, 0.0], f32)
        C = jnp.eye(n, dtype=f32)[:m]
        d = jnp.full((m,), -10.0, f32)
        # equality rows at 1e30: LU elimination on the bordered KKT
        # overflows f32 -> inf/nan Newton step
        E = jnp.full((p, n), 1e30, f32)
        e = jnp.zeros(p, f32)
        z0 = jnp.asarray([0.1, -0.1, 0.2, 0.3], f32)
        sol = ipm.solve_qp(ipm.QP(H=H, g=g, C=C, d=d, E=E, e=e), z0, iters=10)
        # the guard's contract: every reported field stays FINITE (steps
        # before the overflow may legitimately move the iterate) and the
        # failure is reported via converged=False
        assert bool(jnp.isfinite(sol.z).all())
        assert bool(jnp.isfinite(sol.lam).all()) and bool(jnp.isfinite(sol.s).all())
        assert bool(jnp.isfinite(sol.kkt_res))
        assert not bool(sol.converged)

        # batched variant: one poisoned problem must not affect neighbors
        E_ok = jnp.zeros((p, n), f32).at[:, :p].set(jnp.eye(p, dtype=f32))
        qp_b = ipm.QP(
            H=jnp.stack([H, H]), g=jnp.stack([g, g]), C=jnp.stack([C, C]),
            d=jnp.stack([d, d]), E=jnp.stack([E_ok, E]), e=jnp.stack([e, e]),
        )
        solb = ipm.solve_qp_batch(qp_b, jnp.stack([z0, z0]), iters=10)
        assert bool(jnp.isfinite(solb.z).all())
        assert bool(solb.converged[0]), "healthy problem must still converge"
        assert not bool(solb.converged[1])


def test_nonfinite_guard_ocp_qp():
    """The Riccati-KKT path (solve_ocp_qp) has the same freeze-don't-poison
    contract as its dense siblings: a TV-LQR sweep
    that overflows f32 to inf/NaN must leave the reported iterate at the
    last finite point with converged=False, never NaN."""
    n, m, N = 6, 2, 6
    f32 = jnp.float32
    A = jnp.eye(n, dtype=f32)
    B = jnp.zeros((n, m), f32).at[0, 0].set(1.0).at[1, 1].set(1.0)
    # R at 3e38 keeps the reduced-gradient residual finite in f32 (U
    # starts at 0) but overflows luu = 2R -> inf inside the TV-LQR
    # backward sweep, so the Newton direction goes non-finite on the
    # very first iteration (verified: without the guard U/X come back NaN)
    Q = jnp.eye(n, dtype=f32)
    R = (3e38 * jnp.eye(m)).astype(f32)
    x0 = jnp.asarray([0.5, 0, 0, 0, 0, 0.1], f32)
    xt = jnp.asarray([0.8, 0, 0, 0, 0, 0.0], f32)
    U, X, sol = ipm.solve_ocp_qp(
        A, B, Q, R, x0, xt,
        jnp.asarray([-0.5, -1.0], f32), jnp.asarray([0.5, 1.0], f32),
        jnp.asarray(-10.0, f32), jnp.asarray(10.0, f32), jnp.asarray(0.8, f32),
        jnp.zeros((N, m), f32), num_horizon=N, iters=10,
    )
    assert bool(jnp.isfinite(U).all()), "guard must freeze, not poison, U"
    assert bool(jnp.isfinite(X).all())
    assert bool(jnp.isfinite(sol.s).all()) and bool(jnp.isfinite(sol.lam).all())
    assert not bool(sol.converged)

    # the stage-parallel variant shares the guard
    U_p, X_p, sol_p = ipm.solve_ocp_qp(
        A, B, Q, R, x0, xt,
        jnp.asarray([-0.5, -1.0], f32), jnp.asarray([0.5, 1.0], f32),
        jnp.asarray(-10.0, f32), jnp.asarray(10.0, f32), jnp.asarray(0.8, f32),
        jnp.zeros((N, m), f32), num_horizon=N, iters=10, stage_parallel=True,
    )
    assert bool(jnp.isfinite(U_p).all()) and bool(jnp.isfinite(X_p).all())
