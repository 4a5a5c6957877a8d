"""The fused integrator kernel (Pallas interpret mode on CPU) against the
scan, its wrapper's batching and dispatch, and the batched SPD solves
against numpy.  The compiled-kernel checks run on the card
(tests/test_gpu.py)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from car_racing_tpu.ops import dynamics, pallas_kernels, track as track_ops

f32 = jnp.float32


def _spd(rng, B, n):
    L = rng.normal(size=(B, n, n))
    return L @ np.transpose(L, (0, 2, 1)) + n * np.eye(n)


def _track_bike():
    cast = lambda t: jax.tree.map(lambda a: jnp.asarray(a, f32), t)
    return (cast(track_ops.load_track("l_shape", width=1.0)),
            cast(dynamics.BicycleParams.default()))


def _states(rng, lead):
    xc = np.array([0.8, 0.01, 0.02, 0.01, 5.0, 0.05]) + 0.3 * rng.standard_normal(
        lead + (6,)) * np.array([1, 0.1, 0.1, 0.1, 10, 1])
    return (jnp.asarray(rng.standard_normal(lead + (6,)), f32), jnp.asarray(xc, f32),
            jnp.asarray(np.array([0.05, 0.3]) + 0.1 * rng.standard_normal(lead + (2,)), f32))


def test_solve_batched_fallback_cpu():
    rng = np.random.default_rng(1)
    n, B = 12, 8
    A = _spd(rng, B, n)
    b = rng.normal(size=(B, n))
    x = pallas_kernels.solve_batched(jnp.asarray(A), jnp.asarray(b))
    x_ref = np.linalg.solve(A, b[..., None])[..., 0]
    np.testing.assert_allclose(np.asarray(x), x_ref, rtol=1e-8, atol=1e-8)


@pytest.mark.parametrize("n,B", [(20, 256), (40, 256)])
def test_solve_batched_matches_numpy(n, B):
    """The corridor sweep's Newton-system shapes, f64 on the CPU."""
    rng = np.random.default_rng(n)
    A = _spd(rng, B, n)
    b = rng.normal(size=(B, n))
    x = pallas_kernels.solve_batched(jnp.asarray(A), jnp.asarray(b))
    x_ref = np.linalg.solve(A, b[..., None])[..., 0]
    np.testing.assert_allclose(np.asarray(x), x_ref, rtol=1e-8, atol=1e-8)


@pytest.mark.parametrize("n,p,B", [(20, 5, 256), (12, 1, 16)])
def test_solve_multi_batched_matches_numpy(n, p, B):
    """One block-eliminated KKT step: r = 1 + p right-hand sides."""
    rng = np.random.default_rng(2)
    A = _spd(rng, B, n)
    Brhs = rng.normal(size=(B, n, 1 + p))
    x = pallas_kernels.solve_multi_batched(jnp.asarray(A), jnp.asarray(Brhs))
    np.testing.assert_allclose(np.asarray(x), np.linalg.solve(A, Brhs), rtol=1e-8, atol=1e-8)


def test_propagate_fused_matches_scan():
    """The fused integrator kernel (interpret mode on CPU) must track the
    lax.scan reference to ~1e-6 over one control period."""
    track, bike = _track_bike()
    rng = np.random.default_rng(0)
    for _ in range(5):
        xg, xc, u = _states(rng, ())
        xg1, xc1 = dynamics.propagate(track, bike, xg, xc, u, backend="scan")
        xg2, xc2 = pallas_kernels.propagate_fused(track, bike, xg, xc, u, interpret=True)
        np.testing.assert_allclose(np.asarray(xc2), np.asarray(xc1), atol=2e-6)
        np.testing.assert_allclose(np.asarray(xg2), np.asarray(xg1), atol=2e-6)


def test_propagate_fused_negative_vx_matches_scan():
    """Hard-braking / perturbed standing starts with NEGATIVE vx must
    track the scan path's jnp.arctan2 dynamics (the x < 0 quadrant)."""
    track, bike = _track_bike()
    rng = np.random.default_rng(7)
    for _ in range(4):
        xc = jnp.asarray(
            np.array([-0.15, 0.02, 0.05, 0.01, 3.0, 0.05])
            + rng.standard_normal(6) * np.array([0.1, 0.02, 0.05, 0.05, 2.0, 0.1]),
            f32,
        )
        assert float(xc[0]) < 0.0  # the branch under test
        xg = jnp.asarray(rng.standard_normal(6), f32)
        u = jnp.asarray([0.02, -0.5], f32)  # braking
        # short period: backward-rolling dynamics are unstable, so compare
        # before the trajectories exponentially separate from f32 noise
        xg1, xc1 = dynamics.propagate(
            track, bike, xg, xc, u, control_dt=0.02, backend="scan"
        )
        xg2, xc2 = pallas_kernels.propagate_fused(
            track, bike, xg, xc, u, control_dt=0.02, interpret=True
        )
        np.testing.assert_allclose(np.asarray(xc2), np.asarray(xc1), atol=5e-5)
        np.testing.assert_allclose(np.asarray(xg2), np.asarray(xg1), atol=5e-5)


@pytest.mark.parametrize("lead", [(8,), (5,), (2, 3), (130,)])
def test_propagate_fused_vmapped_is_one_kernel(lead):
    """A vmapped fleet (nested vmaps too, and lane counts that are not a
    block multiple) runs as ONE kernel over all lanes and matches the
    vmapped scan lane for lane."""
    track, bike = _track_bike()
    xg, xc, u = _states(np.random.default_rng(3), lead)
    kern = lambda g, c, uu: pallas_kernels.propagate_fused(track, bike, g, c, uu, interpret=True)
    scan = lambda g, c, uu: dynamics.propagate(track, bike, g, c, uu, backend="scan")
    for _ in lead:
        kern, scan = jax.vmap(kern), jax.vmap(scan)
    assert str(jax.make_jaxpr(kern)(xg, xc, u)).count("pallas_call") == 1
    for a, b in zip(jax.jit(kern)(xg, xc, u), scan(xg, xc, u)):
        assert a.shape == lead + (6,)
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=2e-6)


@pytest.mark.parametrize("n,blk", [(1, 16), (16, 16), (17, 32), (64, 64), (300, 128)])
def test_lane_block_choice(n, blk):
    assert pallas_kernels._lane_block(n) == blk


def test_auto_backend_is_the_scan_for_cpu_inputs():
    """``backend="auto"`` picks by the platform the inputs are lowered for:
    CPU inputs get the scan, bit for bit, and no kernel is lowered."""
    track, bike = _track_bike()
    xg, xc, u = _states(np.random.default_rng(4), ())
    auto = dynamics.propagate(track, bike, xg, xc, u)
    scan = dynamics.propagate(track, bike, xg, xc, u, backend="scan")
    for a, b in zip(auto, scan):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert "triton" not in dynamics.propagate.lower(track, bike, xg, xc, u).as_text()


def test_kernel_without_interpret_refuses_the_cpu():
    """No silent interpret fallback: an explicit kernel call lowered for
    the CPU without ``interpret=True`` fails."""
    track, bike = _track_bike()
    xg, xc, u = _states(np.random.default_rng(5), ())
    with pytest.raises(ValueError, match="interpret"):
        dynamics.propagate(track, bike, xg, xc, u, backend="pallas")


def test_unknown_backend_is_rejected():
    track, bike = _track_bike()
    xg, xc, u = _states(np.random.default_rng(6), ())
    with pytest.raises(ValueError, match="backend"):
        dynamics.propagate(track, bike, xg, xc, u, backend="mosaic")
