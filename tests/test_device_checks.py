"""CPU tests of the bounds the GPU tier asserts (``utils/device_checks``):
the per-step replay of the LMPC lap, the racing-lane gate and the matmul
precision probe, each shown to accept the reference and to reject a
known-wrong run.  The rollouts run in f32,
the GPU's dtype, so x64 is off here."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from car_racing_tpu.utils import device_checks as dc


@pytest.fixture(scope="module")
def fx():
    return dc.fixture()


@pytest.fixture(scope="module")
def ref(fx):
    with jax.enable_x64(False):
        return jax.device_get(dc.lmpc_lap(fx, backend="scan", return_carries=True))


@pytest.fixture(autouse=True)
def _f32():
    with jax.enable_x64(False):
        yield


def test_replay_carries_reproduce_the_lap(fx, ref):
    """The carries a lap returns are the states it went through: carry k's
    state is the trajectory's step k."""
    lap = int(ref[3])
    np.testing.assert_array_equal(np.asarray(ref[4][0])[: lap + 1], np.asarray(ref[0])[: lap + 1])
    assert not np.asarray(ref[4][-1])[:lap].any()


@pytest.mark.parametrize("sub_dt,passes", [(0.001, True), (0.002, False)])
def test_replay_gate(fx, ref, sub_dt, passes):
    """Every step of the lap, run again in one batch from its carry: the same
    program passes the gate; the step with half the integrator substeps
    does not."""
    err = dc.lmpc_replay_error(ref, fx, backend="scan", sub_dt=sub_dt)
    assert len(err) == int(ref[3])
    if passes:
        r = dc.check_replay(err, dc.SAME_DEVICE_TOL)
        assert r["median"] < r["median_tol"]
    else:
        with pytest.raises(AssertionError, match="one-step state difference"):
            dc.check_replay(err, dc.SAME_DEVICE_TOL)


def test_check_replay_reads_the_median():
    """A few large steps (unconverged solves) pass; a lap where most steps
    differ does not."""
    err = np.full(100, 1e-6)
    err[:40] = 5e-2
    assert dc.check_replay(err, dc.SAME_DEVICE_TOL)["max"] == pytest.approx(5e-2)
    err[:60] = 5e-2
    with pytest.raises(AssertionError):
        dc.check_replay(err, dc.CROSS_DEVICE_TOL)


def test_racing_lane_gate_rejects_an_off_track_lane(fx):
    """A lane that clears both cars but leaves the 1 m track fails the gate;
    the same lane held on track passes."""
    n = 60
    t = np.arange(n + 1) * 0.1
    xc = np.zeros((n + 1, 6), np.float32)
    xc[:, 0] = 2.0
    xc[:, 4] = 12.0 + 2.0 * t  # far ahead of both prescribed cars
    xc[:, 5] = -0.9
    ot = np.zeros(n, bool)
    ot[5] = True
    r = dc.check_racing_lane(fx, xc, ot, 40, n)
    assert r["lap_steps"] == 40 and r["max_abs_ey"] == pytest.approx(0.9)
    xc[20, 5] = -1.2
    with pytest.raises(AssertionError, match="off track"):
        dc.check_racing_lane(fx, xc, ot, 40, n)


def test_matmul_probe_passes_at_full_f32():
    r = dc.matmul_error()
    assert r["max_rel_err"] < r["rtol"]


def test_matmul_probe_catches_tf32(monkeypatch):
    """Rounding both factors to TF32's 10-bit mantissa, as an H100's tensor
    cores do at default precision, fails the probe."""
    def tf32(x):
        bits = jax.lax.bitcast_convert_type(x, jnp.uint32)
        rounded = (bits + jnp.uint32(0x1000)) & jnp.uint32(0xFFFFE000)
        return jax.lax.bitcast_convert_type(rounded, jnp.float32)

    monkeypatch.setattr(dc.jnp, "matmul", lambda a, b: jnp.dot(tf32(a), tf32(b)))
    with pytest.raises(AssertionError, match="TF32"):
        dc.matmul_error()


def _fleet(laps, starts):
    B = len(laps)
    xc = np.zeros((B, 5, 6), np.float32)
    xc[:, 0] = starts
    return xc, None, None, np.asarray(laps)


def test_compare_fleets_accepts_one_distribution_and_rejects_a_shift():
    rng = np.random.default_rng(0)
    starts = rng.normal(size=(64, 6)).astype(np.float32)
    pool = np.r_[np.full(20, 135), np.full(44, 212)] + rng.integers(-5, 5, 64)
    a = rng.choice(pool, 64)
    b = rng.choice(pool, 64)
    r = dc.compare_fleets(_fleet(a, starts), _fleet(b, starts), starts)
    assert r["ks"] < r["ks_bound"] == pytest.approx(0.3445, abs=1e-3)
    with pytest.raises(AssertionError, match="distributions differ"):
        dc.compare_fleets(_fleet(a, starts), _fleet(b + 30, starts), starts)
    with pytest.raises(AssertionError, match="do not start"):
        dc.compare_fleets(_fleet(a, starts), _fleet(b, starts[::-1]), starts)


def test_period_bound_catches_half_the_substeps(fx):
    """The 1e-5 per-period bound the kernel is held to (against the scan)
    fails an integrator with half the substeps by more than an order of
    magnitude (5.8e-4 from the seed start)."""
    from car_racing_tpu.ops import dynamics

    x, u = fx["xcurv0"], jnp.asarray([0.1, 0.5], jnp.float32)
    full = dynamics.propagate(fx["track"], fx["bike"], fx["xglob0"], x, u, backend="scan")
    half = dynamics.propagate(fx["track"], fx["bike"], fx["xglob0"], x, u, backend="scan",
                              sub_dt=0.002)
    dev = max(float(jnp.max(jnp.abs(a - b))) for a, b in zip(full, half))
    assert dev > 10 * 1e-5
