"""Behavioural checks of the configuration the GPU runs: the fused
integrator kernel, the batched SPD solves and the flagship rollouts, each
against its plain reference.  Shared by ``tests/test_gpu.py`` (the
``gpu``-marked tier) and ``chip_smoke.py``, so both assert the same bounds.

Every check raises ``AssertionError`` with the measured value on failure
and returns a dict of what it measured otherwise.  All rollouts run in f32
(the GPU's dtype) from the committed LMPC seed fixture on ``l_shape``.
"""

from __future__ import annotations

import subprocess

import numpy as np
import jax
import jax.numpy as jnp

from ..ops import dynamics, pallas_kernels, track as track_ops
from ..racing import fused
from ..utils import params
from ..utils.bench_fixtures import FIXTURE_PATH
from ..utils.constants import X_DIM
from . import numerics

F32 = jnp.float32
# the CI traffic: two prescribed cars (s(t), ey(t) polynomials, sorted by
# ey descending) and the car footprint the collision check uses
S_COEF = ((0.72, 7.5), (0.7, 5.5))
EY_COEF = ((0.0, -0.2), (0.0, -0.5))
CAR_LENGTH, CAR_WIDTH = 0.4, 0.2


def card() -> str:
    """The card's name and power limit, as ``nvidia-smi`` reports them;
    printed beside every device number (a card capped below its maximum
    power runs slower under load)."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        ).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({e})"


def _cast(tree):
    return jax.tree.map(lambda a: jnp.asarray(a, F32), tree)


def fixture(device=None) -> dict:
    """Track, parameters and LMPC seed arrays (f32), optionally placed on
    ``device``."""
    seed = np.load(FIXTURE_PATH)
    j = lambda k: jnp.asarray(seed[k], F32)
    fx = {
        "track": _cast(track_ops.load_track("l_shape", width=1.0)),
        "bike": _cast(dynamics.BicycleParams.default()),
        "lmpc_param": _cast(params.LMPCParam.default()),
        "rg_param": _cast(params.RacingGameParam.default(alpha=0.8)),
        "sys_param": _cast(params.SystemParam.default()),
        "xcurv0": j("xcurv0"), "xglob0": j("xglob0"),
        "seed": (
            j("ss1"), j("q1"), j("ss2"), j("q2"), j("u1"), j("u2"),
            jnp.asarray(seed["valid1"]), jnp.asarray(seed["valid2"]),
            jnp.asarray(seed["counter"], jnp.int32),
            j("lin_points0"), j("lin_input0"),
        ),
        "traffic": (jnp.asarray(S_COEF, F32), jnp.asarray(EY_COEF, F32)),
        "opti": jnp.asarray(
            np.genfromtxt("data/optimal_traj/xcurv_l_shape.csv", delimiter=","), F32
        ),
        "pid_lap_steps": int(seed["pid_lap_steps"]),
    }
    if device is not None:
        fx = {k: v if isinstance(v, int) else jax.device_put(v, device)
              for k, v in fx.items()}
    return fx


def lmpc_lap(fx, n_steps: int = 250, backend: str = "auto", sub_dt: float = 0.001,
             return_carries: bool = False):
    return fused.rollout_lmpc_lap(
        fx["track"], fx["bike"], fx["lmpc_param"], fx["sys_param"],
        fx["xcurv0"], fx["xglob0"], *fx["seed"],
        n_steps=n_steps, dynamics_backend=backend, sub_dt=sub_dt,
        return_carries=return_carries,
    )


def lmpc_replay_error(ref, fx, backend: str = "auto", sub_dt: float = 0.001):
    """Per-step comparison of an LMPC lap under test with a reference lap.

    ``ref`` is ``lmpc_lap(..., return_carries=True)`` run by the reference
    (any device).  Every control step of its lap is run again from the
    carry the reference entered it with, on ``fx``'s device with
    ``backend`` and ``sub_dt``, and the next state is compared with the
    reference's.  Fed the same inputs, the two sides differ only by what
    one step adds, which a closed loop would otherwise amplify without
    bound.  Returns the per-step max |dx| over the six states."""
    lap = int(ref[3])
    dev = next(iter(fx["xcurv0"].devices()))
    carries = jax.tree.map(lambda a: jax.device_put(a[:lap], dev), ref[4])
    seed = fx["seed"]
    nxt = fused.lmpc_lap_replay(
        fx["track"], fx["bike"], fx["lmpc_param"], fx["sys_param"],
        seed[2], seed[1], seed[3], seed[4], seed[5], seed[6], seed[7], seed[8],
        carries, jax.device_put(jnp.arange(lap), dev),
        sub_dt=sub_dt, dynamics_backend=backend,
    )
    return np.abs(np.asarray(nxt[0]) - np.asarray(ref[0])[1 : lap + 1]).max(axis=1)


def racing_game(fx, n_steps: int = 250):
    return fused.rollout_racing_game(
        fx["track"], fx["bike"], fx["lmpc_param"], fx["rg_param"], fx["sys_param"],
        fx["xcurv0"], fx["xglob0"], *fx["seed"], *fx["traffic"], fx["opti"],
        n_steps=n_steps,
    )


def fleet_starts(fx, lanes: int, seed: int = 7):
    """``lanes`` perturbed copies of the seed start (vx and ey jitter)."""
    rng = np.random.default_rng(seed)
    pert = np.zeros((lanes, X_DIM))
    pert[:, 5] = rng.normal(0, 0.01, lanes)
    pert[:, 0] = rng.normal(0, 0.02, lanes)
    xc0 = fx["xcurv0"] + jnp.asarray(pert, F32)
    xg0 = jnp.broadcast_to(fx["xglob0"], (lanes, X_DIM))
    return xc0, xg0


def racing_fleet(fx, xc0, xg0, n_steps: int = 250):
    return fused.rollout_racing_game_batch(
        fx["track"], fx["bike"], fx["lmpc_param"], fx["rg_param"], fx["sys_param"],
        xc0, xg0, *fx["seed"], *fx["traffic"], fx["opti"],
        n_steps=n_steps,
    )


def integrator_deviation(fx, lanes: int = 64, tol: float = 1e-5) -> dict:
    """Kernel vs scan over one control period (100 substeps) for ``lanes``
    random states, vmapped (one kernel over all lanes).  The bound covers
    libdevice's transcendentals, which differ from XLA's in the last ulps."""
    rng = np.random.default_rng(0)
    xc = jnp.asarray(
        np.array([0.8, 0.01, 0.02, 0.01, 5.0, 0.05])
        + 0.3 * rng.standard_normal((lanes, 6)) * np.array([1, 0.1, 0.1, 0.1, 10, 1]),
        F32,
    )
    xg = jnp.asarray(rng.standard_normal((lanes, 6)), F32)
    u = jnp.asarray(np.array([0.05, 0.3]) + 0.1 * rng.standard_normal((lanes, 2)), F32)

    def period(backend):
        f = lambda g, c, uu: dynamics.propagate(
            fx["track"], fx["bike"], g, c, uu, backend=backend)
        return numerics.jit(jax.vmap(f))(xg, xc, u)

    dev = max(float(jnp.max(jnp.abs(a - b)))
              for a, b in zip(period("pallas"), period("scan")))
    assert dev < tol, f"fused integrator drifted {dev:.2e} per period (bound {tol:g})"
    return {"lanes": lanes, "max_abs_dev": dev, "tol": tol}


# Bounds on the median one-step state difference of a replayed LMPC lap
# (:func:`check_replay`).  The f32 step is sensitive to summation order:
# its local regression solves normal equations whose ridge (2e-5 of the
# Gram scale) leaves a condition number near 5e4, so two correct f32
# implementations fit models that differ by about 1e-3.  Measured: on the
# CPU the same program replayed in one batch differs by a median
# 1.0e-5; reversing the order of the regression's rows (the same sum)
# moves it to 4.1e-3, solving its normal equations by Cholesky instead of
# LU to 1.4e-3.  On an H100 the kernel replayed from the scan's carries
# differs by 2.6e-5, the GPU from the CPU's by 1.75e-3, and the GPU with
# TF32 matmuls from the CPU's by 0.49.
SAME_DEVICE_TOL = 1e-4  # one device, one regression: only the integrator differs
CROSS_DEVICE_TOL = 1e-2  # another device's summation order; TF32 fails it


def check_replay(err, median_tol: float) -> dict:
    """Gate on :func:`lmpc_replay_error`: the median over the lap's steps
    of the one-step state difference stays under ``median_tol``
    (``SAME_DEVICE_TOL`` or ``CROSS_DEVICE_TOL``).

    The median, not the maximum: on the steps where the LMPC's IPM ends
    unconverged at its iteration cap, a last-bit change moves the next
    state by up to 6e-2 even on one CPU.  A closed-lap bound separates
    nothing: on the CPU a one-ulp change of the start moves the lap from
    129 to 128-139 steps, and replaying the same lap in one batch instead
    of step by step from 129 to 136."""
    med = float(np.median(err))
    assert med < median_tol, (
        f"one-step state difference: median {med:.2e} over {len(err)} steps "
        f"(bound {median_tol:g})")
    return {"steps": len(err), "median": med, "p90": float(np.quantile(err, 0.9)),
            "max": float(err.max()), "median_tol": median_tol}


def check_lap_feasible(out) -> dict:
    """|ey| under 0.5 and inputs inside their bounds over the whole lap."""
    lap = int(out[3])
    xc = np.asarray(out[0])[: lap + 1]
    us = np.asarray(out[1])[:lap]
    ey = float(np.abs(xc[:, 5]).max())
    assert ey < 0.5, f"|ey| reached {ey:.3f}"
    assert us[:, 0].min() > -0.51 and us[:, 0].max() < 0.51, "steering out of bounds"
    assert us[:, 1].min() > -1.01 and us[:, 1].max() < 1.01, "acceleration out of bounds"
    return {"max_abs_ey": ey}


def check_racing_lane(fx, xc, ot, lap_steps, n_steps: int, tag: str = "") -> dict:
    """One racing-game lap: completes, beats the PID seed lap, dispatches an
    overtake, stays finite and on track (|ey| < track width 1.0, the bound
    the solvers enforce) and never overlaps either prescribed car."""
    ls = int(lap_steps)
    xc, ot = np.asarray(xc), np.asarray(ot)
    assert 0 < ls < n_steps, f"{tag}lap never completed ({ls})"
    assert ls < fx["pid_lap_steps"], f"{tag}lap {ls} not faster than the PID seed"
    assert ot[:ls].any(), f"{tag}no overtake step dispatched"
    assert np.isfinite(xc[: ls + 1]).all(), f"{tag}non-finite state"
    ey = float(np.abs(xc[: ls + 1, 5]).max())
    assert ey < 1.0, f"{tag}off track (|ey| {ey:.3f})"
    L = float(np.asarray(fx["track"].lap_length))
    t = np.arange(len(xc)) * 0.1
    for cs, ce in zip(S_COEF, EY_COEF):
        ds = np.abs(np.mod(xc[:, 4] - np.polyval(cs, t) + L / 2, L) - L / 2)
        dey = np.abs(xc[:, 5] - np.polyval(ce, t))
        hit = ((ds < 0.9 * CAR_LENGTH) & (dey < 0.9 * CAR_WIDTH))[: ls + 1]
        assert not hit.any(), f"{tag}collision with the ey={ce[1]} car"
    return {"lap_steps": ls, "overtake_steps": int(ot[:ls].sum()), "max_abs_ey": ey}


def check_fleet(fx, out, n_steps: int) -> dict:
    """Every lane of a racing-game fleet passes :func:`check_racing_lane`."""
    xc, _, ot, laps = (np.asarray(a) for a in out)
    lanes = [check_racing_lane(fx, xc[b], ot[b], laps[b], n_steps, f"lane {b}: ")
             for b in range(xc.shape[0])]
    steps = [r["lap_steps"] for r in lanes]
    return {"lanes": len(lanes), "lap_steps_min": min(steps),
            "lap_steps_median": float(np.median(steps)), "lap_steps_max": max(steps),
            "max_abs_ey": max(r["max_abs_ey"] for r in lanes)}


def compare_fleets(out_a, out_b, xc0, c_alpha: float = 1.949) -> dict:
    """Two racing-game fleets run from the same starts ``xc0`` (sharded over
    several cards and on one): lane b of each starts from ``xc0[b]``, and
    their lap-step distributions agree — the two-sample Kolmogorov-Smirnov
    statistic stays under ``c_alpha * sqrt((n + m) / (n m))``, its critical
    value at alpha = 0.001 (0.345 for 64 + 64 lanes).

    Lanes are not compared one for one: a lane flips discrete decisions
    (safe-set window, corridor choice) on rounding-level differences
    between batch shapes, and the closed loop turns that into another
    valid lap.  Between 14 independently seeded 64-lane fleets on the CPU
    (91 pairs) the statistic reached at most 0.281."""
    start = np.asarray(xc0)
    for name, out in (("A", out_a), ("B", out_b)):
        got = np.asarray(out[0])[:, 0]
        assert np.array_equal(got, start), f"fleet {name}: lanes do not start from their inputs"
    la, lb = np.sort(np.asarray(out_a[3])), np.sort(np.asarray(out_b[3]))
    v = np.concatenate([la, lb])
    d = float(np.max(np.abs(np.searchsorted(la, v, side="right") / len(la)
                            - np.searchsorted(lb, v, side="right") / len(lb))))
    crit = c_alpha * np.sqrt((len(la) + len(lb)) / (len(la) * len(lb)))
    assert d < crit, f"lap-step distributions differ: KS {d:.3f} (bound {crit:.3f})"
    return {"ks": d, "ks_bound": float(crit), "median_a": float(np.median(la)),
            "median_b": float(np.median(lb))}


def matmul_error(n: int = 512, rtol: float = 1e-5) -> dict:
    """Relative error of a jitted f32 ``(n, n) @ (n, n)`` against float64
    numpy at the package's matmul precision.  Every entry is 1 plus less
    than half a TF32 ulp (2**-11), so a TF32 product (10-bit mantissa)
    rounds each factor to 1 and is off by about 7e-4; full f32 keeps the
    low bits and stays near 1e-7."""
    rng = np.random.default_rng(n)
    a, b = (1.0 + (0.5 + 0.45 * rng.random((2, n, n))) * 2.0**-11).astype(np.float32)
    ref = a.astype(np.float64) @ b.astype(np.float64)
    got = np.asarray(numerics.jit(jnp.matmul)(a, b))
    err = float(np.max(np.abs(got - ref) / np.abs(ref)))
    assert err < rtol, f"f32 matmul off by {err:.1e} relative (bound {rtol:g}): TF32?"
    return {"n": n, "max_rel_err": err, "rtol": rtol,
            "precision": numerics.PRECISION}


def spd_solve_error(n: int, B: int, r: int | None = None,
                    rtol: float = 5e-3, atol: float = 5e-4) -> dict:
    """``solve_batched`` (or ``solve_multi_batched`` with r right-hand
    sides) in f32 against float64 numpy on well-conditioned SPD systems."""
    rng = np.random.default_rng(n + (r or 0))
    Lm = rng.normal(size=(B, n, n))
    A = (Lm @ np.transpose(Lm, (0, 2, 1)) + n * np.eye(n)).astype(np.float32)
    shape = (B, n) if r is None else (B, n, r)
    b = rng.normal(size=shape).astype(np.float32)
    rhs = b[..., None] if r is None else b
    ref = np.linalg.solve(A.astype(np.float64), rhs.astype(np.float64))
    ref = ref[..., 0] if r is None else ref
    solve = pallas_kernels.solve_batched if r is None else pallas_kernels.solve_multi_batched
    x = np.asarray(numerics.jit(solve)(jnp.asarray(A), jnp.asarray(b)))
    np.testing.assert_allclose(x, ref, rtol=rtol, atol=atol)
    return {"shape": list(A.shape), "rhs": r or 1,
            "max_abs_err": float(np.max(np.abs(x - ref))), "rtol": rtol, "atol": atol}
