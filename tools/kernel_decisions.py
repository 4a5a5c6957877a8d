"""Kernel decisions on the GPU: each hand-written kernel against what XLA
makes of the plain JAX version, end to end.

    python tools/kernel_decisions.py [--quick] [--only=SECTION,...] [--skip-port] [--out=DIR]

Sections: integrator_parity (kernel vs scan, one period, 64 lanes);
lmpc_lap_250 (the seed LMPC lap with the scan at unroll 1 and 10 and with
the integrator kernel); fleet64_100 (the 64-lane racing-game fleet, 100
steps, with the same three integrators, and the kernel integrator with the
Triton Cholesky port below in place of the XLA solve); cholesky_parity and
qp_batch_256 (the port against ``jnp.linalg.cholesky`` + ``cho_solve``
inside ``ipm.solve_qp_batch`` at the corridor sweep's (256, 20, 20) batch,
30 iterations, run plain, port, port, plain).  ``--skip-port`` leaves out
the fleet's port variant, whose first compile takes minutes.

The port is the candidate the package did not keep (PERF.md, kernel
decision 2); it lives here only so that decision can be measured again.
Times are host wall clock around ``block_until_ready``, compile excluded.
Writes kernel_decisions.json to ``--out=DIR`` (default ``build/studies``).
"""

import functools
import json
import os
import sys
import time
import traceback

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
os.chdir(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from car_racing_tpu.ops import dynamics, ipm, pallas_kernels, track as track_ops
from car_racing_tpu.racing import fused
from car_racing_tpu.utils import device_checks, params
from car_racing_tpu.utils.bench_fixtures import FIXTURE_PATH
from car_racing_tpu.utils.constants import U_DIM, X_DIM

QUICK = "--quick" in sys.argv
INTERPRET = jax.devices()[0].platform == "cpu"
SKIP_PORT = "--skip-port" in sys.argv
OUT = next((a.split("=", 1)[1] for a in sys.argv if a.startswith("--out=")),
           os.path.join("build", "studies"))
RES = {"device": str(jax.devices()[0]), "kind": jax.devices()[0].device_kind,
       "nvidia_smi": device_checks.card()}
print(RES, flush=True)
f32 = jnp.float32
cast = lambda t: jax.tree.map(lambda a: jnp.asarray(a, f32), t)


def dump():
    os.makedirs(OUT, exist_ok=True)
    with open(os.path.join(OUT, "kernel_decisions.json"), "w") as fh:
        json.dump(RES, fh, indent=1)


ONLY = next((a.split("=", 1)[1].split(",") for a in sys.argv if a.startswith("--only=")), None)


def section(name):
    def deco(fn):
        if ONLY is not None and name not in ONLY:
            return fn
        t0 = time.perf_counter()
        try:
            RES[name] = fn()
        except Exception:  # noqa: BLE001
            RES[name] = {"error": traceback.format_exc()[-3000:]}
        RES[name + "_wall_s"] = time.perf_counter() - t0
        print(name, json.dumps(RES[name], default=str)[:3000], flush=True)
        dump()
        return fn
    return deco


# --------------------------------------------------------------------------
# Triton port of the lane-major Cholesky solve (one thread per problem,
# left-looking, L kept in registers), batched into one kernel under vmap.
# --------------------------------------------------------------------------

def _chol_kernel(a_ref, b_ref, x_ref, *, n, r):
    L = {}
    for j in range(n):
        c = [a_ref[i * n + j, :] for i in range(j, n)]
        for k in range(j):
            ljk = L[j, k]
            c = [c[i - j] - L[i, k] * ljk for i in range(j, n)]
        d = jax.lax.rsqrt(jnp.maximum(c[0], 1e-30))
        for i in range(j, n):
            L[i, j] = c[i - j] * d
    for rr in range(r):
        y = []
        for i in range(n):
            acc = b_ref[rr * n + i, :]
            for k in range(i):
                acc = acc - L[i, k] * y[k]
            y.append(acc / L[i, i])
        x = [None] * n
        for i in reversed(range(n)):
            acc = y[i]
            for k in range(i + 1, n):
                acc = acc - L[k, i] * x[k]
            x[i] = acc / L[i, i]
        for i in range(n):
            x_ref[rr * n + i, :] = x[i]


def _chol_lanes(a, b, n, r, blk):
    """a: (n*n, B), b: (r*n, B) -> (r*n, B)."""
    B = a.shape[1]
    pad = (-B) % blk
    if pad:
        a = jnp.pad(a, ((0, 0), (0, pad)), mode="edge")
        b = jnp.pad(b, ((0, 0), (0, pad)), mode="edge")
    ra = pl.next_power_of_2(a.shape[0])
    rb = pl.next_power_of_2(b.shape[0])
    a = jnp.pad(a, ((0, ra - a.shape[0]), (0, 0)))
    b = jnp.pad(b, ((0, rb - b.shape[0]), (0, 0)))
    out = pl.pallas_call(
        functools.partial(_chol_kernel, n=n, r=r),
        out_shape=jax.ShapeDtypeStruct((rb, B + pad), a.dtype),
        grid=((B + pad) // blk,),
        in_specs=[pl.BlockSpec((ra, blk), lambda i: (0, i)),
                  pl.BlockSpec((rb, blk), lambda i: (0, i))],
        out_specs=pl.BlockSpec((rb, blk), lambda i: (0, i)),
        compiler_params=plgpu.CompilerParams(num_warps=max(1, blk // 32), num_stages=1),
        backend="triton", interpret=INTERPRET, name="cholesky_solve_port",
    )(a, b)
    return out[: r * n, :B]


@functools.lru_cache(maxsize=None)
def _chol_op(n, r, blk):
    @jax.custom_batching.custom_vmap
    def op(A, Brhs):  # (..., n, n), (..., n, r)
        lead = A.shape[:-2]
        Af = A.reshape(-1, n * n).T.astype(f32)
        Bf = jnp.swapaxes(Brhs.reshape(-1, n, r), 1, 2).reshape(-1, r * n).T.astype(f32)
        X = _chol_lanes(Af, Bf, n, r, blk)  # (r*n, B)
        X = jnp.swapaxes(X.T.reshape(-1, r, n), 1, 2)
        return X.reshape(lead + (n, r)).astype(A.dtype)

    @op.def_vmap
    def _rule(axis_size, in_batched, A, Brhs):
        A = A if in_batched[0] else jnp.broadcast_to(A, (axis_size,) + A.shape)
        Brhs = Brhs if in_batched[1] else jnp.broadcast_to(Brhs, (axis_size,) + Brhs.shape)
        return op(A, Brhs), True

    return op


BLK = 32


def port_multi(A, Brhs):
    return _chol_op(A.shape[-1], Brhs.shape[-1], BLK)(A, Brhs)


def port_single(A, b):
    return port_multi(A, b[..., None])[..., 0]


PLAIN = (pallas_kernels.solve_batched, pallas_kernels.solve_multi_batched)
ORIG_PROP = dynamics.propagate


def use_solver(port: bool):
    pallas_kernels.solve_batched = port_single if port else PLAIN[0]
    pallas_kernels.solve_multi_batched = port_multi if port else PLAIN[1]
    jax.clear_caches()


def use_integrator(backend, unroll=None):
    def prop(*a, **k):
        if backend == "pallas" and INTERPRET:
            return pallas_kernels.propagate_fused(
                *a, control_dt=k.get("control_dt", 0.1), sub_dt=k.get("sub_dt", 0.001),
                interpret=True)
        k["backend"] = backend
        if unroll is not None:
            k["unroll"] = unroll
        return ORIG_PROP(*a, **k)
    dynamics.propagate = prop
    jax.clear_caches()


def guard(fn, *a, **k):
    try:
        return fn(*a, **k)
    except Exception:  # noqa: BLE001
        return {"error": traceback.format_exc()[-2000:]}


def timed(fn, reps):
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn())
    compile_s = time.perf_counter() - t0
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        ts.append(time.perf_counter() - t0)
    return out, compile_s, ts


def summarize(compile_s, ts, per=1):
    a = np.asarray(ts) / per * 1e3
    return {"compile_s": compile_s, "p50_ms": float(np.percentile(a, 50)),
            "min_ms": float(a.min()), "max_ms": float(a.max()), "n": len(a)}


track = cast(track_ops.load_track("l_shape", width=1.0))
bike = cast(dynamics.BicycleParams.default())
seed = np.load(FIXTURE_PATH)
lmpc_param = cast(params.LMPCParam.default())
rg_param = cast(params.RacingGameParam.default(alpha=0.8))
sysp = cast(params.SystemParam.default())
j = lambda k: jnp.asarray(seed[k], f32)
lap_args = (
    track, bike, lmpc_param, sysp, j("xcurv0"), j("xglob0"),
    j("ss1"), j("q1"), j("ss2"), j("q2"), j("u1"), j("u2"),
    jnp.asarray(seed["valid1"]), jnp.asarray(seed["valid2"]),
    jnp.asarray(seed["counter"], jnp.int32), j("lin_points0"), j("lin_input0"),
)
opti = jnp.asarray(np.genfromtxt("data/optimal_traj/xcurv_l_shape.csv", delimiter=","), f32)
s_coef = jnp.asarray([[0.72, 7.5], [0.7, 5.5]], f32)
ey_coef = jnp.asarray([[0.0, -0.2], [0.0, -0.5]], f32)


@section("integrator_parity")
def _():
    rng = np.random.default_rng(0)
    B = 64
    xc = jnp.asarray(np.array([0.8, 0.01, 0.02, 0.01, 5.0, 0.05])
                     + 0.3 * rng.standard_normal((B, 6)) * np.array([1, .1, .1, .1, 10, 1]), f32)
    xg = jnp.asarray(rng.standard_normal((B, 6)), f32)
    u = jnp.asarray(np.array([0.05, 0.3]) + 0.1 * rng.standard_normal((B, 2)), f32)
    use_integrator("scan")
    sc_prop = dynamics.propagate
    use_integrator("pallas")
    k_prop = dynamics.propagate
    run = lambda be: jax.jit(jax.vmap(lambda g, c, uu: (k_prop if be == "pallas" else sc_prop)(
        track, bike, g, c, uu)))(xg, xc, u)
    t0 = time.perf_counter()
    kp = jax.block_until_ready(run("pallas"))
    ck = time.perf_counter() - t0
    sc = run("scan")
    dev = max(float(jnp.max(jnp.abs(a - b))) for a, b in zip(kp, sc))
    return {"lanes": B, "max_abs_dev_per_period": dev, "compile_s": ck}


def lap_variant(backend, unroll=None, reps=5):
    use_integrator(backend, unroll)
    use_solver(False)
    n = 250
    fn = lambda: fused.rollout_lmpc_lap(*lap_args, n_steps=n)
    out, c, ts = timed(fn, 2 if QUICK else reps)
    return {"lap_steps": int(out[3]), **summarize(c, ts, per=n)}


@section("lmpc_lap_250")
def _():
    return {
        "scan_unroll1": guard(lap_variant, "scan", 1),
        "scan_unroll10": guard(lap_variant, "scan", 10),
        "pallas_kernel": guard(lap_variant, "pallas"),
    }


def fleet_variant(backend, unroll, port, B=64, n=100, reps=3):
    use_integrator(backend, unroll)
    use_solver(port)
    rng = np.random.default_rng(7)
    pert = np.zeros((B, X_DIM))
    pert[:, 5] = rng.normal(0, 0.01, B)
    xc0 = j("xcurv0") + jnp.asarray(pert, f32)
    xg0 = jnp.broadcast_to(j("xglob0"), (B, X_DIM))
    fn = lambda: fused.rollout_racing_game_batch(
        track, bike, lmpc_param, rg_param, sysp, xc0, xg0, *lap_args[6:],
        s_coef, ey_coef, opti, n_steps=n, dynamics_unroll=10)
    out, c, ts = timed(fn, 1 if QUICK else reps)
    r = summarize(c, ts)
    r["lane_steps_per_s"] = B * n / (r["p50_ms"] * 1e-3)
    r["finite"] = bool(np.isfinite(np.asarray(out[0])).all())
    return r


@section("fleet64_100")
def _():
    B = 8 if QUICK else 64
    return {
        "scan_unroll1_plain": guard(fleet_variant, "scan", 1, False, B),
        "scan_unroll10_plain": guard(fleet_variant, "scan", 10, False, B),
        "kernel_plain": guard(fleet_variant, "pallas", None, False, B),
        **({} if SKIP_PORT else {"kernel_port": guard(fleet_variant, "pallas", None, True, B)}),
    }


@section("cholesky_parity")
def _():
    use_solver(False)
    out = {}
    for n in (20,):
        rng = np.random.default_rng(n)
        B = 256
        Lm = rng.normal(size=(B, n, n))
        A = (Lm @ np.transpose(Lm, (0, 2, 1)) + n * np.eye(n)).astype(np.float32)
        b = rng.normal(size=(B, n)).astype(np.float32)
        ref = np.linalg.solve(A.astype(np.float64), b.astype(np.float64)[..., None])[..., 0]
        xp = np.asarray(jax.jit(port_single)(jnp.asarray(A), jnp.asarray(b)))
        xx = np.asarray(jax.jit(PLAIN[0])(jnp.asarray(A), jnp.asarray(b)))
        out[f"n{n}"] = {
            "port_max_rel": float(np.max(np.abs(xp - ref) / (np.abs(ref) + 1e-3))),
            "plain_max_rel": float(np.max(np.abs(xx - ref) / (np.abs(ref) + 1e-3))),
            "port_ok": bool(np.allclose(xp, ref, rtol=5e-3, atol=5e-4)),
            "plain_ok": bool(np.allclose(xx, ref, rtol=5e-3, atol=5e-4)),
        }
    return out


@section("qp_batch_256")
def _():
    from car_racing_tpu.parallel import scaling
    from car_racing_tpu.planning import overtake as ov

    N = 10
    ci = scaling.corridor_sweep_inputs(64, N, seed=1, dtype=f32)
    x0c, A_c, B_c, width_c, veh_w_c = ci[0], ci[1], ci[2], ci[3], ci[4]
    bez_c, ley_c, lg_c, rey_c, rg_c = ci[6], ci[7], ci[8], ci[9], ci[10]

    @jax.jit
    def build():
        def per_scen(x0s, bezs, leys, lgs, reys, rgs):
            phi, G, s_pred = ov.corridor_context(x0s, A_c, B_c, N)
            return jax.vmap(lambda b, a1, a2, a3, a4: ov.corridor_branch_qp(
                phi, G, s_pred, width_c, veh_w_c, b, a1, a2, a3, a4, N))(
                bezs, leys[:, :N], lgs[:, :N], reys[:, :N], rgs[:, :N])
        nested = jax.vmap(per_scen)(x0c, bez_c, ley_c, lg_c, rey_c, rg_c)
        return jax.tree.map(lambda a: a.reshape((256,) + a.shape[2:]), nested)

    qp = jax.block_until_ready(build())
    z0 = jnp.zeros((256, N * U_DIM), f32)
    res = {"shape": [int(s) for s in qp.H.shape], "n_eq": int(qp.E.shape[1])}
    sols = {}
    for name, port in (("plain", False), ("port", True), ("port2", True), ("plain2", False)):
        use_solver(port)
        fn = jax.jit(lambda q: ipm.solve_qp_batch(q, z0, iters=30))
        sol, c, ts = timed(lambda: fn(qp), 5 if QUICK else 50)
        sols[name] = sol
        res[name] = summarize(c, ts)
        res[name]["iters_sum"] = int(np.sum(np.asarray(sol.iterations)))
    res["z_max_abs_diff_port_vs_plain"] = float(jnp.max(jnp.abs(sols["port"].z - sols["plain"].z)))
    return res


use_solver(False)
dynamics.propagate = ORIG_PROP
print(json.dumps(RES, default=str)[:20000])
