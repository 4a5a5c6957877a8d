"""Dense-condensed vs Riccati-KKT crossover measurement.

Times the same tracking-QP interior-point solve (30 iterations) through its
two Newton-step factorizations at increasing horizons:

- dense: condense onto U, factorize the (N*U_DIM)^2 barrier-augmented
  system per iteration (O(N^2) memory for the prediction matrix G,
  O((N m)^3) factorization);
- riccati: stage-structured block-tridiagonal sweep (ipm.solve_ocp_qp),
  O(N n^3) time and O(N) memory per iteration;
- riccati_parallel: the same sweep with associative-scan backward pass +
  rollout (riccati.tvlqr_backward_parallel) — O(log N) sequential depth
  per iteration, SURVEY §5.7's horizon-parallel factorization.

Per-solve device time is measured as one jitted lax.scan over ``reps``
solves with varying initial states divided by ``reps``, so the time is the
solver's, not per-call dispatch.

Run on the target device and record the table:

    python -m car_racing_tpu.utils.crossover
"""

from __future__ import annotations

import json
import os
import time

import numpy as np

from . import numerics

HORIZONS = (10, 20, 50, 100, 200)
REPS = 300  # solves per timed call


def measure(horizons=HORIZONS, reps=REPS, out_path="build/crossover.json"):
    import jax
    import jax.numpy as jnp

    from ..models import controllers
    from ..utils import params
    from ..utils.constants import U_DIM, X_DIM

    dtype = jnp.float32
    sysp = jax.tree.map(lambda x: jnp.asarray(x, dtype), params.SystemParam.default())
    base = params.MPCParam.default(vt=0.8)
    xt = jnp.asarray([0.8, 0, 0, 0, 0, 0.0], dtype)
    w = jnp.asarray(0.8, dtype)
    rng = np.random.default_rng(0)
    rows = []

    for N in horizons:
        p = params.MPCParam(
            A=jnp.asarray(base.A, dtype), B=jnp.asarray(base.B, dtype),
            Q=jnp.asarray(base.Q, dtype), R=jnp.asarray(base.R, dtype),
            vt=jnp.asarray(base.vt, dtype), eyt=jnp.asarray(base.eyt, dtype),
            num_horizon=N,
        )
        x0s = jnp.asarray(
            np.array([0.4, 0, 0, 0, 0.5, 0.1]) + 0.05 * rng.standard_normal((reps, X_DIM)),
            dtype,
        )
        row = {"N": N}
        for kkt in ("dense", "riccati", "riccati_parallel"):

            @numerics.jit
            def run(x0s, kkt=kkt, p=p):
                def body(acc, x):
                    u0 = controllers.mpc_lti(x, xt, p, sysp, w, kkt=kkt)
                    return acc + u0, None

                acc, _ = jax.lax.scan(body, jnp.zeros(U_DIM, dtype), x0s)
                return acc

            out = jax.block_until_ready(run(x0s))
            best = np.inf
            for _ in range(5):
                t0 = time.perf_counter()
                jax.block_until_ready(run(x0s))
                best = min(best, time.perf_counter() - t0)
            row[f"{kkt}_ms"] = best * 1e3 / reps
        row["speedup_riccati"] = row["dense_ms"] / row["riccati_ms"]
        row["speedup_parallel_vs_riccati"] = (
            row["riccati_ms"] / row["riccati_parallel_ms"]
        )
        rows.append(row)
        print(
            f"N={N:4d}  dense {row['dense_ms']:8.3f} ms  "
            f"riccati {row['riccati_ms']:8.3f} ms  "
            f"riccati-parallel {row['riccati_parallel_ms']:8.3f} ms  "
            f"(par/seq {row['speedup_parallel_vs_riccati']:.2f}x)"
        )

    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    with open(out_path, "w") as fh:
        dev = jax.devices()[0]
        json.dump({"device": f"{dev.platform} {dev.device_kind}", "reps": reps,
                   "iters": 30, "rows": rows}, fh, indent=1)
    print(f"wrote {out_path}")
    return rows


if __name__ == "__main__":
    measure()
