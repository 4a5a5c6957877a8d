"""Matmul precision of the package's compiled programs.

f32 matmuls run in TF32 (a 10-bit mantissa) on an H100 unless told
otherwise.  Control-grade numerics want full f32 — condensation, the LMPC
regression, the interior-point Newton systems — and with TF32 the LMPC
step moves the next state by a median 0.49 on an H100 (PERF.md).

:func:`jit` is ``jax.jit`` whose traces and compiles run under matmul
precision :data:`PRECISION`.  Every compiled entry point of the package is
built with it, so the pin holds wherever the package's code runs, nested
calls included, and a host application's own JAX code keeps its default.
"""

from __future__ import annotations

import functools

import jax

PRECISION = "highest"


def jit(fun=None, **jit_kwargs):
    """``jax.jit(fun, **jit_kwargs)``, called and lowered under matmul
    precision :data:`PRECISION` (read at each call, so the jit cache keys
    on it).  Usable bare or as ``partial(jit, static_argnames=...)``."""
    if fun is None:
        return functools.partial(jit, **jit_kwargs)
    compiled = jax.jit(fun, **jit_kwargs)

    @functools.wraps(fun)
    def call(*args, **kwargs):
        with jax.default_matmul_precision(PRECISION):
            return compiled(*args, **kwargs)

    def lower(*args, **kwargs):
        with jax.default_matmul_precision(PRECISION):
            return compiled.lower(*args, **kwargs)

    call.lower = lower
    return call
