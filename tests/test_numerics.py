"""The package's matmul-precision pin (``utils/numerics``): every compiled
entry point traces under it, and importing the package changes nothing
for a host application's own JAX code."""

import jax
import jax.numpy as jnp

from car_racing_tpu.utils import numerics


def test_import_leaves_the_global_precision_alone():
    import car_racing_tpu.racing.fused  # noqa: F401 — imports most of the package

    assert jax.config.jax_default_matmul_precision is None


def test_jit_traces_under_the_pin():
    seen = []

    @numerics.jit
    def f(a):
        seen.append(jax.config.jax_default_matmul_precision)
        return a @ a

    f(jnp.ones((2, 2)))
    assert seen == [numerics.PRECISION] == ["highest"]
    assert jax.config.jax_default_matmul_precision is None


def test_lowered_dots_carry_highest_precision():
    a = jnp.ones((4, 4), jnp.float32)
    pinned = numerics.jit(lambda x, y: x @ y).lower(a, a).as_text()
    plain = jax.jit(lambda x, y: x @ y).lower(a, a).as_text()
    assert "precision = [HIGHEST, HIGHEST]" in pinned
    assert "HIGHEST" not in plain
