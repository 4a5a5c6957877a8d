"""JAX's persistent compilation cache at a fixed place.

Every entry point (the CLI drivers, ``bench.py``, ``chip_smoke.py``) calls
:func:`enable` before its first compile.  If ``JAX_COMPILATION_CACHE_DIR`` is
set, JAX reads it itself and nothing is changed; otherwise the cache lives
in ``.jax_cache/`` at the root of the checkout.  The path is part of the
cache key, so it is never a temporary, per-process or time-stamped one.
"""

from __future__ import annotations

import os

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def enable() -> str:
    """Point the persistent compile cache at its directory; return it."""
    if os.environ.get(ENV_VAR):
        return os.environ[ENV_VAR]
    import jax

    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return DEFAULT_DIR
