"""Auxiliary subsystems: checkpoint/resume and the solve-time recorder."""

import numpy as np
import pytest

from car_racing_tpu.racing import policies
from car_racing_tpu.utils import checkpoint, params, profiling


def _mini_lmpc(tmpdir=None):
    lmpc = policies.LMPCRacingGame(
        params.LMPCParam.default(),
        racing_game_param=params.RacingGameParam.default(),
        timestep=0.1,
        lap_number=3,
        time_lmpc=50 * 0.1,
    )
    return lmpc


def test_lmpc_checkpoint_roundtrip(tmp_path):
    lmpc = _mini_lmpc()
    # populate some learning state
    lmpc.ss_xcurv[:10, :, 0] = np.arange(60).reshape(10, 6)
    lmpc.Qfun[:10, 0] = np.arange(10)[::-1]
    lmpc.time_ss[0] = 9
    lmpc.iter = 1
    lmpc.time_in_iter = 4
    lmpc.lin_points = np.ones((13, 6))
    lmpc.lin_input = np.zeros((12, 2))
    path = str(tmp_path / "lmpc_state.npz")
    checkpoint.save_lmpc_state(lmpc, path)

    fresh = _mini_lmpc()
    checkpoint.load_lmpc_state(fresh, path)
    np.testing.assert_array_equal(fresh.ss_xcurv, lmpc.ss_xcurv)
    np.testing.assert_array_equal(fresh.Qfun, lmpc.Qfun)
    assert fresh.iter == 1 and fresh.time_in_iter == 4
    np.testing.assert_array_equal(fresh.lin_points, lmpc.lin_points)


def test_export_raceline(tmp_path, monkeypatch):
    lmpc = _mini_lmpc()
    lmpc.iter = 2
    lmpc.time_ss[0] = 20
    lmpc.time_ss[1] = 15
    lmpc.Qfun[0, 0] = 20
    lmpc.Qfun[0, 1] = 15  # lap 1 is faster
    lmpc.ss_xcurv[:16, :, 1] = 1.0
    lmpc.ss_glob[:16, :, 1] = 2.0
    best = checkpoint.export_raceline(lmpc, "testtrack", data_dir=str(tmp_path))
    assert best == 1
    out = np.genfromtxt(tmp_path / "optimal_traj" / "xcurv_testtrack_learned.csv", delimiter=",")
    assert out.shape == (16, 6)
    np.testing.assert_allclose(out, 1.0)


def test_solve_timer_percentiles():
    t = profiling.SolveTimer()
    for ms in [1.0, 2.0, 3.0, 100.0]:
        t.record("solve", ms)
    with t.measure("ctx"):
        pass
    s = t.summary()
    assert s["solve"]["count"] == 4
    assert s["solve"]["p50_ms"] == pytest.approx(2.5)
    assert s["solve"]["max_ms"] == 100.0
    assert "ctx" in s
    assert "solve" in t.report()


def test_compile_cache_honours_env_dir(monkeypatch, tmp_path):
    """With JAX_COMPILATION_CACHE_DIR set, JAX reads it itself: the helper
    returns it and changes no setting."""
    import jax

    from car_racing_tpu.utils import compile_cache

    monkeypatch.setenv(compile_cache.ENV_VAR, str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    assert compile_cache.enable() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_defaults_to_checkout(monkeypatch, repo_root):
    """Without the variable the cache is ``.jax_cache/`` in the checkout:
    a fixed path, never a temporary or per-process one."""
    import os

    import jax

    from car_racing_tpu.utils import compile_cache

    monkeypatch.delenv(compile_cache.ENV_VAR, raising=False)
    before = jax.config.jax_compilation_cache_dir
    try:
        path = compile_cache.enable()
        assert path == os.path.join(repo_root, ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == path
        assert compile_cache.enable() == path  # stable across calls
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


@pytest.mark.parametrize("script", ["chip_smoke", "bench"])
def test_device_entry_points_refuse_the_cpu(script, repo_root, monkeypatch):
    """chip_smoke.py and bench.py measure the GPU: on a CPU platform they
    exit non-zero before doing any work, with no CPU fallback."""
    import importlib
    import os
    import sys

    monkeypatch.syspath_prepend(repo_root)
    monkeypatch.setenv("XLA_FLAGS", os.environ.get("XLA_FLAGS", ""))  # restored after
    mod = importlib.import_module(script)
    entry = (lambda: mod.main([])) if script == "chip_smoke" else mod.main
    with pytest.raises(SystemExit) as exc:
        entry()
    assert exc.value.code not in (0, None)
    assert "cpu" in str(exc.value.code)
    sys.modules.pop(script, None)
