"""GPU tier: certifies the configuration the GPU runs — the fused Triton
integrator kernel (``dynamics.propagate(backend="auto")`` on CUDA), the
batched SPD solves through cuSOLVER, and the flagship rollouts — against
their plain references with asserted bounds.

Every test here is marked ``gpu``; the autouse fixture in ``conftest.py``
skips them when the first JAX device is not a GPU.  On the card they run
in the same process as ``chip_smoke.py`` (its last phase):

    CAR_RACING_TEST_PLATFORM=device python -m pytest -m gpu tests/test_gpu.py
"""

import jax
import pytest

from car_racing_tpu.utils import device_checks as dc

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def fx():
    return dc.fixture()


def test_fused_integrator_period_deviation(fx):
    dc.integrator_deviation(fx, lanes=64)


def test_auto_backend_lowers_to_the_kernel(fx):
    """On the GPU ``backend="auto"`` must reach the Triton kernel, not the
    scan (the silent-skip failure mode of a process-default switch)."""
    from car_racing_tpu.ops import dynamics

    x = fx["xcurv0"]
    text = dynamics.propagate.lower(
        fx["track"], fx["bike"], fx["xglob0"], x, x[:2] * 0).as_text()
    assert "triton" in text


def test_fused_integrator_full_closed_lap(fx):
    """Every step of the closed LMPC lap with the scan, run again with the
    kernel from the same carry, both on the GPU; the kernel's own lap
    completes on track."""
    ref_scan = dc.lmpc_lap(fx, backend="scan", return_carries=True)
    dc.check_replay(dc.lmpc_replay_error(ref_scan, fx, backend="pallas"), dc.SAME_DEVICE_TOL)
    dc.check_lap_feasible(dc.lmpc_lap(fx, backend="pallas"))


def test_gpu_default_lap_matches_cpu_f32_reference(fx):
    """Every step of the same f32 lap on the in-process CPU backend (scan
    integrator, the golden-certified path), run again on the GPU in the
    shipped configuration from the same carry; the GPU's own lap completes
    on track.  Same dtype on purpose: the learned lap is dtype-sensitive at
    the behavioural level (the f64 golden lap is 179 steps, the f32 lap
    about 130)."""
    ref_cpu = dc.lmpc_lap(dc.fixture(jax.devices("cpu")[0]), return_carries=True)
    dc.check_replay(dc.lmpc_replay_error(ref_cpu, fx), dc.CROSS_DEVICE_TOL)
    dc.check_lap_feasible(dc.lmpc_lap(fx))


def test_racing_game_flagship_on_device(fx):
    xc, _, ot, lap_steps = dc.racing_game(fx)
    dc.check_racing_lane(fx, xc, ot, lap_steps, 250)


def test_racing_game_fleet_every_lane_valid_on_device(fx):
    """64 vmapped racing-game laps (one integrator kernel over all lanes),
    every lane behaviourally gated."""
    xc0, xg0 = dc.fleet_starts(fx, 64)
    dc.check_fleet(fx, dc.racing_fleet(fx, xc0, xg0), 250)


def test_matmul_precision_on_device():
    """f32 matmuls run at full f32 on the card, not TF32."""
    dc.matmul_error()


@pytest.mark.parametrize("n", [20, 40])
def test_spd_solve_parity_on_device(n):
    dc.spd_solve_error(n, 256)


def test_spd_multi_rhs_parity_on_device():
    dc.spd_solve_error(20, 256, r=6)
