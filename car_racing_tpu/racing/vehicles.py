"""Vehicle models: host-side stateful shells around jitted kernels.

Mirrors the reference's model layer (car_racing/utils/base.py:716-943) in
API shape — the simulator steps vehicles through ``forward_one_step`` and
reads lap-structured logs — but every numeric path (dynamics substeps,
noise, predictions, Frenet conversions) is a jitted JAX kernel from
:mod:`car_racing_tpu.ops`.

``NoDynamicsModel`` replaces the reference's sympy-symbolic prescribed
motion (base.py:847-890) with polynomial coefficients evaluated by
``jnp.polyval`` — same expressiveness for the test workloads (linear s(t),
constant ey), jit/vmap friendly.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from ..ops import dynamics, track as track_ops
from ..utils import numerics
from ..utils.constants import U_DIM
from ..utils.params import CarParam, SystemParam

# Horizon-batched Frenet->global transform (single device call per horizon).
_frenet_to_global_batch = numerics.jit(
    jax.vmap(track_ops.frenet_to_global_state, in_axes=(None, 0))
)


class ModelBase:
    """Lap-structured logging + lifecycle (reference base.py:716-844)."""

    def __init__(self, name=None, param: CarParam | None = None, system_param=None):
        self.name = name
        self.param = param or CarParam.default()
        self.system_param = system_param
        self.no_dynamics = False
        self.time = 0.0
        self.timestep = None
        self.xcurv = None
        self.xglob = None
        self.u = None
        self.zero_noise_flag = False
        self.laps = 0
        self.realtime_flag = False
        self.track = None
        self.ctrl_policy = None
        # per-lap ring structures (base.py:26-34 analog)
        self.lap_times, self.lap_xcurvs, self.lap_xglobs, self.lap_inputs = [], [], [], []
        self.lap_times.append(self.time)
        self.times, self.xglobs, self.xcurvs, self.inputs = [], [], [], []
        # flat logs + planner artifacts (base.py:737-746)
        self.xglob_log, self.xcurv_log = [], []
        self.local_trajs, self.vehicles_interest = [], []
        self.splines, self.solver_time = [], []
        self.all_splines, self.all_local_trajs = [], []
        self.lmpc_prediction, self.mpc_cbf_prediction = [], []

    # ---- lifecycle -----------------------------------------------------

    def set_zero_noise(self):
        self.zero_noise_flag = True

    def set_timestep(self, dt):
        self.timestep = dt

    def set_state_curvilinear(self, xcurv):
        self.xcurv = np.asarray(xcurv, dtype=np.float64)

    def set_state_global(self, xglob):
        self.xglob = np.asarray(xglob, dtype=np.float64)

    def set_track(self, track):
        self.track = track
        self.lap_length = float(track.lap_length)
        self.lap_width = float(track.width)

    def set_ctrl_policy(self, ctrl_policy):
        self.ctrl_policy = ctrl_policy
        self.ctrl_policy.agent_name = self.name

    def start_logging(self):
        self.lap_xcurvs, self.lap_xglobs, self.lap_inputs = [], [], []
        self.lap_xcurvs.append(self.xcurv)
        self.lap_xglobs.append(self.xglob)

    # ---- stepping ------------------------------------------------------

    def calc_ctrl_input(self):
        self.ctrl_policy.set_state(self.xcurv, self.xglob)
        self.ctrl_policy.calc_input()
        self.u = self.ctrl_policy.get_input()

    def forward_dynamics(self, realtime_flag=False):
        raise NotImplementedError

    def forward_one_step(self, realtime_flag=False):
        if self.no_dynamics:
            self.forward_dynamics()
            self.update_memory()
        elif not realtime_flag:
            self.calc_ctrl_input()
            self.forward_dynamics(realtime_flag)
            self.ctrl_policy.set_state(self.xcurv, self.xglob)
            self.update_memory()
        else:
            self.forward_dynamics(realtime_flag)

    def update_memory(self):
        """Lap bookkeeping (base.py:795-819): on lap completion, wrap s,
        close the lap lists and seed the next lap."""
        xcurv = np.array(self.xcurv, copy=True)
        self.xglob_log.append(np.array(self.xglob, copy=True))
        self.xcurv_log.append(np.array(self.xcurv, copy=True))
        if xcurv[4] > self.lap_length:
            self.lap_xglobs.append(np.array(self.xglob, copy=True))
            self.lap_times.append(self.time)
            self.lap_xcurvs.append(xcurv)
            self.lap_inputs.append(np.array(self.u, copy=True))
            self.xglobs.append(self.lap_xglobs)
            self.times.append(self.lap_times)
            self.xcurvs.append(self.lap_xcurvs)
            self.inputs.append(self.lap_inputs)
            self.xcurv = np.array(self.xcurv, copy=True)
            self.xcurv[4] -= self.lap_length
            self.laps += 1
            self.lap_xglobs, self.lap_xcurvs, self.lap_inputs, self.lap_times = [], [], [], []
            self.lap_xglobs.append(np.array(self.xglob, copy=True))
            self.lap_times.append(self.time)
            self.lap_xcurvs.append(np.array(self.xcurv, copy=True))
        else:
            self.lap_xglobs.append(np.array(self.xglob, copy=True))
            self.lap_times.append(self.time)
            self.lap_xcurvs.append(xcurv)
            self.lap_inputs.append(np.array(self.u, copy=True))


class DynamicBicycleModel(ModelBase):
    """Dynamic bicycle vehicle (reference base.py:893-942 + offboard.py:46-94).

    The 100-substep Euler propagation runs as one jitted lax.scan
    (:func:`car_racing_tpu.ops.dynamics.propagate`)."""

    def __init__(self, name=None, param=None, system_param=None, seed: int = 0):
        super().__init__(name=name, param=param, system_param=system_param or SystemParam.default())
        self.dynamics_param = dynamics.BicycleParams.default()
        self._key = jax.random.PRNGKey(seed)

    def forward_dynamics(self, realtime_flag=False):
        if self.u is None and realtime_flag:
            self.time += self.timestep
            return
        u = jnp.asarray(self.u if self.u is not None else np.zeros(U_DIM))
        xg, xc = dynamics.propagate(
            self.track,
            self.dynamics_param,
            jnp.asarray(self.xglob),
            jnp.asarray(self.xcurv),
            u,
            control_dt=self.timestep,
        )
        if not self.zero_noise_flag:
            self._key, sub = jax.random.split(self._key)
            xc = dynamics.process_noise(sub, xc)
        self.xcurv = np.asarray(xc)
        self.xglob = np.asarray(xg)
        self.time += self.timestep

    def get_trajectory_nsteps(self, time, timestep, n):
        """Constant-velocity n-step forecast (offboard.py:80-94). Returns
        (xcurv_nsteps (X_DIM, n), xglob_nsteps (X_DIM, n))."""
        xc_traj, xg_traj = dynamics.const_velocity_prediction(
            self.track, jnp.asarray(self.xcurv), jnp.asarray(self.xglob), timestep, n
        )
        return np.asarray(xc_traj).T, np.asarray(xg_traj).T


class NoDynamicsModel(ModelBase):
    """Prescribed-motion obstacle: polynomial s(t), ey(t) (base.py:847-890)."""

    def __init__(self, name=None, param=None):
        super().__init__(name=name, param=param)
        self.no_dynamics = True
        self.s_coef = None
        self.ey_coef = None

    def set_state_curvilinear_func(self, s_coef, ey_coef):
        """Coefficients in ``jnp.polyval`` order (highest degree first):
        e.g. s(t) = 0.7 t + 5.5 -> s_coef = [0.7, 5.5]."""
        self.s_coef = np.asarray(s_coef, dtype=np.float64)
        self.ey_coef = np.asarray(ey_coef, dtype=np.float64)
        self.xcurv, self.xglob = self.get_estimation(0.0)

    def get_estimation(self, t0):
        s = float(np.polyval(self.s_coef, t0))
        ey = float(np.polyval(self.ey_coef, t0))
        vs = float(np.polyval(np.polyder(self.s_coef), t0)) if len(self.s_coef) > 1 else 0.0
        vey = float(np.polyval(np.polyder(self.ey_coef), t0)) if len(self.ey_coef) > 1 else 0.0
        xcurv = np.array([vs, vey, 0.0, 0.0, s, ey])
        xglob = np.asarray(
            track_ops.frenet_to_global_state(self.track, jnp.asarray(xcurv))
        )
        return xcurv, xglob

    def get_trajectory_nsteps(self, t0, delta_t, n):
        # One batched device call for the whole horizon: per-point
        # get_estimation() round-trips host<->device n times, which at
        # interconnect latency (~tens of ms each) dominated the iLQR and
        # MPC-CBF sim loops.  The polynomial part is host numpy; only the
        # Frenet->global transform touches the device, once.
        ts = self.time + delta_t * np.arange(n)
        s = np.polyval(self.s_coef, ts)
        ey = np.polyval(self.ey_coef, ts)
        zeros = np.zeros(n)
        vs = np.polyval(np.polyder(self.s_coef), ts) if len(self.s_coef) > 1 else zeros
        vey = np.polyval(np.polyder(self.ey_coef), ts) if len(self.ey_coef) > 1 else zeros
        xcurv_nsteps = np.stack([vs, vey, zeros, zeros, s, ey], axis=1)  # (n, X_DIM)
        xglob_nsteps = np.asarray(
            _frenet_to_global_batch(self.track, jnp.asarray(xcurv_nsteps))
        )
        return xcurv_nsteps.T, xglob_nsteps.T

    def forward_dynamics(self, realtime_flag=False):
        self.time += self.timestep
        self.xcurv, self.xglob = self.get_estimation(self.time)
