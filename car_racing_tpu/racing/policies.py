"""Controller policies: host-side lifecycle shells over jitted solvers.

The analog of the reference's policy classes (car_racing/utils/base.py:
17-348 and racing/offboard.py:13-43): each policy owns its parameters,
tracks time/lap bookkeeping, and delegates every solve to the pure jitted
functions in :mod:`car_racing_tpu.models.controllers`.

Planner-artifact logging mirrors the reference: non-racing-game policies
append ``None`` rows to the ego's artifact logs each step
(base.py:107-117 etc.) so plotting/animation code can index uniformly.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from ..models import controllers
from ..ops import track as track_ops
from ..utils.constants import U_DIM, X_DIM
from ..utils.profiling import GLOBAL_TIMER
from ..utils.params import (
    ILQRParam,
    LQRParam,
    MPCCBFParam,
    MPCParam,
    SystemParam,
)


class ControlBase:
    """Lifecycle + memory (reference base.py:17-94)."""

    def __init__(self):
        self.agent_name = None
        self.time = 0.0
        self.timestep = None
        self.x = None
        self.xglob = None
        self.u = None
        self.realtime_flag = False
        self.lap_times, self.lap_xcurvs, self.lap_xglobs, self.lap_inputs = [], [], [], []
        self.lap_times.append(self.time)
        self.times, self.xglobs, self.xcurvs, self.inputs = [], [], [], []
        self.laps = 0
        self.track = None
        self.opti_traj_xcurv = None
        self.opti_traj_xglob = None
        self.racing_sim = None

    def set_track(self, track):
        self.track = track
        self.lap_length = float(track.lap_length)
        self.lap_width = float(track.width)

    def set_opti_traj(self, opti_traj_xcurv, opti_traj_xglob):
        self.opti_traj_xcurv = opti_traj_xcurv
        self.opti_traj_xglob = opti_traj_xglob

    def set_racing_sim(self, racing_sim):
        self.racing_sim = racing_sim

    def set_timestep(self, timestep):
        self.timestep = timestep

    def set_target_speed(self, vt):
        self.vt = vt

    def set_target_deviation(self, eyt):
        self.eyt = eyt

    def set_state(self, xcurv, xglob):
        self.x = xcurv
        self.xglob = xglob

    def calc_input(self):
        raise NotImplementedError

    def get_input(self):
        return self.u

    def _log_none_artifacts(self, solve_ms=None):
        """Placeholder artifact rows for the ego (base.py:107-117);
        ``solve_ms`` records the step's measured solve latency (the
        reference logs per-solve wall time, control.py:24,60,...)."""
        if self.agent_name != "ego" or self.racing_sim is None:
            return
        ego = self.racing_sim.vehicles.get("ego")
        if ego is None:
            return
        ego.local_trajs.append(None)
        ego.vehicles_interest.append(None)
        ego.splines.append(None)
        ego.solver_time.append(solve_ms)
        ego.all_splines.append(None)
        ego.all_local_trajs.append(None)
        ego.lmpc_prediction.append(None)
        ego.mpc_cbf_prediction.append(None)

    def _xtarget(self):
        return np.array([self.vt, 0, 0, 0, 0, self.eyt])


class PIDTracking(ControlBase):
    """(reference base.py:97-118)"""

    def __init__(self, vt=0.6, eyt=0.0):
        super().__init__()
        self.set_target_speed(vt)
        self.set_target_deviation(eyt)

    def calc_input(self):
        with GLOBAL_TIMER.measure("pid"):
            self.u = np.asarray(controllers.pid(jnp.asarray(self.x), jnp.asarray(self._xtarget())))
        self._log_none_artifacts(GLOBAL_TIMER.samples["pid"][-1])
        self.time += self.timestep


class LQRTracking(ControlBase):
    """(reference base.py:141-164)"""

    def __init__(self, lqr_param: LQRParam | None = None, system_param: SystemParam | None = None):
        super().__init__()
        self.lqr_param = lqr_param or LQRParam.default()
        self.system_param = system_param or SystemParam.default()
        self.set_target_speed(float(self.lqr_param.vt))
        self.set_target_deviation(float(self.lqr_param.eyt))

    def calc_input(self):
        with GLOBAL_TIMER.measure("lqr"):
            self.u = np.asarray(
                controllers.lqr(jnp.asarray(self.x), jnp.asarray(self._xtarget()), self.lqr_param)
            )
        self._log_none_artifacts(GLOBAL_TIMER.samples["lqr"][-1])
        self.time += self.timestep


class MPCTracking(ControlBase):
    """(reference base.py:246-269)"""

    def __init__(self, mpc_lti_param: MPCParam | None = None, system_param: SystemParam | None = None):
        super().__init__()
        self.mpc_lti_param = mpc_lti_param or MPCParam.default()
        self.system_param = system_param or SystemParam.default()
        self.set_target_speed(float(self.mpc_lti_param.vt))
        self.set_target_deviation(float(self.mpc_lti_param.eyt))
        self._u_warm = None

    def calc_input(self):
        N = self.mpc_lti_param.num_horizon
        with GLOBAL_TIMER.measure("mpc_lti"):
            u0, U, _ = controllers.mpc_lti(
                jnp.asarray(self.x),
                jnp.asarray(self._xtarget()),
                self.mpc_lti_param,
                self.system_param,
                self.track.width,
                u_warm=self._u_warm,
                return_traj=True,
            )
            self.u = np.asarray(u0)
        # shift-warm-start the next solve
        flat = np.asarray(U).reshape(-1)
        self._u_warm = jnp.asarray(np.concatenate([flat[U_DIM:], flat[-U_DIM:]]))
        self._log_none_artifacts(GLOBAL_TIMER.samples["mpc_lti"][-1])
        self.time += self.timestep


class iLQRRacing(ControlBase):
    """(reference base.py:189-223; control.py:64-195)

    Obstacle handling replicates the reference quirk: only the *last*
    non-ego vehicle's prediction is used (control.py:100-105)."""

    def __init__(
        self,
        ilqr_param: ILQRParam | None = None,
        system_param: SystemParam | None = None,
        warm_start: bool = True,
    ):
        super().__init__()
        self.ilqr_param = ilqr_param or ILQRParam.default()
        self.system_param = system_param or SystemParam.default()
        self.set_target_speed(float(self.ilqr_param.vt))
        self.set_target_deviation(float(self.ilqr_param.eyt))
        # Default ON (benched 16% faster, parity-tested): shift-warm-starting
        # the nonconvex iLQR solve changes which local optimum it lands in —
        # cold zero-init (warm_start=False) settles BEHIND a blocking car
        # (the reference's behavior, control.py:64-195, pinned by
        # tests/test_ilqr.py's cold variant); warm-started solves keep
        # momentum and find the collision-free PASSING optimum in a few
        # Levenberg iterations instead of ~10-20.
        self.warm_start = warm_start
        self._u_warm = None  # shifted previous solution (cold first solve)

    def calc_input(self):
        vehicles = self.racing_sim.vehicles
        obs_traj = None
        for name in vehicles:
            if name != self.agent_name:
                xc, _ = vehicles[name].get_trajectory_nsteps(
                    self.time, self.timestep, self.ilqr_param.num_horizon + 1
                )
                obs_traj = xc  # reference keeps only the last one
        ego = vehicles[self.agent_name]
        agent_half = jnp.asarray([float(ego.param.length) / 2, float(ego.param.width) / 2])
        obs_half = agent_half  # reference hardcodes car1's dims == CarParam
        solve_args = (
            jnp.asarray(self.x),
            jnp.asarray(self._xtarget()),
            self.ilqr_param,
            jnp.asarray(obs_traj.T),
            agent_half,
            obs_half,
        )
        with GLOBAL_TIMER.measure("ilqr"):
            if self.warm_start:
                u0, U, _ = controllers.ilqr(
                    *solve_args, u_init=self._u_warm, return_seq=True
                )
                # shift-warm-start the next solve (same shift as the fused
                # rollout); cold path skips the sequence materialization
                self._u_warm = jnp.concatenate([U[1:], U[-1:]], axis=0)
            else:
                u0 = controllers.ilqr(*solve_args)
            self.u = np.asarray(u0)
        self._log_none_artifacts(GLOBAL_TIMER.samples["ilqr"][-1])
        self.time += self.timestep


MAX_OBSTACLES = 4  # static shape bound for vmapped CBF problems

# fixed-iteration budgets for the CBF IPM: cold solves (first step, no
# previous iterate) get the full budget; shift-warm-started solves converge
# in far fewer Newton steps, so the compiled warm variant runs a shorter
# scan — that's where warm starting buys latency in a fixed-iteration design
CBF_ITERS_COLD = 40
CBF_ITERS_WARM = 20


# (z, lam, s) stage-shift shared with the fused on-device rollouts
_shift_cbf_warm = controllers.shift_cbf_warm


class MPCCBFRacing(ControlBase):
    """(reference base.py:294-348; control.py:476-607)"""

    def __init__(self, mpc_cbf_param: MPCCBFParam | None = None, system_param: SystemParam | None = None):
        super().__init__()
        self.mpc_cbf_param = mpc_cbf_param or MPCCBFParam.default()
        self.system_param = system_param or SystemParam.default()
        self.set_target_speed(float(self.mpc_cbf_param.vt))
        self.set_target_deviation(float(self.mpc_cbf_param.eyt))
        self.realtime_flag = False
        self._z_warm = None

    def calc_input(self):
        vehicles = self.racing_sim.vehicles
        N = self.mpc_cbf_param.num_horizon
        dtype = np.float64
        obs_trajs = np.zeros((MAX_OBSTACLES, N + 1, X_DIM), dtype)
        obs_mask = np.zeros(MAX_OBSTACLES, bool)
        obs_halfs = np.ones((MAX_OBSTACLES, 2), dtype)
        i = 0
        for name in vehicles:
            if name == self.agent_name or i >= MAX_OBSTACLES:
                continue
            xc, _ = vehicles[name].get_trajectory_nsteps(self.time, self.timestep, N + 1)
            obs_trajs[i] = xc.T
            obs_mask[i] = True  # distance gating is applied inside the solver
            obs_halfs[i] = [
                float(vehicles[name].param.length) / 2,
                float(vehicles[name].param.width) / 2,
            ]
            i += 1
        # gating (control.py:499-523): mask out far-away obstacles
        gate = np.asarray(
            controllers.obstacle_gate_mask(
                jnp.asarray(self.x),
                jnp.asarray(obs_trajs[:, 0, 4]),
                jnp.asarray(self.lap_length),
            )
        )
        obs_mask &= gate
        ego = vehicles[self.agent_name]
        agent_half = jnp.asarray([float(ego.param.length) / 2, float(ego.param.width) / 2])
        with GLOBAL_TIMER.measure("mpccbf"):
            u0, U, X, sol = controllers.mpccbf(
                jnp.asarray(self.x),
                jnp.asarray(self._xtarget()),
                self.mpc_cbf_param,
                self.system_param,
                self.track.width,
                jnp.asarray(obs_trajs),
                jnp.asarray(obs_mask),
                agent_half,
                jnp.asarray(obs_halfs),
                jnp.asarray(self.lap_length),
                warm=self._z_warm,
                return_traj=True,
                iters=CBF_ITERS_COLD if self._z_warm is None else CBF_ITERS_WARM,
            )
            self.u = np.asarray(u0)
        self._z_warm = _shift_cbf_warm(sol, N, MAX_OBSTACLES)
        self._log_none_artifacts(GLOBAL_TIMER.samples["mpccbf"][-1])
        self.time += self.timestep


class LMPCPrediction:
    """Open-loop prediction recorder (reference lmpc_helper.py:321-340)."""

    def __init__(self, num_horizon=12, points_lmpc=5000, num_ss_points=44, lap_number=None):
        self.predicted_xcurv = np.zeros((num_horizon + 1, X_DIM, points_lmpc, lap_number))
        self.predicted_u = np.zeros((num_horizon, U_DIM, points_lmpc, lap_number))
        self.ss_used = np.zeros((X_DIM, num_ss_points, points_lmpc, lap_number))
        self.Qfun_used = np.zeros((num_ss_points, points_lmpc, lap_number))


class LMPCRacingGame(ControlBase):
    """Learning MPC + racing game orchestrator (reference base.py:411-655).

    Owns the sampled safe set (sentinel-preallocated arrays exactly like
    base.py:430-439), dispatches between the LMPC solve and the overtake
    planner + multi-agent CBF tracker, and records open-loop predictions.
    All numerics (regression, safe-set selection, QP solves, planner branch
    batch) are jitted JAX kernels.
    """

    def __init__(self, lmpc_param, racing_game_param=None, system_param=None,
                 timestep=None, lap_number=None, time_lmpc=None, path_planner=False,
                 mesh=None):
        """``mesh``: optional branch-only device mesh
        (parallel/mesh.make_branch_mesh) — the overtake planner's corridor
        QP batch + fallback + selection then run sharded across the mesh
        (parallel/mesh.corridor_sweep) instead of on one chip."""
        from ..planning import overtake
        from ..utils import params as params_mod

        super().__init__()
        self.lmpc_param = lmpc_param
        self.racing_game_param = racing_game_param or params_mod.RacingGameParam.default()
        self.system_param = system_param or SystemParam.default()
        self.path_planner = path_planner
        if path_planner:
            self.overtake_planner = overtake.OvertakePathPlanner(self.racing_game_param)
        else:
            self.overtake_planner = overtake.OvertakeTrajPlanner(
                self.racing_game_param, mesh=mesh
            )
        self.x_pred = None
        self.u_pred = None
        self.lin_points = None
        self.lin_input = None
        self.lap_number = lap_number
        self.time_lmpc = time_lmpc
        num_points = int(time_lmpc / timestep) + 1
        self.num_points = num_points
        self.time_ss = 10000 * np.ones(lap_number).astype(int)
        self.ss_xcurv = 1e4 * np.ones((num_points, X_DIM, lap_number))
        self.u_ss = 1e4 * np.ones((num_points, U_DIM, lap_number))
        self.Qfun = 0 * np.ones((num_points, lap_number))
        self.ss_glob = 1e4 * np.ones((num_points, X_DIM, lap_number))
        self.iter = 0
        self.time_in_iter = 0
        self.openloop_prediction = None
        self.old_ey = None
        self.old_direction_flag = None
        self._z_warm = None
        self._z_warm_ma = None  # warm start for the multi-agent CBF tracker

    def set_vehicles_track(self):
        vehicles = self.racing_sim.vehicles
        self.overtake_planner.track = self.track
        self.overtake_planner.vehicles = vehicles

    # ---- learning-side bookkeeping (base.py:585-655) -------------------

    def estimate_ABC(self):
        """Time-varying (A, B, C) over the horizon from kernel-weighted
        local regression on the last two laps (base.py:585-622), as one
        vmapped kernel."""
        from ..ops import lmpc_learning, track as track_ops

        N = self.lmpc_param.num_horizon
        used = [self.iter - 2, self.iter - 1]
        ss = np.stack([self.ss_xcurv[:, :, i] for i in used])  # (2, P, X)
        us = np.stack([self.u_ss[:, :, i] for i in used])
        valid = np.zeros((2, self.num_points), bool)
        for li, it in enumerate(used):
            valid[li, : max(self.time_ss[it] - 1, 0)] = True
        lin_points = np.asarray(self.lin_points[:N])
        lin_inputs = np.asarray(self.lin_input[:N])
        curvs = np.asarray(
            track_ops.curvature_batch(self.track, jnp.asarray(np.mod(lin_points[:, 4], self.lap_length)))
        )
        A, B, C = lmpc_learning.estimate_abc_horizon(
            jnp.asarray(lin_points),
            jnp.asarray(lin_inputs),
            jnp.asarray(ss),
            jnp.asarray(us),
            jnp.asarray(valid),
            jnp.asarray(curvs),
            jnp.asarray(self.timestep),
        )
        return np.asarray(A), np.asarray(B), np.asarray(C)

    def add_point(self, x, u, i):
        counter = self.time_ss[self.iter - 1]
        self.ss_xcurv[counter + i + 1, :, self.iter - 1] = np.asarray(x) + np.array(
            [0, 0, 0, 0, self.lap_length, 0]
        )
        self.u_ss[counter + i + 1, :, self.iter - 1] = np.asarray(u)

    def add_trajectory(self, ego, lap_number):
        from ..ops import lmpc_learning

        it = self.iter
        end_iter = int(round((ego.times[lap_number][-1] - ego.times[lap_number][0]) / ego.timestep))
        self.time_ss[it] = end_iter
        xcurvs = np.stack(ego.xcurvs[lap_number], axis=0)
        self.ss_xcurv[0 : end_iter + 1, :, it] = xcurvs[0 : end_iter + 1]
        xglobs = np.stack(ego.xglobs[lap_number], axis=0)
        self.ss_glob[0 : end_iter + 1, :, it] = xglobs[0 : end_iter + 1]
        inputs = np.stack(ego.inputs[lap_number], axis=0)
        self.u_ss[0:end_iter, :, it] = inputs[0:end_iter]
        # host (shape-proof) cost-to-go: lap lengths vary per lap, and the
        # traced variant would recompile inside every lap-boundary tick
        qcol = lmpc_learning.compute_cost_host(
            xcurvs[0 : end_iter + 1], float(self.lap_length)
        )
        self.Qfun[0 : end_iter + 1, it] = qcol
        for i in range(1, self.Qfun.shape[0]):
            if self.Qfun[i, it] == 0:
                self.Qfun[i, it] = self.Qfun[i - 1, it] - 1
        if self.iter == 0:
            N = self.lmpc_param.num_horizon
            self.lin_points = self.ss_xcurv[1 : N + 2, :, it]
            self.lin_input = self.u_ss[1 : N + 1, :, it]
        self.iter += 1
        self.time_in_iter = 0

    # ---- control step (base.py:456-583) --------------------------------

    def calc_input(self):
        from ..models import controllers as ctrl
        from ..ops import lmpc_learning, track as track_ops

        self.overtake_planner.agent_name = self.agent_name
        self.overtake_planner.opti_traj_xcurv = self.opti_traj_xcurv
        self.overtake_planner.timestep = self.timestep
        N = self.lmpc_param.num_horizon
        A_tv, B_tv, C_tv = self.estimate_ABC()
        x = np.array(self.x, copy=True)
        x[4] = np.mod(x[4], self.lap_length)
        u_old = np.zeros(U_DIM) if self.u_pred is None else np.array(self.u_pred[0])
        overtake_flag, vehicles_interest = self.overtake_planner.get_overtake_flag(x)
        vehicles = self.racing_sim.vehicles
        ego_model = vehicles["ego"]

        if not overtake_flag:
            # select safe-set points from the last num_ss_iter laps
            K_per = self.lmpc_param.num_ss_points // self.lmpc_param.num_ss_iter
            pts, qs = [], []
            for jj in range(self.lmpc_param.num_ss_iter):
                it = self.iter - jj - 1
                p, q = lmpc_learning.select_points(
                    jnp.asarray(self.ss_xcurv[:, :, it]),
                    jnp.asarray(self.Qfun[:, it]),
                    jnp.asarray(x),
                    K_per,
                    self.lmpc_param.shift,
                )
                pts.append(np.asarray(p))
                qs.append(np.asarray(q))
            ss_points = np.concatenate(pts, axis=1)  # (X_DIM, K)
            qfun_sel = np.concatenate(qs)
            with GLOBAL_TIMER.measure("lmpc"):
                U, X, sol = ctrl.lmpc(
                    jnp.asarray(x),
                    self.lmpc_param,
                    jnp.asarray(A_tv),
                    jnp.asarray(B_tv),
                    jnp.asarray(C_tv),
                    jnp.asarray(ss_points),
                    jnp.asarray(qfun_sel),
                    jnp.asarray(u_old),
                    self.system_param,
                    jnp.asarray(self.lap_length),
                    jnp.asarray(self.lap_width),
                    z_warm=self._z_warm,
                    num_horizon=N,
                )
                self.u_pred = np.asarray(U)
                self.x_pred = np.asarray(X)
            self.u = self.u_pred[0]
            # shift warm start: inputs shifted one stage, lambda reused
            zw = np.concatenate(
                [self.u_pred[1:].reshape(-1), self.u_pred[-1], np.asarray(sol.z)[N * U_DIM:]]
            )
            self._z_warm = jnp.asarray(zw)
            self._z_warm_ma = None  # next overtake episode starts cold
            self.old_ey = None
            self.old_direction_flag = None
            # linearization points for the next regression
            self.lin_points = np.concatenate([self.x_pred[1:], self.x_pred[-1:]], axis=0)
            self.lin_input = np.concatenate([self.u_pred[1:], self.u_pred[-1:]], axis=0)
            if self.openloop_prediction is not None:
                op = self.openloop_prediction
                op.predicted_xcurv[:, :, self.time_in_iter, self.iter] = self.x_pred
                op.predicted_u[:, :, self.time_in_iter, self.iter] = self.u_pred
                op.ss_used[:, :, self.time_in_iter, self.iter] = ss_points
                op.Qfun_used[:, self.time_in_iter, self.iter] = qfun_sel
            self.add_point(self.x, self.u, self.time_in_iter)
            self.time_in_iter += 1
            # artifacts: prediction in global frame
            xp = np.mod(self.x_pred[:, 4], self.lap_length)
            xy = np.asarray(
                track_ops.frenet_to_global_xy_batch(
                    self.track, jnp.asarray(xp), jnp.asarray(self.x_pred[:, 5])
                )
            )
            x_pred_xglob = np.concatenate([self.x_pred[:, :4], xy], axis=1)
            x_pred_xglob[:, 3] = np.asarray(
                track_ops.frenet_to_global_psi_batch(
                    self.track, jnp.asarray(xp), jnp.asarray(self.x_pred[:, 5])
                )
            )
            ego_model.local_trajs.append(None)
            ego_model.vehicles_interest.append(None)
            ego_model.splines.append(None)
            ego_model.solver_time.append(GLOBAL_TIMER.samples["lmpc"][-1])
            ego_model.all_splines.append(None)
            ego_model.all_local_trajs.append(None)
            ego_model.lmpc_prediction.append(x_pred_xglob)
            ego_model.mpc_cbf_prediction.append(None)
        else:
            with GLOBAL_TIMER.measure("overtake_planner"):
                if self.path_planner:
                    result = self.overtake_planner.get_local_path(x, self.time, vehicles_interest)
                else:
                    result = self.overtake_planner.get_local_traj(
                        x, self.time, vehicles_interest,
                        A_tv, B_tv, C_tv, self.old_ey, self.old_direction_flag,
                    )
            (traj_xcurv, traj_xglob, direction_flag, sorted_vehicles,
             bezier_xglob, solve_time, all_bezier_xglob, all_traj_xglob) = result
            self.old_ey = traj_xcurv[-1, 5]
            self.old_direction_flag = direction_flag
            ego_model.local_trajs.append(traj_xglob)
            ego_model.vehicles_interest.append(vehicles_interest)
            ego_model.splines.append(bezier_xglob)
            ego_model.solver_time.append(solve_time)
            ego_model.all_splines.append(all_bezier_xglob)
            ego_model.all_local_trajs.append(all_traj_xglob)

            # multi-agent CBF tracker on the planned trajectory
            Nc = self.racing_game_param.num_horizon_ctrl
            vx = x[0]
            s_stage = vx * 0.1 * np.arange(1, Nc + 1) + x[4]
            s_stage = np.clip(s_stage, traj_xcurv[0, 4], traj_xcurv[-1, 4])
            ey_t = np.interp(s_stage, traj_xcurv[:, 4], traj_xcurv[:, 5])
            x_targets = np.zeros((Nc, X_DIM))
            x_targets[:, 0] = vx
            x_targets[:, 5] = ey_t
            obs_trajs = np.zeros((MAX_OBSTACLES, Nc + 1, X_DIM))
            obs_mask = np.zeros(MAX_OBSTACLES, bool)
            obs_halfs = np.ones((MAX_OBSTACLES, 2))
            for i, name in enumerate(sorted_vehicles[:MAX_OBSTACLES]):
                xc, _ = vehicles[name].get_trajectory_nsteps(self.time, self.timestep, Nc + 1)
                obs_trajs[i] = xc.T
                obs_mask[i] = True
                obs_halfs[i] = [
                    float(vehicles[name].param.length) / 2,
                    float(vehicles[name].param.width) / 2,
                ]
            gate = np.asarray(
                ctrl.obstacle_gate_mask(
                    jnp.asarray(x), jnp.asarray(obs_trajs[:, 0, 4]), jnp.asarray(self.lap_length)
                )
            )
            obs_mask &= gate
            agent_half = jnp.asarray(
                [float(ego_model.param.length) / 2, float(ego_model.param.width) / 2]
            )
            # runtime-selected cold/warm tracker configuration
            # (mpc_multi_agents warm_select): ONE compiled program for both
            # the episode-first cold solve (warm=None init, CBF_ITERS_COLD)
            # and the warm continuation (shifted triple, CBF_ITERS_WARM) —
            # the SAME graph the fused racing game runs, which is what
            # keeps the host loop and racing/fused.rollout_racing_game
            # bit-identical per step (compilation-level rounding differs
            # between the merged and two-branch formulations by ~1e-13,
            # which closed-loop chaos amplifies into different laps)
            use_warm = self._z_warm_ma is not None
            nz_t = Nc * U_DIM + MAX_OBSTACLES * (Nc + 1)
            m_t = 2 * Nc * U_DIM + 4 * Nc + MAX_OBSTACLES * (2 * Nc + 1)
            trip = (
                self._z_warm_ma
                if use_warm
                else (
                    jnp.zeros(nz_t, x.dtype),
                    jnp.full((m_t,), 1.0, x.dtype),
                    jnp.full((m_t,), 0.1, x.dtype),
                )  # ignored placeholder on the cold side
            )
            with GLOBAL_TIMER.measure("mpc_multi_agents"):
                u0, U, X, ma_sol = ctrl.mpc_multi_agents(
                    jnp.asarray(x),
                    jnp.asarray(x_targets),
                    self.racing_game_param.A,
                    self.racing_game_param.B,
                    self.racing_game_param.Q,
                    self.racing_game_param.R,
                    self.system_param,
                    self.track.width,
                    jnp.asarray(obs_trajs),
                    jnp.asarray(obs_mask),
                    agent_half,
                    jnp.asarray(obs_halfs),
                    jnp.asarray(self.lap_length),
                    iters=CBF_ITERS_COLD,
                    warm_select=(jnp.asarray(use_warm), trip),
                    iters_warm=CBF_ITERS_WARM,
                )
                self.u = np.asarray(u0)
            # a failed solve (its iterate nowhere near feasible) seeds
            # nothing: the next step solves cold
            self._z_warm_ma = (
                _shift_cbf_warm(ma_sol, Nc, MAX_OBSTACLES)
                if float(ma_sol.kkt_res) < ctrl.WARM_RES_MAX
                else None
            )
            self._z_warm = None  # LMPC resumes cold after the overtake
            x_pred = np.asarray(X)
            # keep linearization points moving during overtakes
            self.lin_points = np.concatenate([x_pred[1:], x_pred[-1:]], axis=0)
            u_pred = np.asarray(U)
            self.lin_input = np.concatenate([u_pred[1:], u_pred[-1:]], axis=0)
            if self.lin_points.shape[0] < N + 1:
                pad = N + 1 - self.lin_points.shape[0]
                self.lin_points = np.concatenate(
                    [self.lin_points, np.repeat(self.lin_points[-1:], pad, axis=0)], axis=0
                )
                self.lin_input = np.concatenate(
                    [self.lin_input, np.repeat(self.lin_input[-1:], pad, axis=0)], axis=0
                )
            self.add_point(self.x, self.u, self.time_in_iter)
            self.time_in_iter += 1
            xp = np.mod(x_pred[:, 4], self.lap_length)
            xy = np.asarray(
                track_ops.frenet_to_global_xy_batch(
                    self.track, jnp.asarray(xp), jnp.asarray(x_pred[:, 5])
                )
            )
            x_pred_xglob = np.concatenate([x_pred[:, :4], xy], axis=1)
            ego_model.lmpc_prediction.append(None)
            ego_model.mpc_cbf_prediction.append(x_pred_xglob)
        self.time += self.timestep
