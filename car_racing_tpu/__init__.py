"""car_racing_tpu — a JAX framework for car-racing control and planning.

A from-scratch re-design of the capabilities of HybridRobotics/car-racing
built on JAX / XLA / Pallas / shard_map:

- ``ops``      jittable compute primitives: track geometry, vehicle dynamics,
               Bezier curves, and the interior-point / Riccati solver core that
               replaces every CasADi/IPOPT and cvxopt solve in the reference.
- ``models``   controller policies (PID, LQR, iLQR, MPC-LTI, MPC-CBF, LMPC,
               racing game) and vehicle models as pytree state + pure step fns.
- ``planning`` overtake planners with branch NLPs as one vmapped solver batch
               (replacing the reference's one-OS-process-per-branch design).
- ``parallel`` device-mesh sharding of branch/scenario sweeps (shard_map +
               collectives instead of ROS/multiprocess IPC).
- ``racing``   offboard simulator, plotting/animation, realtime frontend.

Every compiled entry point runs its matmuls at full f32 (``utils/numerics``),
not the TF32 an H100 would otherwise use.
"""

__version__ = "0.1.0"
