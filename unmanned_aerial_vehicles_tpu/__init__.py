"""Quadrotor GP-MPC framework in JAX.

A from-scratch JAX/XLA rebuild of the numerical core of the
``Grandediw/Unmanned_Aerial_Vehicles`` workspace (ROS 2 + PX4 SITL quadrotor
trajectory-tracking research comparing cascade PID, linear MPC and
GP-enhanced MPC).

Design (accelerator-first, not a port):

* Plants, controllers and references are **pure functions**; the ROS pub/sub
  graph of the reference collapses into a single fused XLA program per
  control tick, composed with ``jax.lax.scan`` for closed-loop rollouts and
  ``jax.vmap`` / ``jax.sharding`` for batched sweeps.
* The CasADi/Ipopt NLPs of the reference (``src/px4/mpc.py:1305-1646``,
  ``src/px4/mpc_FULL.py:86-549``) become condensed box-QPs solved with a
  fixed-iteration ADMM (``ops/qp.py``) and an SQP loop around it — no
  data-dependent control flow, fully jittable.
* The sklearn/NumPy Gaussian processes (``src/px4/simple_gp.py``,
  ``quadrotor_gp_mpc/quadrotor_gp_mpc/gaussian_process.py``) become a
  from-scratch JAX GP: Cholesky fits, jitted log-marginal-likelihood and
  batched posteriors (one fused Triton kernel for the batched mean on a
  GPU).

Sub-packages
------------
``models``        pure-JAX plants (double integrator, 12-state rigid body)
``trajectories``  10 analytic reference families + named configurations
``control``       cascade PID, geometric allocation, linear / SQP MPC
``gp``            from-scratch Gaussian process + residual-dynamics learning
``ops``           numerical kernels: box-QP ADMM, Riccati, RBF posterior
                  mean (Pallas on the Triton route)
``backend``       which backend runs which path; the compile cache
``loop``          fused closed-loop rollouts (scan / vmap)
``metrics``       in-graph tracking/solve metrics matching the reference
``parallel``      device-mesh sharding helpers for batch sweeps
``io``            flight-CSV datasets and checkpointing
``utils``         rotations, angle wrapping, small shared helpers
"""

__version__ = "0.1.0"
