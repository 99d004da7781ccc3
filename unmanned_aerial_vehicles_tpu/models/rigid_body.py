"""12-state rigid-body quadrotor plant (pure JAX).

State  ``[x, y, z, vx, vy, vz, phi, theta, psi, p, q, r]``
Control ``[T, tau_phi, tau_theta, tau_psi]`` (thrust in N, torques in Nm).

Re-derivation of the reference plant
``/root/reference/quadrotor_gp_mpc/quadrotor_gp_mpc/quadrotor_dynamics.py:148-228``:

* translational:  m * a = R @ [0,0,T] + [0,0,-m g] - k_l * ||v|| * v
* attitude:       d(euler)/dt = W(phi, theta) @ [p, q, r]
* rotational:     I * dw/dt  = tau - w x (I w) - k_a * w
* optional additive 12-D residual on the state derivative (the GP hook,
  ``quadrotor_dynamics.py:209-211``).

With ``k_drag_* = 0`` this is also the forward-Euler prediction model of the
12-state MPC (``/root/reference/src/px4/mpc_FULL.py:150-250``) and, with the
gz-quadrotor params, the model of the cvxpy LTV-MPC
(``quadrotor_gp_mpc/mpc_controller.py:143-190``).

All functions broadcast over leading batch dimensions and are differentiable
(the linearisation used by the SQP MPC is ``jax.jacfwd`` of
``rigid_body_derivative`` — replacing the reference's eps=1e-8 finite
differences at ``mpc_controller.py:318-350``).
"""

from __future__ import annotations

import jax.numpy as jnp

from ..utils.rotations import euler_rate_transform, euler_to_rotation_matrix
from .params import RigidBodyParams

STATE_DIM = 12
CONTROL_DIM = 4


def rigid_body_derivative(
    state: jnp.ndarray,
    control: jnp.ndarray,
    params: RigidBodyParams,
    residual: jnp.ndarray | None = None,
) -> jnp.ndarray:
    """Continuous-time state derivative; ``quadrotor_dynamics.py:148-213``."""
    vel = state[..., 3:6]
    phi, theta, psi = state[..., 6], state[..., 7], state[..., 8]
    omega = state[..., 9:12]

    thrust = control[..., 0]
    torques = control[..., 1:4]

    R = euler_to_rotation_matrix(phi, theta, psi)
    thrust_world = R[..., :, 2] * thrust[..., None]

    # drag acts on the airspeed (v - wind); zero wind (the default, and the
    # reference's only mode) reduces to the reference's ground-velocity drag.
    airspeed_vec = vel - jnp.asarray(params.wind, state.dtype)
    # gradient-safe ||.||: exact forward value, zero (sub)gradient at 0 —
    # the SQP controllers jacfwd through this at hover, where a plain norm's
    # derivative is NaN.
    sq = jnp.sum(airspeed_vec**2, axis=-1, keepdims=True)
    speed = jnp.where(sq > 0.0, jnp.sqrt(jnp.where(sq > 0.0, sq, 1.0)), 0.0)
    drag = -params.k_drag_linear * speed * airspeed_vec

    gravity = jnp.zeros_like(vel).at[..., 2].set(-params.mass * params.gravity)
    acceleration = (thrust_world + gravity + drag) / params.mass

    W = euler_rate_transform(phi, theta)
    attitude_dot = jnp.einsum("...ij,...j->...i", W, omega)

    inertia = jnp.asarray(params.inertia_diag, state.dtype)  # avoid x64 promotion
    i_omega = inertia * omega
    gyroscopic = jnp.cross(omega, i_omega)
    angular_drag = -params.k_drag_angular * omega
    angular_acceleration = (torques - gyroscopic + angular_drag) / inertia

    deriv = jnp.concatenate(
        [vel, acceleration, attitude_dot, angular_acceleration], axis=-1
    )
    if residual is not None:
        deriv = deriv + residual
    return deriv


def rigid_body_rk4_step(
    state: jnp.ndarray,
    control: jnp.ndarray,
    params: RigidBodyParams,
    dt: float,
    residual: jnp.ndarray | None = None,
) -> jnp.ndarray:
    """Classic RK4 with zero-order-hold control; ``quadrotor_dynamics.py:215-223``."""

    def f(x):
        return rigid_body_derivative(x, control, params, residual)

    k1 = f(state)
    k2 = f(state + 0.5 * dt * k1)
    k3 = f(state + 0.5 * dt * k2)
    k4 = f(state + dt * k3)
    return state + (dt / 6.0) * (k1 + 2.0 * k2 + 2.0 * k3 + k4)


def rigid_body_rk4_substeps(
    state: jnp.ndarray,
    control: jnp.ndarray,
    params: RigidBodyParams,
    dt: float,
    substeps: int = 1,
    residual: jnp.ndarray | None = None,
) -> jnp.ndarray:
    """``substeps`` RK4 steps of ``dt / substeps`` under one held control."""
    for _ in range(substeps):
        state = rigid_body_rk4_step(state, control, params, dt / substeps, residual)
    return state


def rigid_body_euler_step(
    state: jnp.ndarray,
    control: jnp.ndarray,
    params: RigidBodyParams,
    dt: float,
    residual: jnp.ndarray | None = None,
) -> jnp.ndarray:
    """Forward Euler — the 12-state MPC prediction model (``mpc_FULL.py:339``)."""
    return state + dt * rigid_body_derivative(state, control, params, residual)
