"""Stateless PID step with explicit carry (scan-composable).

Functional rewrite of the reference's stateful ``PIDController``
(``/root/reference/src/px4/cascade_pid_demo.py:25-84``): same anti-windup
integral clamp, error-difference derivative, symmetric output limit, and the
"first call returns zero" initialisation — expressed as
``(gains, carry, setpoint, measurement, dt) -> (output, carry)`` so nine of
them vectorise into one fused cascade update instead of nine Python objects.

Gains are pytree dataclasses, so a whole gain *batch* can be swept with
``vmap`` (BASELINE.json config 5).
"""

from __future__ import annotations

from .. import struct
import jax.numpy as jnp


@struct.dataclass
class PIDGains:
    kp: float = 1.0
    ki: float = 0.0
    kd: float = 0.0
    max_output: float = 5.0
    max_integral: float = 10.0


@struct.dataclass
class PIDState:
    integral: jnp.ndarray
    previous_error: jnp.ndarray
    initialized: jnp.ndarray  # bool; first update returns 0 like the reference


def pid_init(shape=(), dtype=jnp.float32) -> PIDState:
    zeros = jnp.zeros(shape, dtype)
    return PIDState(
        integral=zeros, previous_error=zeros, initialized=jnp.zeros(shape, bool)
    )


def pid_step(
    gains: PIDGains,
    state: PIDState,
    setpoint: jnp.ndarray,
    current: jnp.ndarray,
    dt: float,
):
    """One PID update; mirrors ``cascade_pid_demo.py:41-77`` semantics."""
    error = setpoint - current

    integral = jnp.clip(
        state.integral + error * dt, -gains.max_integral, gains.max_integral
    )
    derivative = (error - state.previous_error) / dt

    output = gains.kp * error + gains.ki * integral + gains.kd * derivative
    output = jnp.clip(output, -gains.max_output, gains.max_output)

    # First call: initialise and output zero (reference :47-50).
    output = jnp.where(state.initialized, output, jnp.zeros_like(output))
    new_state = PIDState(
        integral=jnp.where(state.initialized, integral, state.integral),
        previous_error=jnp.where(state.initialized, error, state.previous_error),
        initialized=jnp.ones_like(state.initialized),
    )
    return output, new_state
