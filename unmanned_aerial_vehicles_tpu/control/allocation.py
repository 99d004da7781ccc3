"""Control allocation: world accelerations / torques -> PX4-style commands.

Functional rewrites of the reference's L3 allocation layer:

* ``geometric_control_allocation`` — desired world acceleration + yaw ->
  normalized thrust, attitude setpoint and body-rate command via an attitude
  PID (Kp=3.2, Ki=0.6, Kd=0.6), ``/root/reference/src/px4/mpc.py:2057-2113``.
  Carried state is the attitude-error integral (clipped, ``mpc.py`` node
  fields ``attitude_integral``/``integral_max``).
* ``torque_to_px4_rates`` — 12-state MPC torque outputs -> body-rate +
  normalized-thrust commands, ``/root/reference/src/px4/mpc_FULL.py:552-611``.
"""

from __future__ import annotations

from .. import struct
import jax.numpy as jnp

from ..utils.rotations import wrap_angle


@struct.dataclass
class AttitudeLoopState:
    integral: jnp.ndarray  # (3,) attitude-error integral


def attitude_loop_init(dtype=jnp.float32) -> AttitudeLoopState:
    return AttitudeLoopState(integral=jnp.zeros(3, dtype))


def geometric_control_allocation(
    carry: AttitudeLoopState,
    accel_des: jnp.ndarray,
    target_yaw: jnp.ndarray,
    yawrate_des: jnp.ndarray,
    current_attitude: jnp.ndarray,
    current_angular_velocity: jnp.ndarray,
    dt_attitude: float = 0.02,
    kp: float = 3.2,
    ki: float = 0.6,
    kd: float = 0.6,
    integral_max: float = 0.3,
    gravity: float = 9.81,
    thrust_ceiling=1.2,
):
    """One allocation tick (``mpc.py:2057-2113``).

    ``thrust_ceiling`` is the normalized-thrust clamp (the reference's 1.2,
    ``mpc.py:2064``); recovery modes may pass a traced higher value — real
    airframes keep >1.2x-hover headroom (PX4 full throttle at the PID
    campaign's 0.7 hover calibration is 1.43 normalized), and a vehicle
    pinned at 1.2 under heavy+downdraft dispersions sinks unrecoverably.

    Returns ``(thrust_normalized, rate_setpoint3, attitude_setpoint3, carry)``.
    """
    thrust_vector = accel_des + jnp.array([0.0, 0.0, gravity], accel_des.dtype)
    thrust_magnitude = jnp.linalg.norm(thrust_vector)
    thrust_normalized = jnp.clip(
        thrust_magnitude / gravity, 0.25, thrust_ceiling
    )

    thrust_unit = thrust_vector / jnp.maximum(thrust_magnitude, 1e-9)
    pitch_cmd = -jnp.arcsin(jnp.clip(thrust_unit[0], -0.4, 0.4))
    roll_cmd = jnp.arcsin(jnp.clip(thrust_unit[1], -0.4, 0.4))
    # reference zeroes the tilt when the thrust vector is degenerate (:2070-2075)
    degenerate = thrust_magnitude <= 0.1
    pitch_cmd = jnp.where(degenerate, 0.0, pitch_cmd)
    roll_cmd = jnp.where(degenerate, 0.0, roll_cmd)

    error = jnp.stack(
        [
            wrap_angle(roll_cmd - current_attitude[0]),
            wrap_angle(pitch_cmd - current_attitude[1]),
            wrap_angle(target_yaw - current_attitude[2]),
        ]
    )
    integral = jnp.clip(
        carry.integral + error * dt_attitude, -integral_max, integral_max
    )

    rate_cmd = kp * error + ki * integral - kd * current_angular_velocity
    rollrate = jnp.clip(rate_cmd[0], -1.2, 1.2)
    pitchrate = jnp.clip(rate_cmd[1], -1.2, 1.2)
    yawrate = jnp.clip(yawrate_des + rate_cmd[2], -0.8, 0.8)

    rate_setpoint = jnp.stack([rollrate, pitchrate, yawrate])
    attitude_setpoint = jnp.stack([roll_cmd, pitch_cmd, target_yaw])
    return (
        thrust_normalized,
        rate_setpoint,
        attitude_setpoint,
        AttitudeLoopState(integral=integral),
    )


def torque_to_px4_rates(
    u_mpc: jnp.ndarray,
    mass: float = 2.0,
    Jx: float = 0.0217,
    Jy: float = 0.0217,
    Jz: float = 0.04,
    kp_att: float = 5.0,
    gravity: float = 9.81,
):
    """Torque+thrust MPC output -> (rate_cmd3, thrust_norm);
    ``mpc_FULL.py:552-611`` including its 0.05 s feedforward constant and
    asymmetric clips."""
    uT, tau = u_mpc[0], u_mpc[1:4]
    thrust_norm = jnp.clip(uT / (mass * gravity), 0.30, 0.80)

    alpha = tau / jnp.array([Jx, Jy, Jz], u_mpc.dtype)
    dt_control = 0.05
    rate_cmd = alpha * dt_control * kp_att
    rate_cmd = jnp.stack(
        [
            jnp.clip(rate_cmd[0], -3.0, 3.0),
            jnp.clip(rate_cmd[1], -3.0, 3.0),
            jnp.clip(rate_cmd[2], -2.0, 2.0),
        ]
    )
    return rate_cmd, thrust_norm


def with_hover_fallback(controller_fn, hover_control=None):
    """Wrap any ``(*args) -> (u, *rest)`` controller with the reference's
    solver-failure behaviour, in-graph: a non-finite command is replaced by
    the hover command (Ipopt failure -> hover at ``src/px4/mpc.py:1627-1630``
    and ``mpc_FULL.py:517-520``; cvxpy emergency hover at
    ``mpc_controller.py:363-368``). Because the check is a ``jnp.where`` on
    the output, the wrapped controller still fuses into one XLA program and
    the fallback costs nothing when the solver is healthy.

    ``hover_control`` defaults to the zero-acceleration command (4 zeros) —
    the fused-loop convention where allocation adds gravity compensation.
    """
    import jax.numpy as jnp

    def wrapped(*args, **kwargs):
        out = controller_fn(*args, **kwargs)
        u, rest = (out[0], out[1:]) if isinstance(out, tuple) else (out, ())
        hover = (
            jnp.zeros_like(u) if hover_control is None
            else jnp.asarray(hover_control, u.dtype)
        )
        safe = jnp.where(jnp.all(jnp.isfinite(u)), u, hover)
        return (safe, *rest) if rest else safe

    return wrapped
