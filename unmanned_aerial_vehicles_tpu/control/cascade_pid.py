"""Cascade PID controllers (functional, scan/vmap-composable).

Two controllers from the reference are re-expressed as pure step functions:

1. ``cascade_pid_step`` — the PX4 flight node's 9-loop cascade
   (``/root/reference/src/px4/cascade_pid_demo.py:194-210`` gains,
   ``:376-425`` update law): position PIDs -> velocity setpoints ->
   velocity PIDs -> attitude/thrust -> attitude PIDs -> body-rate commands.
   Output ``[thrust_normalized, p_cmd, q_cmd, r_cmd]`` pairs with the
   ``models.px4_surrogate`` plant.

   Vectorised: the nine scalar PID objects become three *vectorised* PID
   triples (one fused update per cascade layer — no Python loop, one XLA
   program per tick).

2. ``comparison_pid_step`` — the standalone harness's 9-loop controller
   (``/root/reference/quadrotor_gp_mpc/quadrotor_gp_mpc/main.py:38-186``):
   direct PD position law + z integral + attitude law producing
   ``[thrust, tau_roll, tau_pitch, tau_yaw]``.
"""

from __future__ import annotations

from .. import struct
import jax.numpy as jnp

from .pid import PIDGains, PIDState, pid_init, pid_step


def _triple(kp, ki, kd, max_output, max_integral) -> PIDGains:
    arr = lambda v: jnp.asarray(v, dtype=jnp.result_type(float))
    return PIDGains(
        kp=arr(kp), ki=arr(ki), kd=arr(kd),
        max_output=arr(max_output), max_integral=arr(max_integral),
    )


@struct.dataclass
class CascadePidGains:
    """Per-layer vectorised gains; defaults = ``cascade_pid_demo.py:196-210``."""

    position: PIDGains
    velocity: PIDGains
    attitude: PIDGains
    hover_thrust: float = 0.7       # cascade_pid_demo.py:406
    thrust_min: float = 0.1
    thrust_max: float = 1.15
    max_rate: float = 0.7           # "EMERGENCY SAFETY" clip, :417

    @classmethod
    def default(cls) -> "CascadePidGains":
        return cls(
            position=_triple(
                kp=[0.3, 0.3, 0.8], ki=[0.01, 0.01, 0.04], kd=[0.05, 0.05, 0.12],
                max_output=[1.0, 1.0, 2.0], max_integral=[0.3, 0.3, 0.8],
            ),
            velocity=_triple(
                kp=[0.35, 0.35, 0.3], ki=[0.01, 0.01, 0.01], kd=[0.03, 0.03, 0.02],
                max_output=[0.36, 0.36, 0.8], max_integral=[0.3, 0.3, 1.0],
            ),
            attitude=_triple(
                kp=[0.5, 0.5, 0.3], ki=[0.02, 0.02, 0.01], kd=[0.05, 0.05, 0.02],
                max_output=[0.5, 0.5, 0.3], max_integral=[0.1, 0.1, 0.05],
            ),
        )


@struct.dataclass
class CascadeState:
    position: PIDState
    velocity: PIDState
    attitude: PIDState


def cascade_init(dtype=jnp.float32) -> CascadeState:
    return CascadeState(
        position=pid_init((3,), dtype),
        velocity=pid_init((3,), dtype),
        attitude=pid_init((3,), dtype),
    )


def cascade_pid_step(
    gains: CascadePidGains,
    carry: CascadeState,
    state12: jnp.ndarray,
    position_setpoint: jnp.ndarray,
    yaw_setpoint: jnp.ndarray,
    dt: float,
):
    """One 50 Hz cascade tick (``cascade_pid_demo.py:376-425``).

    ``state12``: rigid-body state ``[pos, vel, euler, rates]``.
    Returns ``(control4, new_carry, aux)`` with control
    ``[thrust_normalized, p_cmd, q_cmd, r_cmd]``.
    """
    pos, vel, att = state12[0:3], state12[3:6], state12[6:9]

    # Outer loop: position -> velocity setpoints
    vel_sp, pos_pid = pid_step(gains.position, carry.position, position_setpoint, pos, dt)

    # Middle loop: velocity -> attitude / thrust
    vel_out, vel_pid = pid_step(gains.velocity, carry.velocity, vel_sp, vel, dt)
    pitch_cmd = -vel_out[0]   # forward velocity -> pitch down (:394)
    roll_cmd = vel_out[1]     # rightward velocity -> roll right (:395)
    thrust_norm = jnp.clip(
        gains.hover_thrust + vel_out[2], gains.thrust_min, gains.thrust_max
    )

    att_sp = jnp.stack([roll_cmd, pitch_cmd, yaw_setpoint])

    # Inner loop: attitude -> body rates
    rate_cmd, att_pid = pid_step(gains.attitude, carry.attitude, att_sp, att, dt)
    rate_cmd = jnp.clip(rate_cmd, -gains.max_rate, gains.max_rate)

    control = jnp.concatenate([thrust_norm[None], rate_cmd])
    new_carry = CascadeState(position=pos_pid, velocity=vel_pid, attitude=att_pid)
    aux = {"velocity_setpoint": vel_sp, "attitude_setpoint": att_sp}
    return control, new_carry, aux


# ---------------------------------------------------------------------------
# Standalone comparison-harness controller (main.py:38-186)
# ---------------------------------------------------------------------------


@struct.dataclass
class ComparisonPidParams:
    mass: float = 1.225
    gravity: float = 9.81
    kp_pos: float = 15.0
    kd_pos: float = 8.0
    ki_pos: float = 2.0
    kp_att: float = 5.0
    kd_att: float = 2.0
    max_integral: float = 2.0
    max_torque: float = 0.1
    max_tilt: float = jnp.pi / 4

    @property
    def max_thrust(self) -> float:
        return 2.0 * self.mass * self.gravity


def comparison_pid_init(dtype=jnp.float32) -> jnp.ndarray:
    """Carry is the z-axis integral only (``main.py:73``)."""
    return jnp.zeros((), dtype)


def comparison_pid_step(
    params: ComparisonPidParams,
    z_integral: jnp.ndarray,
    state12: jnp.ndarray,
    reference12: jnp.ndarray,
    dt: float,
):
    """One control tick of ``CascadePIDController.compute_control``
    (``main.py:83-173``); returns ``([thrust, tau3], z_integral)``."""
    pos, vel = state12[0:3], state12[3:6]
    attitude, rates = state12[6:9], state12[9:12]
    ref_pos, ref_vel = reference12[0:3], reference12[3:6]

    pos_error = ref_pos - pos

    z_integral = jnp.clip(
        z_integral + pos_error[2] * dt, -params.max_integral, params.max_integral
    )
    accel_z_cmd = (
        params.kp_pos * pos_error[2]
        + params.kd_pos * (-vel[2])
        + params.ki_pos * z_integral
        + params.gravity
    )
    accel_xy_cmd = params.kp_pos * pos_error[0:2] + params.kd_pos * (-vel[0:2])

    thrust_total = params.mass * accel_z_cmd

    phi_input = jnp.clip(accel_xy_cmd[1] / (accel_z_cmd + 1e-6), -0.99, 0.99)
    theta_input = jnp.clip(accel_xy_cmd[0] / (accel_z_cmd + 1e-6), -0.99, 0.99)
    phi_des = jnp.clip(-jnp.arcsin(phi_input), -params.max_tilt, params.max_tilt)
    theta_des = jnp.clip(jnp.arcsin(theta_input), -params.max_tilt, params.max_tilt)
    psi_des = reference12[8]

    att_error = jnp.stack(
        [phi_des - attitude[0], theta_des - attitude[1], psi_des - attitude[2]]
    )
    tau_cmd = jnp.clip(
        params.kp_att * att_error + params.kd_att * (-rates),
        -params.max_torque,
        params.max_torque,
    )
    thrust_cmd = jnp.clip(thrust_total, 0.0, params.max_thrust)

    control = jnp.concatenate([thrust_cmd[None], tau_cmd])
    return control, z_integral
