"""PX4-in-the-loop surrogate plant (rate-setpoint + normalized-thrust inputs).

The reference's flight controllers do not command torques — they publish
body-rate setpoints and a normalized thrust to PX4
(``/root/reference/src/px4/mpc.py:1966-1980``), whose internal rate controller
tracks them. For closed-loop runs to be comparable to the PX4 SITL campaign
(SURVEY.md section 6 / hard part (e)) the simulated plant must absorb that
inner loop. We model it the way the reference's direct-rate MPC models PX4
(``/root/reference/src/px4/mpc_direct_rates.py:150-220``): a first-order lag
on each body rate with time constants ``tau = (0.05, 0.05, 0.08)`` seconds,
on top of the rigid-body translational/attitude kinematics.

Thrust semantics: normalized thrust 1.0 == hover (acceleration g along the
body thrust axis), matching the reference allocation's
``thrust_magnitude / g`` normalisation (``mpc.py:2064``).

Frame convention — the reference's "mixed NED" frame: the flight nodes keep
PX4's NED x (north), y (east) and NED Euler angles/body rates, but flip z to
up (``mpc.py:1891-1892``). In that frame the thrust direction enters as

    a_xy = -(T/m) * (R(phi,theta,psi) e3)_xy,   a_z = +(T/m) * (R e3)_z - g

(PX4 thrust is along -z_body in NED). This is what makes the reference's
allocation signs (``pitch_cmd = -asin(t_x)``, ``roll_cmd = +asin(t_y)``,
``mpc.py:2070-2072``) and the cascade PID's ``pitch = -vel_x PID`` /
``roll = +vel_y PID`` (``cascade_pid_demo.py:394-395``) correct — so the
surrogate implements exactly these kinematics and the reference controllers
transfer verbatim.

State: the same 12-state layout as ``rigid_body.py`` (mixed-NED semantics).
Control: ``[thrust_normalized, p_cmd, q_cmd, r_cmd]``.
"""

from __future__ import annotations

from .. import struct
import jax
import jax.numpy as jnp

from ..utils.rotations import euler_rate_transform, euler_to_rotation_matrix
from .params import RigidBodyParams


@struct.dataclass
class RateLoopParams:
    """First-order body-rate tracking constants (``mpc_direct_rates.py:150-165``)
    plus the normalized-thrust calibration of the PX4 inner loop.

    ``hover_thrust_norm`` is the normalized thrust at which the plant hovers:
    thrust acceleration = ``thrust_norm * g / hover_thrust_norm``. It absorbs
    PX4's actuator normalization, which the recorded campaign pins
    *differently per run* (see ``PID_CAMPAIGN_RATE_LOOP``). Default 1.0
    matches the MPC allocation's ``|a_des + g e3| / g`` convention
    (``mpc.py:2064``), under which hover commands exactly 1.0.
    """

    tau_roll: float = 0.05
    tau_pitch: float = 0.05
    tau_yaw: float = 0.08
    hover_thrust_norm: float = 1.0

    @property
    def taus(self) -> jnp.ndarray:
        return jnp.asarray([self.tau_roll, self.tau_pitch, self.tau_yaw])


def _derivative(
    state: jnp.ndarray,
    control: jnp.ndarray,
    body: RigidBodyParams,
    rates: RateLoopParams,
) -> jnp.ndarray:
    vel = state[..., 3:6]
    phi, theta, psi = state[..., 6], state[..., 7], state[..., 8]
    omega = state[..., 9:12]

    thrust_norm = control[..., 0]
    rate_cmd = control[..., 1:4]

    R = euler_to_rotation_matrix(phi, theta, psi)
    # mixed-NED thrust mapping: xy components flip sign (see module docstring);
    # normalized hover_thrust_norm -> acceleration g along the thrust axis.
    t_dir = R[..., :, 2] * jnp.asarray([-1.0, -1.0, 1.0], state.dtype)
    thrust_gain = body.gravity / rates.hover_thrust_norm
    thrust_accel_world = t_dir * (thrust_norm * thrust_gain)[..., None]

    # drag acts on the airspeed (v - wind); zero wind = reference behaviour.
    airspeed_vec = vel - jnp.asarray(body.wind, state.dtype)
    # gradient-safe ||.||: exact forward value, zero (sub)gradient at 0 —
    # same guard as rigid_body.py; a plain norm's derivative is NaN at exact
    # hover, which poisons any autodiff through the plant (tuning.autotune
    # back-propagates whole flights through this step).
    sq = jnp.sum(airspeed_vec**2, axis=-1, keepdims=True)
    speed = jnp.where(sq > 0.0, jnp.sqrt(jnp.where(sq > 0.0, sq, 1.0)), 0.0)
    drag_accel = -(body.k_drag_linear / body.mass) * speed * airspeed_vec

    gravity = jnp.zeros_like(vel).at[..., 2].set(-body.gravity)
    acceleration = thrust_accel_world + gravity + drag_accel

    W = euler_rate_transform(phi, theta)
    attitude_dot = jnp.einsum("...ij,...j->...i", W, omega)

    taus = jnp.asarray(rates.taus, state.dtype)  # avoid x64 promotion
    omega_dot = (rate_cmd - omega) / taus

    return jnp.concatenate([vel, acceleration, attitude_dot, omega_dot], axis=-1)


# Calibration for reproducing the cascade-PID campaign runs: the PID node
# feeds a HOVER_THRUST = 0.7 baseline forward
# (``/root/reference/src/px4/cascade_pid_demo.py:405``) and its recorded bag
# holds altitude at 3.00 +- 0.05 m for the whole 105 s trajectory phase
# (``bags/pid_cascade_20251119_001928_comprehensive_analysis.png``) — i.e.
# that run's plant hovered at ~0.7 normalized thrust, or the vehicle would
# visibly droop/climb. (The MPC bags instead record thrust >= 0.99 at hover
# for 99.2 % of samples — the campaign's own normalization is inconsistent
# across runs, hence per-campaign calibration rather than one global value.)
PID_CAMPAIGN_RATE_LOOP = RateLoopParams(hover_thrust_norm=0.7)


def px4_rate_tracking_step(
    state: jnp.ndarray,
    control: jnp.ndarray,
    body: RigidBodyParams,
    rates: RateLoopParams,
    dt: float,
) -> jnp.ndarray:
    """RK4 step of the rate-tracking surrogate plant."""

    def f(x):
        return _derivative(x, control, body, rates)

    k1 = f(state)
    k2 = f(state + 0.5 * dt * k1)
    k3 = f(state + 0.5 * dt * k2)
    k4 = f(state + dt * k3)
    return state + (dt / 6.0) * (k1 + 2.0 * k2 + 2.0 * k3 + k4)
