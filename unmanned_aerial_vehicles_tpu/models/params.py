"""Physical parameter sets for the quadrotor plants.

The reference hard-codes three distinct parameterisations; we expose them as
immutable pytree dataclasses so any plant/controller can be traced once and
reused across parameter batches (``vmap`` over params works out of the box).

Sources:
* ``GZ_QUADROTOR_PARAMS`` — the standalone Gazebo-package quadrotor
  (``/root/reference/quadrotor_gp_mpc/quadrotor_gp_mpc/quadrotor_dynamics.py:40-49``,
  matching the URDF inertias at ``quadrotor_gp_mpc/urdf/quadrotor.urdf:22-25``).
* ``X500_PARAMS`` — the gz_x500 approximation used by the 12-state MPC
  (``/root/reference/src/px4/mpc_FULL.py:107-127``): mass 2.0, no drag terms.
* ``COMPARISON_PARAMS`` — the standalone comparison harness
  (``/root/reference/quadrotor_gp_mpc/quadrotor_gp_mpc/main.py:50-70``): mass 1.225.
"""

from __future__ import annotations

from typing import Tuple

from .. import struct
import jax.numpy as jnp


@struct.dataclass
class RigidBodyParams:
    """12-state rigid-body quadrotor parameters (pytree leaf values).

    ``wind`` is a steady world-frame wind velocity (m/s): aerodynamic drag
    acts on the *airspeed* ``v - wind`` instead of the ground velocity. The
    default zero wind reproduces the reference's drag term bit-for-bit
    (``quadrotor_dynamics.py:180-182`` has no wind model); non-zero wind is
    the disturbance axis of the Monte-Carlo robustness harness
    (``loop.monte_carlo``).
    """

    mass: float = 0.5
    gravity: float = 9.81
    inertia_xx: float = 0.0023
    inertia_yy: float = 0.0023
    inertia_zz: float = 0.0046
    k_drag_linear: float = 0.25
    k_drag_angular: float = 0.01
    wind: Tuple[float, float, float] = (0.0, 0.0, 0.0)

    @property
    def inertia_diag(self) -> jnp.ndarray:
        return jnp.asarray([self.inertia_xx, self.inertia_yy, self.inertia_zz])

    @property
    def hover_thrust(self) -> float:
        return self.mass * self.gravity


GZ_QUADROTOR_PARAMS = RigidBodyParams()

X500_PARAMS = RigidBodyParams(
    mass=2.0,
    inertia_xx=0.0217,
    inertia_yy=0.0217,
    inertia_zz=0.04,
    k_drag_linear=0.0,
    k_drag_angular=0.0,
)

COMPARISON_PARAMS = RigidBodyParams(mass=1.225)
