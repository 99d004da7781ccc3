"""Disturbance-observer EKF: wind / model-mismatch estimated IN-FLIGHT.

The reference's only answer to unmodelled forces is the GP residual model
— learned offline from logged flights or retrained on a 5 s timer
(``/root/reference/src/px4/simple_gp.py:147-154``,
``gaussian_process.py:122``). A classical, learning-free alternative the
reference never ships is the augmented-state disturbance observer: extend
the EKF state with a slowly-varying acceleration disturbance ``d`` (random
walk), let the filter attribute the innovation the nominal model cannot
explain to ``d``, and feed the estimate forward to the MPC as the same
stage-wise affine residual the GP path uses
(``src/px4/mpc.py:1404-1412``). Steady wind, payload-mass error, and drag
mismatch all land in ``d`` within a few filter time constants — no
dataset, no refits, no GP capacity spent on a constant offset.

State layout: ``[x12, d3]`` with the plant's 12 states first, so the
measurement model is byte-identical to the base filter (position/attitude/
rate selection into the first 12 states). Process model::

    x12' = step_fn(x12, u) + [0.5 d dt^2, d dt, 0, 0]
    d'   = d                                (random walk via q_dist)

The transition Jacobian of the augmented system is ``jacfwd`` through that
step — exact, like the base filter. Everything is fixed-shape (one
(15, 15) Riccati update per tick) and scan/jit-composable, so the whole
noisy flight stays one XLA program.
"""

from __future__ import annotations

from typing import Callable, Tuple

from .. import struct
import jax
import jax.numpy as jnp

from ..models.params import RigidBodyParams
from ..models.px4_surrogate import RateLoopParams, px4_rate_tracking_step
from .ekf import EKFConfig, joseph_update

AUG_STATE_DIM = 15
DIST_DIM = 3


@struct.dataclass
class DisturbanceEKFConfig:
    """Augmented-filter noise model on top of the base ``EKFConfig``.

    ``q_dist`` is the random-walk std of the disturbance acceleration per
    step — the knob that trades convergence speed against noise rejection:
    large values track gusts quickly but pass sensor noise into the
    feedforward; small values average harder but lag wind changes.
    """

    base: EKFConfig = EKFConfig()
    q_dist: float = 0.05    # disturbance accel random-walk std (m/s^2 / step)
    p0_dist: float = 0.5    # initial disturbance std (m/s^2)

    def q_diag(self) -> jnp.ndarray:
        return jnp.concatenate(
            [self.base.q_diag(),
             jnp.full(DIST_DIM, self.q_dist, jnp.float32) ** 2]
        )

    def p0_diag(self) -> jnp.ndarray:
        return jnp.concatenate(
            [self.base.p0_diag(),
             jnp.full(DIST_DIM, self.p0_dist, jnp.float32) ** 2]
        )


@struct.dataclass
class DisturbanceEKFState:
    x: jnp.ndarray   # (15,) = [x12, d3]
    P: jnp.ndarray   # (15, 15) covariance


def dekf_init(
    x0: jnp.ndarray,
    config: DisturbanceEKFConfig = DisturbanceEKFConfig(),
    dtype=jnp.float32,
) -> DisturbanceEKFState:
    """Start at the (12-state) initial estimate with zero disturbance."""
    xa = jnp.concatenate([x0.astype(dtype), jnp.zeros(DIST_DIM, dtype)])
    return DisturbanceEKFState(
        x=xa, P=jnp.diag(config.p0_diag()).astype(dtype)
    )


def dekf_step(
    carry: DisturbanceEKFState,
    control: jnp.ndarray,
    measurement: jnp.ndarray,
    body: RigidBodyParams = RigidBodyParams(),
    rate_loop: RateLoopParams = RateLoopParams(),
    dt: float = 0.02,
    config: DisturbanceEKFConfig = DisturbanceEKFConfig(),
    step_fn: Callable | None = None,
) -> Tuple[DisturbanceEKFState, jnp.ndarray, jnp.ndarray]:
    """One augmented predict + update; returns ``(carry, x12_est, d_est)``.

    ``step_fn(x12, u) -> x12_next`` overrides the NOMINAL process model
    (default: the PX4 rate-tracking surrogate with the caller's ``body`` —
    pass the nominal, wind-free parameters; the point of the observer is
    that the truth differs). The measurement vector is the base filter's
    9-component sample (``estimation.ekf.measure``).
    """
    if step_fn is None:
        nominal = lambda x, u: px4_rate_tracking_step(x, u, body, rate_loop,
                                                      dt)
    else:
        nominal = step_fn

    def aug_step(xa):
        x12, d = xa[:12], xa[12:]
        xn = nominal(x12, control)
        # the disturbance is an acceleration on the translational states:
        # exact double-integrator injection over one step
        xn = xn.at[0:3].add(0.5 * dt * dt * d).at[3:6].add(dt * d)
        return jnp.concatenate([xn, d])

    x_pred = aug_step(carry.x)
    F = jax.jacfwd(aug_step)(carry.x)
    x_new, P_new = joseph_update(
        x_pred, F, carry.P, config.q_diag(), measurement,
        config.base.r_diag(),
    )
    return (
        DisturbanceEKFState(x=x_new, P=P_new),
        x_new[:12],
        x_new[12:],
    )


def disturbance_residual_rows12(
    d_est: jnp.ndarray, horizon: int, dtype=jnp.float32
) -> jnp.ndarray:
    """Disturbance estimate -> 12-state engine residual rows.

    The torque family's residual hook is the direct-rate engine's traced
    ``(N, 12)`` derivative-space input (``control.mpc_rigid.DirectRateMPC``
    — reference semantics ``mpc_direct_rates.py:153-190``, the GP residual
    added to the derivative). A constant acceleration disturbance occupies
    the velocity-derivative rows 3:6.
    """
    row = jnp.zeros(12, dtype).at[3:6].set(d_est.astype(dtype))
    return jnp.broadcast_to(row, (horizon, 12))


def disturbance_residual_rows(
    d_est: jnp.ndarray, horizon: int, dtype=jnp.float32
) -> jnp.ndarray:
    """Disturbance estimate -> MPC stage residuals, GP-row semantics.

    The linear MPC's residual input is per-stage state-DERIVATIVE rows
    ``(N, 6)`` that the flight loops scale by ``dt`` into the dynamics'
    affine term (``loop.closed_loop.mpc_flight_rollout``; reference
    semantics ``src/px4/mpc.py:1404-1412``). A constant acceleration
    disturbance is a derivative offset on the velocity components only —
    position rows stay zero (velocity integration carries it forward).
    """
    row = jnp.concatenate(
        [jnp.zeros(3, dtype), d_est.astype(dtype)]
    )
    return jnp.broadcast_to(row, (horizon, 6))
