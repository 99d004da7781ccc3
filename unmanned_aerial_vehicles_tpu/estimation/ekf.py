"""12-state extended Kalman filter (the PX4-EKF2 role, in-graph).

The reference never estimates state itself — it consumes PX4's EKF2 output
over DDS topics (``/fmu/out/vehicle_local_position`` etc.,
``/root/reference/src/px4/mpc.py:1662-1720``) and its standalone simulator
feeds controllers the TRUE plant state. A standalone framework needs the
estimator in the loop: this module closes that gap with a functional EKF
over the PX4-surrogate dynamics, fully jit/scan-composable, so a whole
noisy-sensor flight (sensor sim -> EKF -> controller -> allocation ->
plant) stays ONE fused XLA program.

Process model: the rate-tracking surrogate (``models.px4_surrogate``),
linearised per step with ``jax.jacfwd`` (no finite differences).
Measurement model: position + attitude (the local-position + attitude
fusion PX4 exposes to the reference's nodes), plus gyro body rates —
a linear selection ``H``, with yaw innovation wrapped.

All operations are fixed-shape: one (12, 12) Riccati update per tick; the
Joseph-form covariance update keeps P symmetric PSD in f32.
"""

from __future__ import annotations

from typing import Callable, Tuple

from .. import struct
import jax
import jax.numpy as jnp

from ..models.params import RigidBodyParams
from ..models.px4_surrogate import RateLoopParams, px4_rate_tracking_step
from ..utils.rotations import wrap_angle

STATE_DIM = 12
# measured components: position (0:3), attitude (6:9), body rates (9:12)
MEASURED_IDX = (0, 1, 2, 6, 7, 8, 9, 10, 11)
MEAS_DIM = len(MEASURED_IDX)
_YAW_ROW = 5  # index of yaw inside the measurement vector


@struct.dataclass
class EKFConfig:
    """Noise model. Defaults are representative of the PX4 SITL sensor
    stack the reference's campaign ran against (GPS/vision position at cm
    level, attitude from EKF2 fusion, gyro rates)."""

    # process noise std per state group (continuous-ish, applied per step)
    q_pos: float = 1e-3
    q_vel: float = 2e-2
    q_att: float = 1e-3
    q_rate: float = 5e-2
    # measurement noise std
    r_pos: float = 0.05
    r_att: float = 0.01
    r_rate: float = 0.02
    # initial covariance std
    p0_pos: float = 0.1
    p0_vel: float = 0.1
    p0_att: float = 0.05
    p0_rate: float = 0.05

    def q_diag(self) -> jnp.ndarray:
        g = lambda v: jnp.full(3, v, jnp.float32) ** 2
        return jnp.concatenate(
            [g(self.q_pos), g(self.q_vel), g(self.q_att), g(self.q_rate)]
        )

    def r_diag(self) -> jnp.ndarray:
        g = lambda v: jnp.full(3, v, jnp.float32) ** 2
        return jnp.concatenate([g(self.r_pos), g(self.r_att), g(self.r_rate)])

    def p0_diag(self) -> jnp.ndarray:
        g = lambda v: jnp.full(3, v, jnp.float32) ** 2
        return jnp.concatenate(
            [g(self.p0_pos), g(self.p0_vel), g(self.p0_att), g(self.p0_rate)]
        )


@struct.dataclass
class EKFState:
    x: jnp.ndarray   # (12,) estimate
    P: jnp.ndarray   # (12, 12) covariance


def ekf_init(
    x0: jnp.ndarray, config: EKFConfig = EKFConfig(), dtype=jnp.float32
) -> EKFState:
    return EKFState(
        x=x0.astype(dtype), P=jnp.diag(config.p0_diag()).astype(dtype)
    )


def measure(
    state: jnp.ndarray, key: jax.Array, config: EKFConfig = EKFConfig()
) -> jnp.ndarray:
    """Simulate one sensor sample: selected true components + Gaussian noise."""
    idx = jnp.asarray(MEASURED_IDX)
    clean = state[idx]
    noise = jnp.sqrt(config.r_diag()) * jax.random.normal(
        key, (MEAS_DIM,), state.dtype
    )
    return clean + noise


def joseph_update(
    x_pred: jnp.ndarray,
    F: jnp.ndarray,
    P: jnp.ndarray,
    q_diag: jnp.ndarray,
    measurement: jnp.ndarray,
    r_diag: jnp.ndarray,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Covariance propagation + Joseph-form measurement fusion.

    Dimension-generic core shared by the 12-state filter (``ekf_step``) and
    the 15-state disturbance observer (``estimation.disturbance``): state
    dim comes from ``x_pred.shape``, the measurement model stays the
    position/attitude/rate selection of ``MEASURED_IDX`` (all inside the
    first 12 states), yaw innovation wrapped. Returns ``(x_new, P_new)``.
    """
    dtype = x_pred.dtype
    n = x_pred.shape[0]
    prec = jax.lax.Precision.HIGHEST
    mm = lambda a, b: jnp.matmul(a, b, precision=prec)

    P_pred = mm(mm(F, P), F.T) + jnp.diag(q_diag).astype(dtype)

    idx = jnp.asarray(MEASURED_IDX)
    H = jnp.zeros((MEAS_DIM, n), dtype).at[
        jnp.arange(MEAS_DIM), idx
    ].set(1.0)

    innov = measurement - x_pred[idx]
    innov = innov.at[_YAW_ROW].set(wrap_angle(innov[_YAW_ROW]))

    S = mm(mm(H, P_pred), H.T) + jnp.diag(r_diag).astype(dtype)
    # gain via solve (no explicit inverse): K = P H' S^-1
    K = jnp.linalg.solve(S.T, mm(H, P_pred.T)).T
    x_new = x_pred + mm(K, innov[:, None])[:, 0]
    x_new = x_new.at[6:9].set(wrap_angle(x_new[6:9]))

    IKH = jnp.eye(n, dtype=dtype) - mm(K, H)
    P_new = mm(mm(IKH, P_pred), IKH.T) + mm(
        K * r_diag.astype(dtype)[None, :], K.T
    )
    P_new = 0.5 * (P_new + P_new.T)  # exact symmetry against f32 drift
    return x_new, P_new


def ekf_step(
    carry: EKFState,
    control: jnp.ndarray,
    measurement: jnp.ndarray,
    body: RigidBodyParams = RigidBodyParams(),
    rate_loop: RateLoopParams = RateLoopParams(),
    dt: float = 0.02,
    config: EKFConfig = EKFConfig(),
    step_fn: Callable | None = None,
) -> Tuple[EKFState, jnp.ndarray]:
    """One predict + update cycle; returns ``(new_carry, x_est)``.

    Predict: RK4 surrogate step + ``jacfwd`` transition Jacobian (replacing
    EKF2's analytic/complementary filters with exact AD linearisation).
    Update: Joseph form, yaw innovation wrapped to (-pi, pi].

    ``step_fn(x, u) -> x_next`` overrides the process model (default: the
    PX4 rate-tracking surrogate). Any differentiable 12-state discrete
    plant works — the torque-input rigid body serves the 12-state
    controller family's noisy loop (``noisy_rigid_mpc_rollout``).
    """
    if step_fn is None:
        step = lambda x: px4_rate_tracking_step(x, control, body, rate_loop,
                                                dt)
    else:
        step = lambda x: step_fn(x, control)
    x_pred = step(carry.x)
    F = jax.jacfwd(step)(carry.x)
    x_new, P_new = joseph_update(
        x_pred, F, carry.P, config.q_diag(), measurement, config.r_diag()
    )
    return EKFState(x=x_new, P=P_new), x_new
