"""Nonlinear quadrotor MPC variants on the SQP engine.

Three controllers, one engine (``mpc_sqp.SQPMPC``):

* ``RigidBodyMPC`` — the 12-state torque+thrust MPC of
  ``/root/reference/src/px4/mpc_FULL.py:86-549`` (costs, bounds, hover
  initial guess, target clamping and final control clamps replicated).
* ``DirectRateMPC`` — the direct body-rate MPC of
  ``/root/reference/src/px4/mpc_direct_rates.py:76-470``: control
  ``[p_cmd, q_cmd, r_cmd, thrust]`` with first-order rate tracking
  (tau = 0.05/0.05/0.08 s) and per-stage GP residuals. The reference
  rebuilds its CasADi NLP on every solve to bake the residuals in
  (SURVEY.md's "solver-rebuild pathology"); here they are traced inputs to
  one compiled program. Note: the reference's velocity dynamics scale
  thrust as an acceleration while bounding it to [0.2, 1.5] normalized
  (``mpc_direct_rates.py:161-164,303``) — with g = 9.81 that model can
  never climb; we keep its exact structure but scale normalized thrust by
  g (1.0 == hover), which is what makes its own bounds meaningful.
* ``LTVTrackingMPC`` — the cvxpy LTV-MPC of
  ``/root/reference/quadrotor_gp_mpc/quadrotor_gp_mpc/mpc_controller.py:123-368``:
  linearisation about the reference trajectory with nominal hover controls,
  one QP per tick, RK4-discretised rigid-body model with drag, attitude
  box constraints. The reference's finite differences (eps=1e-8, :318-350)
  become exact ``jacfwd`` Jacobians; its ECOS->OSQP->SCS fallback chain
  becomes a single fixed-iteration ADMM.
"""

from __future__ import annotations

import jax.numpy as jnp

from ..models.params import RigidBodyParams, X500_PARAMS, GZ_QUADROTOR_PARAMS
from ..models.rigid_body import rigid_body_derivative
from ..utils.rotations import wrap_angle
from .mpc_sqp import QuadCost, SQPCarry, SQPConfig, SQPMPC

BIG = 1e9


# ---------------------------------------------------------------------------
# 12-state torque MPC (mpc_FULL)
# ---------------------------------------------------------------------------


class RigidBodyMPC:
    """``mpc_FULL.QuadrotorMPC`` equivalent: forward-Euler rigid body,
    torque+thrust inputs, conservative hover-centric cost."""

    def __init__(
        self,
        dt: float = 0.02,
        horizon: int = 15,
        params: RigidBodyParams = X500_PARAMS,
        config: SQPConfig | None = None,
        dtype=jnp.float32,
    ):
        self.dt = dt
        self.params = params
        mg = params.mass * params.gravity
        self.u_hover = jnp.asarray([mg, 0.0, 0.0, 0.0], dtype)

        def step_fn(x, u, d):
            return x + dt * rigid_body_derivative(x, u, params, d)

        # sqp_iterations=1: the 50 Hz shifted warm start carries SQP
        # convergence (circle task: rms IDENTICAL 0.6041 m at 1 vs 2
        # passes, at half the solve work)
        cfg = config or SQPConfig(horizon=horizon, sqp_iterations=1,
                                  admm_iterations=80, admm_rho=0.05)
        # bounds: mpc_FULL.py:393-430
        self.mpc = SQPMPC(
            step_fn,
            state_dim=12,
            control_dim=4,
            config=cfg,
            state_lower=[-50, -50, -1, -15, -15, -15, -1.2, -1.2, -BIG, -10, -10, -10],
            state_upper=[50, 50, 20, 15, 15, 15, 1.2, 1.2, BIG, 10, 10, 10],
            control_lower=[0.3 * mg, -0.8, -0.8, -0.4],
            control_upper=[1.2 * mg, 0.8, 0.8, 0.4],
            dtype=dtype,
        )
        # costs: mpc_FULL.py:264-276 stage, :352-360 terminal
        q_stage = jnp.asarray(
            [12.0, 12.0, 18.0, 3.0, 3.0, 4.0, 2.0, 2.0, 1.5, 0.3, 0.3, 0.3], dtype
        )
        term = jnp.asarray(
            [2.5] * 3 + [1.5] * 3 + [1.5] * 3 + [0.8] * 3, dtype
        )
        self.cost = QuadCost(
            q_stage=q_stage,
            q_terminal=q_stage * term,
            r_control=jnp.asarray([0.5, 0.1, 0.1, 0.1], dtype),  # w_thrust_dev + R_torque
            u_ref=self.u_hover,
        )
        self._mg = mg

    def init_carry(self, state12: jnp.ndarray) -> SQPCarry:
        return self.mpc.init_carry(state12, self.u_hover)

    def solve(self, carry: SQPCarry, state12: jnp.ndarray, target_pos, target_yaw=0.0):
        """Mirrors ``mpc_FULL.solve`` pre/post-processing (:438-549):
        velocity clamp, angle wrapping, 4 m target clamp + box, final
        control clamps."""
        x = state12
        x = x.at[3:6].set(jnp.clip(x[3:6], -6.0, 6.0))
        x = x.at[6:9].set(wrap_angle(x[6:9]))
        target_yaw = wrap_angle(jnp.asarray(target_yaw, x.dtype))

        pos_err = target_pos - x[0:3]
        dist = jnp.linalg.norm(pos_err)
        direction = pos_err / (dist + 1e-6)
        target_pos = jnp.where(dist > 4.0, x[0:3] + 4.0 * direction, target_pos)
        target_pos = jnp.clip(
            target_pos,
            jnp.asarray([-15.0, -15.0, 0.2], x.dtype),
            jnp.asarray([15.0, 15.0, 8.0], x.dtype),
        )

        N = self.mpc.config.horizon
        x_ref_stage = jnp.concatenate(
            [target_pos, jnp.zeros(3, x.dtype),
             jnp.stack([jnp.zeros((), x.dtype), jnp.zeros((), x.dtype), target_yaw]),
             jnp.zeros(3, x.dtype)]
        )
        x_ref = jnp.tile(x_ref_stage[None, :], (N, 1))

        u0, X_opt, carry = self.mpc.solve(carry, x, self.cost, x_ref)

        mg = self._mg
        u0 = jnp.stack(
            [
                jnp.clip(u0[0], 0.3 * mg, 1.2 * mg),
                jnp.clip(u0[1], -0.8, 0.8),
                jnp.clip(u0[2], -0.8, 0.8),
                jnp.clip(u0[3], -0.4, 0.4),
            ]
        )
        return u0, X_opt, carry


# ---------------------------------------------------------------------------
# Direct body-rate MPC (mpc_direct_rates)
# ---------------------------------------------------------------------------


def direct_rate_step(x, u, residual, dt=0.02, gravity=9.81,
                     taus=(0.05, 0.05, 0.08)):
    """Forward-Euler step of the direct-rate model
    (``mpc_direct_rates.py:153-190``), z-up, normalized thrust scaled by g.
    ``residual`` is the 12-D GP dynamics residual added to the derivative
    (acceleration rows in practice)."""
    vel = x[3:6]
    roll, pitch, yaw = x[6], x[7], x[8]
    rates = x[9:12]
    rate_cmd, thrust = u[0:3], u[3]

    a = thrust * gravity
    vx_dot = a * (jnp.sin(roll) * jnp.sin(yaw)
                  + jnp.cos(roll) * jnp.cos(yaw) * jnp.sin(pitch))
    vy_dot = a * (-jnp.sin(roll) * jnp.cos(yaw)
                  + jnp.cos(roll) * jnp.sin(yaw) * jnp.sin(pitch))
    vz_dot = a * (jnp.cos(roll) * jnp.cos(pitch)) - gravity

    cr, sr = jnp.cos(roll), jnp.sin(roll)
    tp = jnp.tan(pitch)
    cp = jnp.cos(pitch)
    roll_dot = rates[0] + rates[1] * sr * tp + rates[2] * cr * tp
    pitch_dot = rates[1] * cr - rates[2] * sr
    yaw_dot = rates[1] * sr / cp + rates[2] * cr / cp

    tau = jnp.asarray(taus, x.dtype)
    rate_dot = (rate_cmd - rates) / tau

    deriv = jnp.concatenate(
        [vel, jnp.stack([vx_dot, vy_dot, vz_dot]),
         jnp.stack([roll_dot, pitch_dot, yaw_dot]), rate_dot]
    )
    return x + dt * (deriv + residual)


class DirectRateMPC:
    """``mpc_direct_rates.DirectRateMPC`` equivalent; GP residuals are a
    traced ``(N, 12)`` input — no per-solve problem rebuild."""

    def __init__(self, dt: float = 0.02, horizon: int = 20,
                 config: SQPConfig | None = None, dtype=jnp.float32):
        self.dt = dt

        def step_fn(x, u, d):
            return direct_rate_step(x, u, d, dt=dt)

        # sqp_iterations=1: warm start carries convergence (circle task:
        # rms 0.2174 vs 0.2177 at 1 vs 2 passes)
        cfg = config or SQPConfig(horizon=horizon, sqp_iterations=1,
                                  admm_iterations=80, admm_rho=0.05)
        # bounds: mpc_direct_rates.py:279-304
        self.mpc = SQPMPC(
            step_fn,
            state_dim=12,
            control_dim=4,
            config=cfg,
            state_lower=[-50, -50, -2, -12, -12, -8, -0.5, -0.5, -3.14, -3, -3, -2],
            state_upper=[50, 50, 25, 12, 12, 8, 0.5, 0.5, 3.14, 3, 3, 2],
            control_lower=[-2.5, -2.5, -1.8, 0.2],
            control_upper=[2.5, 2.5, 1.8, 1.5],
            dtype=dtype,
        )
        # costs: mpc_direct_rates.py:205-212 (terminal 5x position only, :265)
        q_stage = jnp.asarray(
            [100.0, 100.0, 120.0, 10.0, 10.0, 15.0, 5.0, 5.0, 0.0, 2.0, 2.0, 3.0],
            dtype,
        )
        q_term = q_stage.at[0:3].set(5.0 * q_stage[0:3])
        self.cost = QuadCost(
            q_stage=q_stage,
            q_terminal=q_term,
            r_control=jnp.asarray([1.0, 1.0, 1.5, 0.5], dtype),
            u_ref=jnp.zeros(4, dtype),
        )
        self.u_hover = jnp.asarray([0.0, 0.0, 0.0, 1.0], dtype)

    def init_carry(self, state12: jnp.ndarray) -> SQPCarry:
        return self.mpc.init_carry(state12, self.u_hover)

    def solve(self, carry, state12, target_pos, residuals=None):
        N = self.mpc.config.horizon
        x_ref_stage = jnp.concatenate([target_pos, jnp.zeros(9, state12.dtype)])
        x_ref = jnp.tile(x_ref_stage[None, :], (N, 1))
        return self.mpc.solve(carry, state12, self.cost, x_ref, residuals)


# ---------------------------------------------------------------------------
# LTV tracking MPC (cvxpy mpc_controller)
# ---------------------------------------------------------------------------


class LTVTrackingMPC:
    """``mpc_controller.QuadrotorMPC`` equivalent: one QP per tick,
    linearised about the reference trajectory with hover nominal controls."""

    def __init__(self, dt: float = 0.1, horizon: int = 20,
                 params: RigidBodyParams = GZ_QUADROTOR_PARAMS,
                 config: SQPConfig | None = None, num_obstacles: int = 0,
                 obstacle_margin: float = 0.5, dtype=jnp.float32):
        self.dt = dt
        self.params = params
        mg = params.mass * params.gravity
        self.u_hover = jnp.asarray([mg, 0.0, 0.0, 0.0], dtype)

        def step_fn(x, u, d):
            # RK4 like the reference's dynamics_discrete (:129-146), with
            # the GP residual entering as "dt * uncertainty" (:144)
            def f(xx):
                return rigid_body_derivative(xx, u, params)

            k1 = f(x)
            k2 = f(x + 0.5 * dt * k1)
            k3 = f(x + 0.5 * dt * k2)
            k4 = f(x + dt * k3)
            return x + (dt / 6.0) * (k1 + 2 * k2 + 2 * k3 + k4) + dt * d

        cfg = config or SQPConfig(horizon=horizon, sqp_iterations=1,
                                  admm_iterations=200, admm_rho=0.02)
        # constraints: thrust in [0, 2mg], |tau|_inf <= 0.1 (:267-272),
        # |roll|, |pitch| <= pi/4 (:275-277)
        self.mpc = SQPMPC(
            step_fn,
            state_dim=12,
            control_dim=4,
            config=cfg,
            state_lower=[-BIG] * 6 + [-jnp.pi / 4, -jnp.pi / 4, -BIG] + [-BIG] * 3,
            state_upper=[BIG] * 6 + [jnp.pi / 4, jnp.pi / 4, BIG] + [BIG] * 3,
            control_lower=[0.0, -0.1, -0.1, -0.1],
            control_upper=[2.0 * mg, 0.1, 0.1, 0.1],
            num_obstacles=num_obstacles,          # mpc_controller.py:281-287
            obstacle_margin=obstacle_margin,      # safety_margin (:74)
            dtype=dtype,
        )
        # weights: mpc_controller.py:56-63; terminal P = 5 Q
        q = jnp.asarray([100.0] * 3 + [10.0] * 3 + [50.0] * 3 + [5.0] * 3, dtype)
        self.cost = QuadCost(
            q_stage=q,
            q_terminal=5.0 * q,
            r_control=jnp.asarray([0.01, 0.1, 0.1, 0.1], dtype),
            u_ref=jnp.zeros(4, dtype),  # reference penalises |u|^2 directly (:238)
        )

    def init_carry(self, state12: jnp.ndarray) -> SQPCarry:
        return self.mpc.init_carry(state12, self.u_hover)

    def solve(self, carry, state12, reference_traj, residuals=None,
              obstacles=None):
        """``reference_traj``: ``(N+1, 12)`` stage references (the node keeps
        a shifting (N+1)-step reference, :64-67). Linearisation anchors to
        the reference + hover controls each tick (:251-263)."""
        N = self.mpc.config.horizon
        lin = (
            reference_traj.astype(state12.dtype),
            jnp.tile(self.u_hover[None, :], (N, 1)),
        )
        return self.mpc.solve(
            carry, state12, self.cost, reference_traj[1:], residuals,
            lin_trajectory=lin, obstacles=obstacles,
        )
