"""MPPI: sampling-based MPC for the 12-state rigid body.

No reference counterpart — every reference controller is derivative-based
(CasADi/Ipopt NLPs, cvxpy QPs). Model Predictive Path Integral control
(Williams et al., information-theoretic MPC) is the natively-parallel
alternative: each tick rolls out K perturbed control sequences through the
full nonlinear plant and softmax-averages them by cost: K*N plant
evaluations per tick, which a vmapped scan turns into N batched steps over
the samples. Handles non-convex costs and raw nonlinear dynamics with no
linearisation or solver iterations at all.

Interface matches ``mpc_rigid.RigidBodyMPC`` (``init_carry`` / ``solve``
on the z-up rigid-body plant with ``[T, tau]`` inputs), so it drops into
the same flight loops (``fly --controller mppi12``).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

from .. import struct
import jax
import jax.numpy as jnp

from ..models.params import RigidBodyParams, X500_PARAMS
from ..models.rigid_body import rigid_body_rk4_step
from ..utils.rotations import wrap_angle


@struct.dataclass
class MPPIConfig:
    horizon: int = 25
    num_samples: int = 512
    dt: float = 0.02
    temperature: float = 0.3      # lambda: softmax sharpness over costs
    # per-channel exploration noise std: [thrust N, tau x, tau y, tau z Nm]
    noise_std: Tuple[float, float, float, float] = (3.0, 0.03, 0.03, 0.01)
    # also roll out the updated nominal sequence and return it as X_nom
    # (diagnostics; an extra sequential N-step chain — ~half the tick's
    # critical path — so off by default; solve returns None in its place)
    return_trajectory: bool = False
    # stage costs
    q_pos: float = 60.0
    q_vel: float = 6.0
    q_att: float = 30.0           # roll/pitch levelness
    q_yaw: float = 2.0
    q_rate: float = 1.0
    r_control: Tuple[float, float, float, float] = (0.02, 40.0, 40.0, 80.0)
    terminal_weight: float = 5.0  # multiplies q_pos/q_vel at the last stage


class MPPICarry(NamedTuple):
    U_nom: jnp.ndarray   # (N, 4) nominal control sequence (warm start)
    key: jax.Array       # PRNG state for the exploration noise


class MPPIController:
    """Information-theoretic MPC on the rigid-body plant.

    Per ``solve``: sample K perturbation sequences, clip to actuator
    bounds, batch-roll the plant (``vmap`` over K of an N-step RK4 scan),
    weight by ``softmax(-cost / lambda)``, update the nominal sequence,
    apply its first control, and shift for the next tick.
    """

    def __init__(
        self,
        config: MPPIConfig = MPPIConfig(),
        params: RigidBodyParams = X500_PARAMS,
        dtype=jnp.float32,
    ):
        self.config = config
        self.params = params
        self.dtype = dtype
        mg = params.mass * params.gravity
        self.u_hover = jnp.asarray([mg, 0.0, 0.0, 0.0], dtype)
        # actuator box (mpc_FULL.py:393-430 ranges)
        self.u_lo = jnp.asarray([0.3 * mg, -0.8, -0.8, -0.4], dtype)
        self.u_hi = jnp.asarray([1.6 * mg, 0.8, 0.8, 0.4], dtype)

    def init_carry(self, state12: jnp.ndarray, seed: int = 0) -> MPPICarry:
        """``seed`` decorrelates the exploration noise of batched/vmapped
        MPPI instances (e.g. Monte-Carlo members); the default reproduces
        the historical deterministic stream."""
        N = self.config.horizon
        return MPPICarry(
            U_nom=jnp.tile(self.u_hover[None, :], (N, 1)),
            key=jax.random.PRNGKey(seed),
        )

    # ------------------------------------------------------------------
    def _stage_cost(self, x, u, target_pos, target_yaw):
        cfg = self.config
        pos_err = x[0:3] - target_pos
        r = jnp.asarray(cfg.r_control, x.dtype)
        du = u - self.u_hover
        return (
            cfg.q_pos * jnp.sum(pos_err**2)
            + cfg.q_vel * jnp.sum(x[3:6] ** 2)
            + cfg.q_att * jnp.sum(x[6:8] ** 2)
            + cfg.q_yaw * wrap_angle(x[8] - target_yaw) ** 2
            + cfg.q_rate * jnp.sum(x[9:12] ** 2)
            + jnp.sum(r * du**2)
        )

    def _rollout_cost(self, x0, Useq, targets, target_yaw):
        """``targets``: (N, 3) per-stage positions (a point target is tiled)."""
        cfg = self.config

        def step(x, inputs):
            u, tgt = inputs
            x_new = rigid_body_rk4_step(x, u, self.params, cfg.dt)
            return x_new, self._stage_cost(x_new, u, tgt, target_yaw)

        x_fin, costs = jax.lax.scan(step, x0, (Useq, targets))
        terminal = (cfg.terminal_weight - 1.0) * (
            cfg.q_pos * jnp.sum((x_fin[0:3] - targets[-1]) ** 2)
            + cfg.q_vel * jnp.sum(x_fin[3:6] ** 2)
        )
        return jnp.sum(costs) + terminal

    def solve(
        self,
        carry: MPPICarry,
        state12: jnp.ndarray,
        target_pos: jnp.ndarray,
        target_yaw=0.0,
        reference_positions: jnp.ndarray | None = None,
    ):
        """One MPPI tick; returns ``(u0, X_nom, new_carry)`` like the
        derivative-based 12-state controllers.

        ``reference_positions``: optional ``(N, 3)`` per-stage targets
        (trajectory *preview*, sampled along the horizon) — the sampling
        analogue of ``LinearMPC.solve(reference_states=...)``; a point
        ``target_pos`` is tiled otherwise.
        """
        cfg = self.config
        x0 = state12.astype(self.dtype)
        target_pos = jnp.asarray(target_pos, self.dtype)
        target_yaw = jnp.asarray(target_yaw, self.dtype)
        if reference_positions is not None:
            targets = jnp.asarray(reference_positions, self.dtype)
        else:
            targets = jnp.tile(target_pos[None, :], (cfg.horizon, 1))

        key, sub = jax.random.split(carry.key)
        eps = jnp.asarray(cfg.noise_std, self.dtype) * jax.random.normal(
            sub, (cfg.num_samples, cfg.horizon, 4), self.dtype
        )
        U_cand = jnp.clip(carry.U_nom[None, :, :] + eps, self.u_lo, self.u_hi)

        costs = jax.vmap(
            lambda Us: self._rollout_cost(x0, Us, targets, target_yaw)
        )(U_cand)                                           # (K,)

        beta = jnp.min(costs)
        w = jax.nn.softmax(-(costs - beta) / cfg.temperature)
        # weighted average of the CLIPPED candidates (feasible by convexity
        # of the box) — the standard MPPI update with bounds
        U_new = jnp.einsum("k,knu->nu", w, U_cand)

        if cfg.return_trajectory:
            # nominal trajectory for diagnostics / parity with the MPC API
            def nom_step(x, u):
                x_new = rigid_body_rk4_step(x, u, self.params, cfg.dt)
                return x_new, x_new

            _, X_tail = jax.lax.scan(nom_step, x0, U_new)
            X_nom = jnp.concatenate([x0[None, :], X_tail], axis=0)
        else:
            X_nom = None

        u0 = U_new[0]
        U_shift = jnp.concatenate([U_new[1:], U_new[-1:]], axis=0)
        return u0, X_nom, MPPICarry(U_nom=U_shift, key=key)
