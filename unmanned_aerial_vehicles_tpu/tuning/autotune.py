"""Differentiable closed-loop controller auto-tuning.

The reference hand-tunes every controller: the cascade PID ships an
"EMERGENCY SAFETY" gain set arrived at by trial flights
(``/root/reference/src/px4/cascade_pid_demo.py:194-210``) and the MPC cost
weights are hard-coded constants (``/root/reference/src/px4/mpc.py:1384-1418``).
There is no counterpart to this module — it is a capability the
one-program design gets for free: a whole flight is ONE ``lax.scan``
(``loop/closed_loop.py``), so the campaign RMS is a *differentiable* function
of the gain pytree, and controller tuning becomes gradient descent through
the closed loop (plant included) instead of manual iteration.

Two tuners:

* ``tune_cascade_gains`` — tunes the 27 kp/ki/kd gains of the 9-loop cascade
  (positivity enforced by log-space parametrisation; the reference's
  safety limits — output/integral clamps, rate/thrust clips — stay fixed).
* ``tune_mpc_weights`` — tunes the linear MPC's Q/R/terminal weights through
  the full GP-MPC tick (condensed QP + ADMM + allocation + plant). The ADMM
  loop has a fixed iteration count, so reverse-mode AD through the solver is
  exact (no implicit-function tricks needed) — the condensed QP is rebuilt
  in-graph from traced weights (``ops.qp.admm_box_qp_chol``).

Both scan the optimiser loop on device: ``iterations`` full-flight
value-and-grad evaluations compile to a single XLA program. Multi-start
variants ``vmap`` the whole tuning run over jittered initialisations.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Tuple

from .. import struct
import jax
import jax.numpy as jnp
import numpy as np
import optax

from ..control.cascade_pid import CascadePidGains
from ..control.mpc_linear import LinearMPCConfig, MPCCarry
from ..loop.closed_loop import FlightLoopConfig, mpc_flight_rollout, pid_flight_rollout
from ..models.params import RigidBodyParams
from ..models.px4_surrogate import RateLoopParams


class TuningResult(NamedTuple):
    params: object          # tuned gain pytree (CascadePidGains / weight dict)
    losses: jnp.ndarray     # (iterations,) loss trace
    initial_loss: jnp.ndarray
    final_loss: jnp.ndarray


@struct.dataclass
class TuneConfig:
    iterations: int = 60
    learning_rate: float = 0.05
    # loss = mean squared tracking error after the take-off/ramp transient
    # + effort_weight * mean squared actuation (keeps solutions from
    # trading tracking for bang-bang commands)
    settle_steps: int = 250           # 5 s at 50 Hz (the reference tanh ramp)
    effort_weight: float = 1e-3


# ---------------------------------------------------------------------------
# generic optimiser loop (used by both tuners)
# ---------------------------------------------------------------------------


def tune_parameters(
    loss_fn: Callable,
    init_params,
    iterations: int,
    learning_rate: float = 0.05,
    optimizer: optax.GradientTransformation | None = None,
):
    """Scan ``iterations`` optax steps of ``loss_fn`` over ``init_params``.

    The whole loop is one jittable program; returns the *best-seen* params
    (gradient descent through a saturating closed loop is not monotone, so
    the last iterate is not always the best one) and the loss trace.
    """
    opt = optimizer if optimizer is not None else optax.adam(learning_rate)
    vg = jax.value_and_grad(loss_fn)

    def _step(carry, _):
        params, opt_state, best_params, best_loss = carry
        loss, grads = vg(params)
        # reject non-finite steps (a diverging candidate must not poison
        # the run — mirrors the in-graph hover fallback philosophy)
        grads = jax.tree_util.tree_map(
            lambda g: jnp.where(jnp.isfinite(g), g, 0.0), grads
        )
        updates, opt_state = opt.update(grads, opt_state, params)
        new_params = optax.apply_updates(params, updates)
        improved = jnp.isfinite(loss) & (loss < best_loss)
        best_params = jax.tree_util.tree_map(
            lambda b, p: jnp.where(improved, p, b), best_params, params
        )
        best_loss = jnp.where(improved, loss, best_loss)
        return (new_params, opt_state, best_params, best_loss), loss

    def _run(params0):
        init = (
            params0,
            opt.init(params0),
            params0,
            jnp.asarray(jnp.inf, jnp.float32),
        )
        (params, _, best_params, best_loss), losses = jax.lax.scan(
            _step, init, None, length=iterations
        )
        # one final evaluation so the last iterate also competes
        final_loss = loss_fn(params)
        take_last = jnp.isfinite(final_loss) & (final_loss < best_loss)
        best_params = jax.tree_util.tree_map(
            lambda b, p: jnp.where(take_last, p, b), best_params, params
        )
        best_loss = jnp.where(take_last, final_loss, best_loss)
        return best_params, losses, best_loss

    return jax.jit(_run)(init_params)


def _tracking_loss(outs, settle_steps: int, effort_weight: float):
    err = outs["state"][:, 0:3] - outs["pos_ref"]
    err = err[settle_steps:]
    mse = jnp.mean(jnp.sum(err**2, axis=-1))
    effort = jnp.mean(outs["rates_cmd"][settle_steps:] ** 2)
    return mse + effort_weight * effort


# ---------------------------------------------------------------------------
# cascade-PID gain tuning
# ---------------------------------------------------------------------------


def _cascade_theta(gains: CascadePidGains) -> dict:
    """Log-space copies of the tunable leaves (kp/ki/kd per layer)."""
    out = {}
    for layer in ("position", "velocity", "attitude"):
        pid = getattr(gains, layer)
        for k in ("kp", "ki", "kd"):
            out[f"{layer}_{k}"] = jnp.log(
                jnp.maximum(jnp.asarray(getattr(pid, k), jnp.float32), 1e-6)
            )
    return out


def _cascade_gains(theta: dict, template: CascadePidGains) -> CascadePidGains:
    """Rebuild a gain pytree from log-parameters, keeping the template's
    safety limits (max_output / max_integral / thrust / rate clips) fixed."""
    layers = {}
    for layer in ("position", "velocity", "attitude"):
        pid = getattr(template, layer)
        layers[layer] = pid.replace(
            kp=jnp.exp(theta[f"{layer}_kp"]),
            ki=jnp.exp(theta[f"{layer}_ki"]),
            kd=jnp.exp(theta[f"{layer}_kd"]),
        )
    return template.replace(**layers)


def tune_cascade_gains(
    reference_fn: Callable,
    num_steps: int,
    init_gains: CascadePidGains | None = None,
    tune_cfg: TuneConfig = TuneConfig(),
    body: RigidBodyParams = RigidBodyParams(),
    rate_loop: RateLoopParams = RateLoopParams(),
    loop_cfg: FlightLoopConfig = FlightLoopConfig(),
) -> TuningResult:
    """Gradient-descend the cascade's 27 PID gains through a full flight.

    ``reference_fn(t) -> (pos3, yaw)`` as in ``pid_flight_rollout``. The
    rollout, loss, gradient and optimiser loop fuse into one XLA program.
    """
    template = init_gains if init_gains is not None else CascadePidGains.default()
    template = jax.tree_util.tree_map(
        lambda x: jnp.asarray(x, jnp.float32), template
    )

    def loss_fn(theta):
        gains = _cascade_gains(theta, template)
        outs = pid_flight_rollout(
            reference_fn, num_steps, gains=gains, body=body,
            rate_loop=rate_loop, cfg=loop_cfg,
        )
        return _tracking_loss(outs, tune_cfg.settle_steps, tune_cfg.effort_weight)

    theta0 = _cascade_theta(template)
    initial_loss = jax.jit(loss_fn)(theta0)
    theta, losses, final_loss = tune_parameters(
        loss_fn, theta0, tune_cfg.iterations, tune_cfg.learning_rate
    )
    return TuningResult(
        params=_cascade_gains(theta, template),
        losses=losses,
        initial_loss=initial_loss,
        final_loss=final_loss,
    )


def tune_cascade_gains_multistart(
    reference_fn: Callable,
    num_steps: int,
    n_starts: int = 8,
    jitter: float = 0.3,
    seed: int = 0,
    init_gains: CascadePidGains | None = None,
    tune_cfg: TuneConfig = TuneConfig(),
    body: RigidBodyParams = RigidBodyParams(),
    rate_loop: RateLoopParams = RateLoopParams(),
    loop_cfg: FlightLoopConfig = FlightLoopConfig(),
) -> TuningResult:
    """``vmap`` the whole tuning run over ``n_starts`` jittered inits
    (log-space Gaussian jitter, start 0 unjittered) and return the best.

    On a device mesh the start axis shards like any batch axis — this is
    the tuning analogue of ``parallel.sweep``."""
    template = init_gains if init_gains is not None else CascadePidGains.default()
    template = jax.tree_util.tree_map(
        lambda x: jnp.asarray(x, jnp.float32), template
    )

    def loss_fn(theta):
        gains = _cascade_gains(theta, template)
        outs = pid_flight_rollout(
            reference_fn, num_steps, gains=gains, body=body,
            rate_loop=rate_loop, cfg=loop_cfg,
        )
        return _tracking_loss(outs, tune_cfg.settle_steps, tune_cfg.effort_weight)

    theta0 = _cascade_theta(template)
    keys = jax.random.split(jax.random.PRNGKey(seed), n_starts)

    def jittered(key, i):
        leaves, treedef = jax.tree_util.tree_flatten(theta0)
        subkeys = jax.random.split(key, len(leaves))
        noisy = [
            leaf + jitter * jax.random.normal(k, jnp.shape(leaf), jnp.float32)
            for leaf, k in zip(leaves, subkeys)
        ]
        noisy = [
            jnp.where(i == 0, leaf, n) for leaf, n in zip(leaves, noisy)
        ]
        return jax.tree_util.tree_unflatten(treedef, noisy)

    thetas = jax.vmap(jittered)(keys, jnp.arange(n_starts))

    def one_run(theta_init):
        theta, losses, final_loss = tune_parameters(
            loss_fn, theta_init, tune_cfg.iterations, tune_cfg.learning_rate
        )
        return theta, losses, final_loss

    thetas_out, losses, final_losses = jax.vmap(one_run)(thetas)
    best = jnp.argmin(final_losses)
    theta_best = jax.tree_util.tree_map(lambda x: x[best], thetas_out)
    return TuningResult(
        params=_cascade_gains(theta_best, template),
        losses=losses[best],
        initial_loss=jax.jit(loss_fn)(
            jax.tree_util.tree_map(lambda x: x[0], thetas)
        ),
        final_loss=final_losses[best],
    )


# ---------------------------------------------------------------------------
# MPC cost-weight tuning (differentiable MPC)
# ---------------------------------------------------------------------------


class _TracedWeightMPC:
    """LinearMPC twin whose Q/R weights are *traced* (ops.qp.admm_box_qp_chol).

    The deployment controller (``control.mpc_linear.LinearMPC``) bakes its
    condensed matrices into the program as compile-time constants — optimal
    for flight, opaque to autodiff. This twin rebuilds ``H``/``M`` in-graph
    from a weight pytree each solve (one extra (4N)^2 Cholesky per tick), so
    ``jax.grad`` flows from the flight RMS back into the weights. Solver
    semantics (shift, ADMM splitting, slack U-block extraction) match
    ``LinearMPC.solve`` exactly at equal iteration counts.
    """

    def __init__(self, weights: dict, config: LinearMPCConfig):
        from ..models.double_integrator import CONTROL_DIM, STATE_DIM
        from ..ops.qp import condense_dynamics

        self.config = config
        self.dtype = jnp.float32
        N, dt = config.horizon, config.dt
        nx, nu = STATE_DIM, CONTROL_DIM
        self._nx, self._nu = nx, nu

        A = np.eye(nx)
        A[0:3, 3:6] = dt * np.eye(3)
        B = np.zeros((nx, nu))
        B[3:6, 0:3] = dt * np.eye(3)
        Sx, Su, Sw = condense_dynamics(A, B, N)
        f32 = lambda a: np.asarray(a, np.float32)
        self._Sx, self._Su, self._Sw = f32(Sx), f32(Su), f32(Sw)
        self._G = f32(np.vstack([np.eye(N * nu), Su]))
        self._u_lo = f32(np.tile(config.control_lower, N))
        self._u_hi = f32(np.tile(config.control_upper, N))
        self._x_lo = f32(np.tile(config.state_lower, N))
        self._x_hi = f32(np.tile(config.state_upper, N))
        self.n_primal = N * nu
        self.n_constraints = self._G.shape[0]
        self._weights = weights

        # Build the traced cost/factorisation ONCE here: the twin is
        # constructed per loss evaluation, outside the flight scan, so
        # these (weight-dependent, state-independent) values are
        # loop-invariant — recomputing the (4N)^2 Cholesky per tick would
        # multiply the tuner's hot-loop cost by num_steps.
        cfg = config
        w = weights
        q_stage = jnp.concatenate(
            [jnp.exp(w["log_q_pos"]), jnp.exp(w["log_q_vel"])]
        )
        q_term = jnp.concatenate(
            [
                jnp.exp(w["log_terminal_pos"]) * jnp.exp(w["log_q_pos"]),
                jnp.exp(w["log_terminal_vel"]) * jnp.exp(w["log_q_vel"]),
            ]
        )
        qbar = jnp.concatenate([jnp.tile(q_stage, N - 1), q_term])
        rbar = jnp.tile(jnp.exp(w["log_r"]), N)
        prec = jax.lax.Precision.HIGHEST
        mm = lambda a, b: jnp.matmul(a, b, precision=prec)
        Su_j = jnp.asarray(self._Su)
        G_j = jnp.asarray(self._G)
        self._SuTq = Su_j.T * qbar[None, :]
        H = mm(self._SuTq, Su_j) + jnp.diag(rbar)
        M = H + cfg.admm_rho * mm(G_j.T, G_j)
        self._M_chol = jnp.linalg.cholesky(M)


    def init_carry(self, state=None) -> MPCCarry:
        N = self.config.horizon
        x0 = (
            jnp.zeros(self._nx, self.dtype)
            if state is None
            else state.astype(self.dtype)
        )
        return MPCCarry(
            slack=jnp.zeros(self.n_constraints, self.dtype),
            dual=jnp.zeros(self.n_constraints, self.dtype),
            X_prev=jnp.tile(x0[None, :], (N + 1, 1)),
            U_prev=jnp.zeros((N, self._nu), self.dtype),
        )

    def solve(self, carry, state, target_pos, residuals=None,
              reference_states=None, uncertainty=None):
        from ..ops.qp import admm_box_qp_chol

        cfg = self.config
        N = cfg.horizon
        nx, nu = self._nx, self._nu
        x0 = state.astype(self.dtype)
        # identical shift policy (reuse LinearMPC's implementation)
        from ..control.mpc_linear import LinearMPC

        carry = LinearMPC._shift(self, carry, x0)

        w_vec = (
            jnp.zeros(N * nx, self.dtype)
            if residuals is None
            else (cfg.dt * residuals.astype(self.dtype)).reshape(-1)
        )
        if reference_states is not None:
            ref = reference_states.astype(self.dtype).reshape(-1)
        else:
            ref = jnp.tile(
                jnp.concatenate(
                    [target_pos.astype(self.dtype), jnp.zeros(3, self.dtype)]
                ),
                N,
            )

        prec = jax.lax.Precision.HIGHEST
        mm = lambda a, b: jnp.matmul(a, b, precision=prec)
        Su = jnp.asarray(self._Su)
        G = jnp.asarray(self._G)
        M_chol = self._M_chol

        offset = mm(jnp.asarray(self._Sx), x0) + mm(jnp.asarray(self._Sw), w_vec)
        f = mm(self._SuTq, offset - ref)
        lower = jnp.concatenate([jnp.asarray(self._u_lo), self._x_lo - offset])
        upper = jnp.concatenate([jnp.asarray(self._u_hi), self._x_hi - offset])

        sol = admm_box_qp_chol(
            M_chol, G, f, lower, upper, carry.slack, carry.dual,
            cfg.admm_rho, cfg.admm_iterations, cfg.admm_over_relax,
        )
        U = sol.slack[: N * nu].reshape(N, nu)
        X_tail = (offset + mm(Su, sol.primal)).reshape(N, nx)
        X_opt = jnp.concatenate([x0[None, :], X_tail], axis=0)
        new_carry = MPCCarry(
            slack=sol.slack, dual=sol.dual, X_prev=X_opt, U_prev=U
        )
        return U[0], X_opt, new_carry


def mpc_weights_theta(config: LinearMPCConfig) -> dict:
    """Log-space weight pytree seeded from a config's Q/R/terminal values."""
    log = lambda v: jnp.log(jnp.asarray(v, jnp.float32))
    return {
        "log_q_pos": log(config.q_pos),
        "log_q_vel": log(config.q_vel),
        "log_r": log(config.r_control),
        "log_terminal_pos": log(config.terminal_pos_weight),
        "log_terminal_vel": log(config.terminal_vel_weight),
    }


def mpc_config_from_theta(theta: dict, base: LinearMPCConfig) -> LinearMPCConfig:
    """Concrete (host-float) config from a tuned weight pytree — feed this to
    the deployment ``LinearMPC`` to fly the tuned weights at full speed."""
    t = lambda k: tuple(float(v) for v in np.exp(np.asarray(theta[k])))
    return base.replace(
        q_pos=t("log_q_pos"),
        q_vel=t("log_q_vel"),
        r_control=t("log_r"),
        terminal_pos_weight=float(np.exp(np.asarray(theta["log_terminal_pos"]))),
        terminal_vel_weight=float(np.exp(np.asarray(theta["log_terminal_vel"]))),
    )


def tune_mpc_weights(
    reference_fn: Callable,
    num_steps: int,
    base_config: LinearMPCConfig | None = None,
    tune_cfg: TuneConfig = TuneConfig(iterations=30, learning_rate=0.08),
    body: RigidBodyParams = RigidBodyParams(),
    rate_loop: RateLoopParams = RateLoopParams(),
    loop_cfg: FlightLoopConfig = FlightLoopConfig(),
    residual_fn: Callable | None = None,
    preview: bool = False,
) -> Tuple[TuningResult, LinearMPCConfig]:
    """Tune the MPC's 16 cost weights by gradient descent through the
    closed GP-MPC loop (QP solver included).

    Returns ``(TuningResult with the weight pytree, tuned LinearMPCConfig)``.
    The returned config drops straight into the deployment ``LinearMPC``
    (compile-time-constant matrices).
    """
    base = base_config if base_config is not None else LinearMPCConfig()

    def loss_fn(theta):
        mpc = _TracedWeightMPC(theta, base)
        outs = mpc_flight_rollout(
            mpc, reference_fn, num_steps, body=body, rate_loop=rate_loop,
            cfg=loop_cfg, residual_fn=residual_fn, preview=preview,
        )
        return _tracking_loss(outs, tune_cfg.settle_steps, tune_cfg.effort_weight)

    theta0 = mpc_weights_theta(base)
    initial_loss = jax.jit(loss_fn)(theta0)
    theta, losses, final_loss = tune_parameters(
        loss_fn, theta0, tune_cfg.iterations, tune_cfg.learning_rate
    )
    result = TuningResult(
        params=theta, losses=losses,
        initial_loss=initial_loss, final_loss=final_loss,
    )
    return result, mpc_config_from_theta(
        jax.tree_util.tree_map(np.asarray, theta), base
    )
