"""Monte-Carlo robustness evaluation: batched flights under randomized
plants, winds and initial conditions.

The reference evaluates each controller on ONE nominal plant per campaign
run (PX4 SITL with fixed parameters; the standalone harness's fixed-seed
comparison at ``/root/reference/quadrotor_gp_mpc/quadrotor_gp_mpc/main.py:417-541``).
It has no dispersion analysis — robustness is argued from a handful of bags.
Here a population IS one program: ``vmap`` over a pytree batch of
``RigidBodyParams`` / ``RateLoopParams`` (mass, drag, rate-loop lags,
hover-thrust calibration), steady wind vectors (``RigidBodyParams.wind``)
and jittered initial states turns a single flight rollout into an N-flight
Monte-Carlo study whose wall-clock is one batched rollout — the batch axis
shards over a device mesh exactly like ``parallel.sweep``.

Outputs use the campaign's own metric formulas (RMS / max position error,
``metrics.tracking``) plus dispersion statistics the reference cannot
produce: success rate (finite, no fly-away), error quantiles across the
population, and worst-case excursion.
"""

from __future__ import annotations

from typing import Callable

from .. import struct
import jax
import jax.numpy as jnp

from ..control.cascade_pid import CascadePidGains
from ..models.params import RigidBodyParams
from ..models.px4_surrogate import RateLoopParams
from .closed_loop import (
    FlightLoopConfig,
    mpc_flight_rollout,
    pid_flight_rollout,
)


@struct.dataclass
class MonteCarloConfig:
    """Dispersion model. Multiplicative jitters are log-normal
    (``param * exp(pct * N(0,1))``) so physical positivity is preserved;
    wind is additive Gaussian per world axis; initial state is jittered
    around the nominal start."""

    n_rollouts: int = 256
    seed: int = 0
    mass_jitter_pct: float = 0.10
    drag_jitter_pct: float = 0.30
    tau_jitter_pct: float = 0.20
    hover_thrust_jitter_pct: float = 0.03
    wind_std: float = 0.8            # m/s, steady world-frame wind per axis
    initial_pos_std: float = 0.3     # m
    initial_vel_std: float = 0.1     # m/s
    # metric window / crash classification
    settle_steps: int = 250          # ticks excluded from RMS (takeoff ramp)
    crash_error_m: float = 10.0      # max |pos err| beyond which a run "crashed"


def sample_conditions(
    key: jax.Array,
    mc: MonteCarloConfig,
    body: RigidBodyParams = RigidBodyParams(),
    rate_loop: RateLoopParams = RateLoopParams(),
    takeoff_height: float = 3.0,
):
    """Draw ``n_rollouts`` (bodies, rate_loops, initial_states).

    Returns pytrees whose leaves carry a leading batch axis — feed them to
    ``vmap``-ed rollouts (or shard the axis over a mesh)."""
    n = mc.n_rollouts
    keys = jax.random.split(key, 8)
    logn = lambda k, pct, shape=(n,): jnp.exp(
        pct * jax.random.normal(k, shape, jnp.float32)
    )

    mass = body.mass * logn(keys[0], mc.mass_jitter_pct)
    kdl = body.k_drag_linear * logn(keys[1], mc.drag_jitter_pct)
    kda = body.k_drag_angular * logn(keys[2], mc.drag_jitter_pct)
    wind = mc.wind_std * jax.random.normal(keys[3], (n, 3), jnp.float32)
    bodies = jax.vmap(
        lambda m, kl, ka, w: body.replace(
            mass=m, k_drag_linear=kl, k_drag_angular=ka,
            wind=(w[0], w[1], w[2]),
        )
    )(mass, kdl, kda, wind)

    taus = logn(keys[4], mc.tau_jitter_pct, (n, 3))
    hover = rate_loop.hover_thrust_norm * logn(
        keys[5], mc.hover_thrust_jitter_pct
    )
    rate_loops = jax.vmap(
        lambda t, h: rate_loop.replace(
            tau_roll=rate_loop.tau_roll * t[0],
            tau_pitch=rate_loop.tau_pitch * t[1],
            tau_yaw=rate_loop.tau_yaw * t[2],
            hover_thrust_norm=h,
        )
    )(taus, hover)

    x0 = jnp.zeros((n, 12), jnp.float32).at[:, 2].set(takeoff_height)
    x0 = x0.at[:, 0:3].add(
        mc.initial_pos_std * jax.random.normal(keys[6], (n, 3), jnp.float32)
    )
    x0 = x0.at[:, 3:6].add(
        mc.initial_vel_std * jax.random.normal(keys[7], (n, 3), jnp.float32)
    )
    return bodies, rate_loops, x0


def robustness_stats(
    positions: jnp.ndarray,     # (B, T, 3)
    pos_ref: jnp.ndarray,       # (T, 3)
    settle_steps: int,
    crash_error_m: float,
) -> dict:
    """Population dispersion statistics (in-graph)."""
    err = jnp.linalg.norm(positions - pos_ref[None, :, :], axis=-1)  # (B, T)
    window = err[:, settle_steps:]
    rms = jnp.sqrt(jnp.mean(window**2, axis=1))
    max_err = jnp.max(err, axis=1)
    finite = jnp.isfinite(positions).all(axis=(1, 2))
    success = finite & (max_err < crash_error_m)

    rms_ok = jnp.where(success, rms, jnp.nan)
    pct = lambda q: jnp.nanpercentile(rms_ok, q)
    return {
        "rms_pos": rms,
        "max_pos": max_err,
        "success": success,
        "success_rate": jnp.mean(success.astype(jnp.float32)),
        "rms_mean": jnp.nanmean(rms_ok),
        "rms_p50": pct(50.0),
        "rms_p90": pct(90.0),
        "rms_p99": pct(99.0),
        "worst_max_pos": jnp.max(jnp.where(finite, max_err, jnp.inf)),
    }


def monte_carlo_flights(
    flight_fn: Callable,
    reference_fn: Callable,
    num_steps: int,
    mc: MonteCarloConfig = MonteCarloConfig(),
    body: RigidBodyParams = RigidBodyParams(),
    rate_loop: RateLoopParams = RateLoopParams(),
    loop_cfg: FlightLoopConfig = FlightLoopConfig(),
) -> dict:
    """Generic engine: ``flight_fn(body_i, rate_loop_i, x0_i) -> state (T,12)``
    is vmapped over sampled conditions; returns ``robustness_stats``.

    The plant scalars (mass/drag/rate-lags/hover-thrust/wind) are traced,
    so ``vmap`` over the dispersion batch compiles one program for the
    whole population. Set ``loop_cfg.fallback_error_m (e.g. 5.0) to bound worst-case excursions
    with the reference's divergence-triggered hover fallback
    (``src/px4/mpc.py:2276-2282``)."""
    key = jax.random.PRNGKey(mc.seed)
    bodies, rate_loops, x0 = sample_conditions(
        key, mc, body, rate_loop, loop_cfg.takeoff_height
    )
    states = jax.vmap(flight_fn)(bodies, rate_loops, x0)   # (B, T, 12)

    ts = jnp.arange(num_steps, dtype=jnp.float32) * loop_cfg.control_dt
    pos_ref, _ = jax.vmap(reference_fn)(ts)
    return robustness_stats(
        states[:, :, 0:3], jnp.asarray(pos_ref, jnp.float32),
        mc.settle_steps, mc.crash_error_m,
    )


def monte_carlo_pid(
    reference_fn: Callable,
    num_steps: int,
    mc: MonteCarloConfig = MonteCarloConfig(),
    gains: CascadePidGains | None = None,
    body: RigidBodyParams = RigidBodyParams(),
    rate_loop: RateLoopParams = RateLoopParams(),
    loop_cfg: FlightLoopConfig = FlightLoopConfig(),
) -> dict:
    """Cascade-PID population study."""

    def flight(b, r, x0):
        return pid_flight_rollout(
            reference_fn, num_steps, gains=gains, body=b, rate_loop=r,
            cfg=loop_cfg, initial_state=x0,
        )["state"]

    return monte_carlo_flights(
        flight, reference_fn, num_steps, mc, body, rate_loop, loop_cfg
    )


def monte_carlo_mpc(
    mpc,
    reference_fn: Callable,
    num_steps: int,
    mc: MonteCarloConfig = MonteCarloConfig(),
    residual_fn: Callable | None = None,
    preview: bool = False,
    body: RigidBodyParams = RigidBodyParams(),
    rate_loop: RateLoopParams = RateLoopParams(),
    loop_cfg: FlightLoopConfig = FlightLoopConfig(),
) -> dict:
    """(GP-)MPC population study."""

    def flight(b, r, x0):
        return mpc_flight_rollout(
            mpc, reference_fn, num_steps, body=b, rate_loop=r, cfg=loop_cfg,
            initial_state=x0, residual_fn=residual_fn, preview=preview,
        )["state"]

    return monte_carlo_flights(
        flight, reference_fn, num_steps, mc, body, rate_loop, loop_cfg
    )


def monte_carlo_mpc12(
    engine,
    reference_fn: Callable,
    num_steps: int,
    mc: MonteCarloConfig = MonteCarloConfig(),
    body: RigidBodyParams | None = None,
    ticks_per_dispatch: int = 8,
    admm_iterations: int = 30,
    dt: float = 0.02,
    takeoff_height: float = 3.0,
    use_fallback: bool = True,
) -> dict:
    """12-state-family population study: the multitick tier under a
    dispersed TRUE plant.

    ``engine`` is a nominal-model controller (``control.mpc_rigid
    .RigidBodyMPC`` torque engine — the reference's ``mpc_FULL.py:86-549``
    formulation); each sample's true plant is a jittered
    ``RigidBodyParams`` (mass / drag / wind, log-normal per
    ``MonteCarloConfig``) stepped by ``models.rigid_body_rk4_step`` while
    the controller keeps flying its NOMINAL model — the controller-side
    mismatch is the point of the study. The whole population is ONE
    ``vmap`` of ``loop.rigid_loop.sqp_multitick_rollout`` (pure XLA at
    this tier, so the batch axis adds no recompiles and shards over a
    mesh like ``parallel.sweep``).

    NOTE ``X500_PARAMS`` has zero drag, so wind (which enters through the
    airspeed drag term) is inert there — pass a drag-carrying ``body``
    (e.g. ``GZ_QUADROTOR_PARAMS``-class values at your mass) for the wind
    axis to bite, or rely on the mass / initial-state axes.

    ``use_fallback`` arms ``make_attitude_recovery_fallback`` (the
    reference's emergency-hover semantics) per tick, clamped to the
    vehicle's physical thrust ceiling. Measured finding (64-member
    mass dispersion): the nominal-model torque MPC has an ASYMMETRIC
    robustness cliff — members whose hover demand reaches the engine's
    1.2x-nominal thrust bound (``mpc_FULL.py`` parity constant; ~+17 %
    mass) pin thrust at the bound, sag, wind up the bound's ADMM duals
    across warm-started dispatches and eventually tip, while LIGHT members
    only degrade gracefully (steady-state sag proportional to the mass
    error — the engine has no integral action, also reference-faithful).
    The guard keeps crashed members' states finite; it cannot save a
    vehicle whose hover demand exceeds its actuators.

    ``reference_fn(t) -> (pos (3,), yaw)``; returns ``robustness_stats``.
    """
    from ..models.rigid_body import rigid_body_rk4_step
    from .rigid_loop import (
        make_attitude_recovery_fallback,
        sqp_multitick_rollout,
    )

    if body is None:
        from ..models import X500_PARAMS

        body = X500_PARAMS
    N = engine.mpc.config.horizon
    key = jax.random.PRNGKey(mc.seed)
    bodies, _, x0 = sample_conditions(
        key, mc, body, RateLoopParams(), takeoff_height
    )

    def ref_ticks(ticks):
        ts = ticks.astype(jnp.float32) * dt
        pos = jax.vmap(lambda t: jnp.asarray(reference_fn(t)[0],
                                             jnp.float32))(ts)
        stage = jnp.concatenate(
            [pos, jnp.zeros((ts.shape[0], 9), jnp.float32)], axis=1
        )
        return jnp.tile(stage[:, None, :], (1, N, 1))

    # the guard compensates gravity with the NOMINAL mass — the controller
    # doesn't get to peek at the sampled plant — and its thrust is clamped
    # to the same 1.2x-nominal actuator ceiling the engine's bounds model
    fallback = (
        make_attitude_recovery_fallback(
            body, thrust_max=1.2 * body.mass * body.gravity)
        if use_fallback else None
    )

    def flight(b, x0_i):
        plant = lambda x, u: rigid_body_rk4_step(x, u, b, dt)
        outs = sqp_multitick_rollout(
            engine.mpc, engine.cost, ref_ticks, plant, x0_i, num_steps,
            ticks_per_dispatch=ticks_per_dispatch,
            admm_iterations=admm_iterations, u_init=engine.u_hover,
            fallback_fn=fallback,
        )
        return outs["state"]

    states = jax.vmap(flight)(bodies, x0)          # (B, T, 12)
    ts = jnp.arange(num_steps, dtype=jnp.float32) * dt
    pos_ref = jax.vmap(
        lambda t: jnp.asarray(reference_fn(t)[0], jnp.float32)
    )(ts)
    return robustness_stats(
        states[:, :, 0:3], pos_ref, mc.settle_steps, mc.crash_error_m
    )
