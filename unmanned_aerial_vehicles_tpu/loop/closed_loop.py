"""Closed-loop rollouts (reference -> controller -> allocation -> plant).

The reference runs its control loops as ROS 2 timer callbacks across multiple
processes (controller node -> DDS -> microXRCE -> PX4 -> Gazebo, SURVEY.md
section 3.1). Here a whole flight is ONE jitted ``lax.scan``: every tick fuses
trajectory evaluation, the controller, geometric allocation and the plant
into a single XLA program, and ``vmap`` turns one flight into a 1k-flight
batch sweep (BASELINE.json config 5).

Loop structure mirrors the trajectory phase of the reference nodes:

* ``pid_flight_rollout`` — 9-loop cascade PID @ 50 Hz commanding body rates +
  thrust, plant integrating at 100 Hz
  (``/root/reference/src/px4/cascade_pid_demo.py:471-560``).
* ``mpc_flight_rollout`` — linear MPC @ 50 Hz -> acceleration clip ->
  geometric allocation -> body rates + thrust
  (``/root/reference/src/px4/mpc.py:2238-2310`` trajectory phase, with the
  MPC accel clips of ``mpc.py:2030-2040``), optionally with a frozen GP
  posterior, in-flight GP learning and mid-flight resume.
* ``batched_mpc_flight_sweep`` — B of those flights in lockstep.

The plant is the PX4 surrogate (rate-tracking inner loop), standing in for
PX4 SITL + Gazebo so runs are comparable to the baseline campaign.
"""

from __future__ import annotations

import functools
from typing import Callable, Tuple

from .. import struct
import jax
import jax.numpy as jnp

from ..control.allocation import attitude_loop_init, geometric_control_allocation
from ..control.cascade_pid import CascadePidGains, cascade_init, cascade_pid_step
from ..control.mpc_linear import LinearMPC
from ..gp.residual_gp import (
    ResidualGPConfig,
    build_horizon_residuals,
    build_horizon_residuals_batched,
    build_horizon_uncertainty,
    empty_dataset,
    fit_online_gp,
    online_gp_update,
)
from ..models.params import RigidBodyParams
from ..models.px4_surrogate import RateLoopParams, px4_rate_tracking_step


@struct.dataclass
class FlightLoopConfig:
    control_dt: float = 0.02      # 50 Hz control loop (mpc.py:1868)
    plant_substeps: int = 2       # plant RK4 at 100 Hz (quadrotor_dynamics.py:85)
    takeoff_height: float = 3.0   # mpc.py:1724
    accel_lower: Tuple[float, float, float] = (-3.5, -3.5, -4.0)  # mpc.py:2033
    accel_upper: Tuple[float, float, float] = (3.5, 3.5, 6.0)
    yawrate_limit: float = 0.8    # mpc.py:2035
    # position-error-triggered safety fallback (the reference's >50 m hover
    # -mode switch, src/px4/mpc.py:2276-2282): when |pos - pos_ref| exceeds
    # this threshold the MPC command is replaced in-graph by the reference's
    # fallback PD law a = 1.5 e - 0.8 v (mpc.py:2117-2130), bounding
    # Monte-Carlo worst-case excursions. 0.0 disables (bit-exact baseline).
    fallback_error_m: float = 0.0
    # while the fallback is ENGAGED, the PD command may use this multiple
    # of the cruise acceleration clips (recovery uses the platform's
    # physical authority: extreme wind-x-drag members exceed the nominal
    # +-3.5 m/s^2 lateral clip and cannot recover inside it)
    fallback_accel_scale: float = 1.5
    # normalized-thrust clamp while the fallback is ENGAGED. The nominal
    # allocation clamps at the reference's 1.2 (mpc.py:2064); dispersed
    # members that diverge are typically PINNED there (heavy + high hover
    # calibration + downdraft wind -> steady sink no accel command can fix),
    # so recovery needs the physical headroom a real airframe has (PX4 full
    # throttle at the PID campaign's 0.7 hover calibration = 1.43).
    fallback_thrust_ceiling: float = 1.5


def _plant_substeps(state, control, body, rate_loop, cfg: FlightLoopConfig):
    dt_sub = cfg.control_dt / cfg.plant_substeps

    def sub(x, _):
        # traced plant parameters (dispersion batches) may be wider than
        # the state; the state keeps its dtype
        x_next = px4_rate_tracking_step(x, control, body, rate_loop, dt_sub)
        return x_next.astype(x.dtype), None

    state, _ = jax.lax.scan(sub, state, None, length=cfg.plant_substeps)
    return state


def preview_reference_states(reference_fn, t, horizon, control_dt, dtype):
    """``(N, 6)`` per-stage references sampled along the horizon: position
    plus finite-difference velocity (the trajectory *preview*)."""
    ts = t + control_dt * jnp.arange(1, horizon + 2, dtype=dtype)
    pos_refs, _ = jax.vmap(reference_fn)(ts)                  # (N+1, 3)
    pos_refs = jnp.asarray(pos_refs, dtype)
    vel_refs = (pos_refs[1:] - pos_refs[:-1]) / control_dt
    return jnp.concatenate([pos_refs[:-1], vel_refs], axis=1)


def mpc_command(u_opt, state, pos_ref, cfg: FlightLoopConfig):
    """MPC solution -> (accel, yawrate, thrust ceiling) as allocated: the
    reference's clips (``mpc.py:2030-2040``) and, when enabled, the
    divergence fallback (trigger ``mpc.py:2276-2282``, law
    ``mpc.py:2117-2130``) with its recovery thrust headroom."""
    dtype = u_opt.dtype
    accel_lo = jnp.asarray(cfg.accel_lower, dtype)
    accel_hi = jnp.asarray(cfg.accel_upper, dtype)
    accel_des = jnp.clip(u_opt[0:3], accel_lo, accel_hi)
    yawrate_des = jnp.clip(u_opt[3], -cfg.yawrate_limit, cfg.yawrate_limit)
    thrust_ceiling = 1.2
    if cfg.fallback_error_m > 0.0:
        e = pos_ref - state[0:3]
        diverged = jnp.sum(e * e) > cfg.fallback_error_m**2
        k = cfg.fallback_accel_scale
        a_fb = jnp.clip(1.5 * e - 0.8 * state[3:6], k * accel_lo, k * accel_hi)
        accel_des = jnp.where(diverged, a_fb, accel_des)
        yawrate_des = jnp.where(diverged, 0.0, yawrate_des)
        thrust_ceiling = jnp.where(diverged, cfg.fallback_thrust_ceiling, 1.2)
    return accel_des, yawrate_des, thrust_ceiling


def mpc_tick(
    mpc: LinearMPC, cfg: FlightLoopConfig, body, rate_loop,
    state, mpc_carry, att_carry, pos_ref, yaw_ref,
    residuals=None, ref_states=None, uncertainty=None,
    output_correction_fn=None, est=None,
):
    """One control tick: MPC solve -> command -> allocation + attitude PID
    -> plant substeps. The controller sees ``est`` (default: the true
    ``state``); the plant always integrates ``state``.

    Returns ``(new_state, mpc_carry, att_carry, out)``; ``out["control"]``
    is the applied ``[accel, yawrate]`` command."""
    seen = state if est is None else est
    u_opt, X_opt, mpc_carry = mpc.solve(
        mpc_carry, seen[0:6], pos_ref, residuals,
        reference_states=ref_states, uncertainty=uncertainty,
    )
    if output_correction_fn is not None:
        u_opt = output_correction_fn(seen[0:6], u_opt, pos_ref)
    accel_des, yawrate_des, thrust_ceiling = mpc_command(u_opt, seen, pos_ref, cfg)
    thrust, rate_cmd, att_sp, att_carry = geometric_control_allocation(
        att_carry, accel_des, yaw_ref, yawrate_des, seen[6:9], seen[9:12],
        dt_attitude=cfg.control_dt, thrust_ceiling=thrust_ceiling,
    )
    control = jnp.concatenate([thrust[None], rate_cmd])
    new_state = _plant_substeps(state, control, body, rate_loop, cfg)
    out = {
        "state": state,
        "pos_ref": pos_ref,
        "vel_ref": X_opt[1, 3:6],   # predicted next velocity (mpc.py:2042)
        "att_ref": att_sp,
        "thrust": thrust,
        "rates_cmd": rate_cmd,
        "accel_cmd": accel_des,
        "u_mpc": u_opt,   # raw (pre-clip) QP solution — parity tests
        "control": jnp.concatenate([accel_des, yawrate_des[None]]),
    }
    return new_state, mpc_carry, att_carry, out


def pid_flight_rollout(
    reference_fn: Callable,
    num_steps: int,
    gains: CascadePidGains | None = None,
    body: RigidBodyParams = RigidBodyParams(),
    rate_loop: RateLoopParams = RateLoopParams(),
    cfg: FlightLoopConfig = FlightLoopConfig(),
    initial_state: jnp.ndarray | None = None,
    dtype=jnp.float32,
):
    """Closed-loop cascade-PID flight.

    ``reference_fn(t) -> (pos3, yaw)`` in world frame (absolute z).
    Returns a dict of stacked per-tick signals.
    """
    if gains is None:
        gains = CascadePidGains.default()
    # pin the gain pytree to the loop dtype (CascadePidGains.default() builds
    # f64 leaves when x64 is on, which would promote the scan carries)
    gains = jax.tree_util.tree_map(lambda x: jnp.asarray(x, dtype), gains)
    if initial_state is None:
        initial_state = jnp.zeros(12, dtype).at[2].set(cfg.takeoff_height)

    def step(carry, i):
        state, pid_state = carry
        t = i.astype(dtype) * cfg.control_dt
        pos_ref, yaw_ref = reference_fn(t)
        # guard against x64 promotion leaking in from user reference fns
        pos_ref = jnp.asarray(pos_ref, dtype)
        yaw_ref = jnp.asarray(yaw_ref, dtype)

        control, pid_state, aux = cascade_pid_step(
            gains, pid_state, state, pos_ref, yaw_ref, cfg.control_dt
        )
        new_state = _plant_substeps(state, control, body, rate_loop, cfg)

        out = {
            "state": state,
            "pos_ref": pos_ref,
            "vel_ref": aux["velocity_setpoint"],
            "att_ref": aux["attitude_setpoint"],
            "thrust": control[0],
            "rates_cmd": control[1:4],
        }
        return (new_state, pid_state), out

    (final_state, _), outs = jax.lax.scan(
        step, (initial_state, cascade_init(dtype)), jnp.arange(num_steps)
    )
    outs["final_state"] = final_state
    return outs


@struct.dataclass
class OnlineFusedGPConfig:
    """In-flight GP learning for ``mpc_flight_rollout(online_gp=...)`` and
    ``estimation.noisy_mpc_flight_rollout(online_gp=...)``.

    The reference's defining loop retrains its GP DURING flight — a 5 s
    timer (``gaussian_process.py:122``) over data captured every tick
    (``src/px4/mpc.py:2016-2021``). Every tick's transition is pushed into
    the ring-buffer dataset (reference quality filters included), and every
    ``refit_every`` ticks the masked Cholesky refit runs under a
    ``lax.cond`` (``gp.residual_gp.online_gp_update``, shared with
    ``loop.full_system``).
    """

    gp: ResidualGPConfig = struct.field(default_factory=ResidualGPConfig)
    refit_every: int = 250     # ticks; 5 s at 50 Hz (gaussian_process.py:122)
    min_samples: int = 30      # simple_gp.py:158
    # opt-in: refit with per-dim ARD length scales equivalent to
    # standardized inputs (the reference's OFFLINE StandardScaler practice,
    # gp_trainer.py:121-135, brought to the online path — the default False
    # keeps the reference's unscaled online RBF(0.5), simple_gp.py:160);
    # see gp.residual_gp.standardized_params
    standardize_inputs: bool = False


@struct.dataclass
class FlightResumeState:
    """Mid-flight checkpoint of ``mpc_flight_rollout``.

    The reference has NO mid-run resume anywhere (SURVEY section 5:
    checkpoints are GP models only); here the COMPLETE scan carry — plant
    state, MPC warm start, attitude integral, online GP ring buffer and
    posterior — is one pytree, so a flight can stop at any tick and
    continue BIT-EXACTLY (pinned by
    ``tests/test_online_fused.py::test_mid_flight_checkpoint_resume``).
    Persist with ``io.save_resume_state`` / ``io.load_resume_state``.
    """

    carry: tuple
    tick: int = struct.field(pytree_node=False)
    # config fingerprint (horizon, gp capacity, variance flag, scaled):
    # carry shapes can coincide across configs, so structure checks alone
    # cannot catch a horizon mismatch — this can
    meta: tuple = struct.field(pytree_node=False, default=())


class OnlineLearner:
    """The in-flight learning state of one flight: ring buffer, posterior
    and the previous tick's (state, applied command), advanced once per
    tick by ``update`` (``gp.residual_gp.online_gp_update``)."""

    def __init__(self, online_gp: OnlineFusedGPConfig, gp_gain: float,
                 tighten: bool):
        self.cfg = online_gp
        self.conv = online_gp.gp.replace(residual_gain=gp_gain)
        self.tighten = tighten

    def init(self, initial_state, initial_dataset, dtype):
        gcfg = self.cfg.gp
        ds = (initial_dataset if initial_dataset is not None
              else empty_dataset(gcfg.max_data_points, dtype))
        post = fit_online_gp(ds, gcfg, self.cfg.standardize_inputs)
        return (ds, post, initial_state, jnp.zeros(4, dtype))

    def update(self, learner, state, tick, X_guess, U_guess):
        """Capture + refit, then the gated ``(residuals, uncertainty)``."""
        ds, post, prev_state, prev_control = learner
        ds, post, trained = online_gp_update(
            ds, post, prev_state, prev_control, state, tick, self.cfg.gp,
            self.cfg.refit_every, self.cfg.min_samples,
            self.cfg.standardize_inputs,
        )
        gate = trained.astype(X_guess.dtype)
        residuals = gate * build_horizon_residuals(post, X_guess, U_guess, self.conv)
        uncertainty = (
            gate * build_horizon_uncertainty(post, X_guess, U_guess, self.conv)
            if self.tighten else None
        )
        return (ds, post), residuals, uncertainty


def mpc_flight_rollout(
    mpc: LinearMPC,
    reference_fn: Callable,
    num_steps: int,
    body: RigidBodyParams = RigidBodyParams(),
    rate_loop: RateLoopParams = RateLoopParams(),
    cfg: FlightLoopConfig = FlightLoopConfig(),
    initial_state: jnp.ndarray | None = None,
    residual_fn: Callable | None = None,
    output_correction_fn: Callable | None = None,
    preview: bool = False,
    gp_posterior=None,
    gp_gain: float = 0.1,
    gp_dt: float = 0.02,
    online_gp: "OnlineFusedGPConfig | None" = None,
    initial_dataset=None,
    uncertainty_fn: Callable | None = None,
    resume: "FlightResumeState | None" = None,
    return_resume: bool = False,
    dtype=jnp.float32,
):
    """Closed-loop linear-MPC flight (optionally GP-enhanced).

    ``reference_fn(t) -> (pos3, yaw)``; ``residual_fn(X_guess, U_guess)``
    optionally produces the ``(N, 6)`` stage residual array from the MPC's
    warm-start trajectory (the GP hook; see ``gp.residual_gp``).

    ``gp_posterior`` flies a frozen posterior: the residual hook becomes
    ``build_horizon_residuals`` with ``gp_gain`` / ``gp_dt`` as the
    conversion, and with ``mpc.config.tightening_factor > 0`` the posterior
    std drives the zero-order back-off (``build_horizon_uncertainty``).

    ``online_gp`` makes the GP LEARN IN FLIGHT: the ring buffer (seeded
    with ``initial_dataset`` if given) and the posterior ride the scan
    carry, refits follow ``online_gp.refit_every`` and the residual gain is
    ``gp_gain``. Outputs gain ``gp_count``.

    ``output_correction_fn(state6, u_opt, pos_ref) -> u_opt`` is the OTHER
    GP generation — the reference's earlier architecture where the GP
    corrects the solved control post-solve instead of entering the dynamics
    (``gp.residual_gp.make_output_correction_fn``; mpc_gp.py:341-372).

    ``preview=True`` feeds the MPC per-stage references sampled along the
    horizon (position + finite-difference velocity) instead of the
    reference node's single point target — same QP, removes the point
    -target tracking lag.

    ``return_resume=True`` also returns a ``FlightResumeState``; passing
    it back as ``resume=`` continues the flight bit-exactly.
    Returns a dict of stacked per-tick signals.
    """
    if initial_state is None:
        initial_state = jnp.zeros(12, dtype).at[2].set(cfg.takeoff_height)
    if initial_dataset is not None and online_gp is None:
        raise ValueError("initial_dataset= only makes sense with online_gp=")
    if online_gp is not None and (
        gp_posterior is not None or residual_fn is not None
    ):
        raise ValueError(
            "online_gp= builds its posterior in-flight from the ring buffer "
            "— don't also pass gp_posterior/residual_fn"
        )
    if gp_posterior is not None and residual_fn is not None:
        raise ValueError("pass gp_posterior OR residual_fn, not both")
    tighten = mpc.config.tightening_factor > 0.0
    if gp_posterior is not None:
        conv = ResidualGPConfig(dt=gp_dt, residual_gain=gp_gain)
        residual_fn = functools.partial(
            build_horizon_residuals, gp_posterior, config=conv
        )
        if tighten and uncertainty_fn is None:
            uncertainty_fn = functools.partial(
                build_horizon_uncertainty, gp_posterior, config=conv
            )
    learner = (
        OnlineLearner(online_gp, gp_gain, tighten) if online_gp is not None
        else None
    )

    def step(carry, i):
        state, mpc_carry, att_carry, gp_state = carry
        t = i.astype(dtype) * cfg.control_dt
        pos_ref, yaw_ref = reference_fn(t)
        # guard against x64 promotion leaking in from user reference fns
        pos_ref = jnp.asarray(pos_ref, dtype)
        yaw_ref = jnp.asarray(yaw_ref, dtype)
        Xg, Ug = mpc_carry.X_prev, mpc_carry.U_prev

        residuals = residual_fn(Xg, Ug) if residual_fn is not None else None
        uncertainty = uncertainty_fn(Xg, Ug) if uncertainty_fn is not None else None
        if learner is not None:
            (ds, post), residuals, uncertainty = learner.update(
                gp_state, state, i, Xg, Ug
            )
        ref_states = (
            preview_reference_states(
                reference_fn, t, mpc.config.horizon, cfg.control_dt, dtype
            )
            if preview else None
        )
        new_state, mpc_carry, att_carry, out = mpc_tick(
            mpc, cfg, body, rate_loop, state, mpc_carry, att_carry,
            pos_ref, yaw_ref, residuals, ref_states, uncertainty,
            output_correction_fn,
        )
        control = out.pop("control")
        if learner is not None:
            gp_state = (ds, post, state, control)
            out["gp_count"] = ds.count
        return (new_state, mpc_carry, att_carry, gp_state), out

    meta = (
        int(mpc.config.horizon),
        int(online_gp.gp.max_data_points) if learner is not None else 0,
        bool(tighten),
        bool(online_gp.standardize_inputs) if learner is not None else False,
    )
    if resume is not None:
        if resume.meta and resume.meta != meta:
            raise ValueError(
                f"resume checkpoint config mismatch: saved {resume.meta}, "
                f"current (horizon, gp_capacity, variance, scaled) = {meta}"
            )
        init, start = resume.carry, resume.tick
    else:
        init = (
            initial_state,
            mpc.init_carry(initial_state[0:6]),
            attitude_loop_init(dtype),
            learner.init(initial_state, initial_dataset, dtype)
            if learner is not None else None,
        )
        start = 0
    final_carry, outs = jax.lax.scan(
        step, init, jnp.arange(start, start + num_steps)
    )
    outs["final_state"] = final_carry[0]
    if return_resume:
        return outs, FlightResumeState(
            carry=final_carry, tick=start + num_steps, meta=meta
        )
    return outs


def batched_mpc_flight_sweep(
    mpc: LinearMPC,
    reference_fn: Callable,
    num_steps: int,
    initial_states: jnp.ndarray,             # (B, 12)
    body: RigidBodyParams = RigidBodyParams(),
    rate_loop: RateLoopParams = RateLoopParams(),
    cfg: FlightLoopConfig = FlightLoopConfig(),
    residual_fn: Callable | None = None,
    gp_every: int = 1,
    gp_posterior=None,
    gp_cfg=None,
):
    """Throughput mode: B GP-MPC flights advance in lockstep.

    Each tick is ``mpc_tick`` under ``vmap``: the B condensed QPs become
    batched matrix products, allocation + plant one elementwise chain over
    the batch.

    ``gp_posterior`` evaluates the GP stage for all ``B*N`` horizon stages
    in ONE posterior-mean call (``gp.build_horizon_residuals_batched``:
    the Triton kernel on CUDA, XLA elsewhere) with ``gp_cfg``'s conversion;
    ``residual_fn`` instead vmaps a per-flight hook. The two are exclusive.

    ``gp_every``: evaluate the GP every k-th tick and HOLD the stage
    disturbances in between — the multi-rate pattern of the reference's own
    full system (MPC at 10 Hz against a 100 Hz plant,
    ``quadrotor_gp_mpc/main.py:814-826``; our ``loop.full_system``
    mpc_every); the warm-start trajectory the GP is queried on moves slowly
    between ticks.

    Returns ``{"state": (T, B, 12), "pos_ref": (T, 3), "thrust": (T, B)}``.
    """
    if gp_posterior is not None and residual_fn is not None:
        raise ValueError("pass gp_posterior OR residual_fn, not both")
    dtype = jnp.float32
    B = initial_states.shape[0]
    N = mpc.config.horizon
    starts = initial_states.astype(dtype)
    conv = gp_cfg if gp_cfg is not None else ResidualGPConfig()
    use_gp = residual_fn is not None or gp_posterior is not None

    def fresh(args):
        Xp, Up = args
        if gp_posterior is not None:
            res = build_horizon_residuals_batched(gp_posterior, Xp, Up, conv)
        else:
            res = jax.vmap(residual_fn)(Xp, Up)
        return res.astype(dtype)

    def tick(state, mc, att, residuals, pos_ref, yaw_ref):
        new_state, mc, att, out = mpc_tick(
            mpc, cfg, body, rate_loop, state, mc, att, pos_ref, yaw_ref,
            residuals,
        )
        return new_state, mc, att, out["thrust"]

    def step(carry, i):
        states, mcs, atts, held = carry
        t = i.astype(dtype) * cfg.control_dt
        pos_ref, yaw_ref = reference_fn(t)
        pos_ref = jnp.asarray(pos_ref, dtype)
        yaw_ref = jnp.asarray(yaw_ref, dtype)
        if use_gp:
            args = (mcs.X_prev, mcs.U_prev)
            if gp_every > 1:
                # lax.cond executes ONE branch: held ticks skip the posterior
                held = jax.lax.cond(
                    i % gp_every == 0, fresh, lambda a: held, args
                )
            else:
                held = fresh(args)
        states_next, mcs, atts, thrust = jax.vmap(
            tick, in_axes=(0, 0, 0, 0 if use_gp else None, None, None)
        )(states, mcs, atts, held, pos_ref, yaw_ref)
        out = {"state": states, "pos_ref": pos_ref, "thrust": thrust}
        return (states_next, mcs, atts, held), out

    init = (
        starts,
        jax.vmap(mpc.init_carry)(starts[:, 0:6]),
        jax.vmap(lambda _: attitude_loop_init(dtype))(starts),
        jnp.zeros((B, N, 6), dtype) if use_gp else None,
    )
    _, outs = jax.lax.scan(step, init, jnp.arange(num_steps))
    return outs
