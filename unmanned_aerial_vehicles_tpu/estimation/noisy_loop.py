"""Closed loop with the estimator in it: sensors -> EKF -> MPC -> plant.

The reference's control stack always sees either PX4-EKF2 output (real
campaign) or the TRUE simulator state (standalone package) — the estimator
is never part of its own loop. Here the whole chain is one ``lax.scan``:
per tick, a noisy sensor sample of the true plant state feeds the EKF,
the controller flies the ESTIMATE, and the plant integrates the truth.
This is the configuration a deployment actually runs, and it makes
estimator-induced tracking degradation measurable in-graph.
"""

from __future__ import annotations

import functools
from typing import Callable

import jax
import jax.numpy as jnp

from ..control.allocation import attitude_loop_init
from ..control.mpc_linear import LinearMPC
from ..gp.residual_gp import ResidualGPConfig, build_horizon_residuals
from ..loop.closed_loop import (
    FlightLoopConfig,
    OnlineLearner,
    mpc_tick,
    preview_reference_states,
)
from ..models.params import RigidBodyParams
from ..models.px4_surrogate import RateLoopParams
from .ekf import EKFConfig, ekf_init, ekf_step, measure


def noisy_mpc_flight_rollout(
    mpc: LinearMPC,
    reference_fn: Callable,
    num_steps: int,
    key: jax.Array,
    ekf_cfg: EKFConfig = EKFConfig(),
    body: RigidBodyParams = RigidBodyParams(),
    rate_loop: RateLoopParams = RateLoopParams(),
    cfg: FlightLoopConfig = FlightLoopConfig(),
    initial_state: jnp.ndarray | None = None,
    residual_fn: Callable | None = None,
    preview: bool = False,
    gp_posterior=None,
    gp_gain: float = 0.1,
    gp_dt: float = 0.02,
    online_gp=None,
    initial_dataset=None,
    disturbance_observer=None,
    nominal_body: RigidBodyParams | None = None,
    wind_fn: Callable | None = None,
    dtype=jnp.float32,
):
    """MPC flight on ESTIMATED state from noisy sensors.

    The same tick as ``loop.mpc_flight_rollout`` (``closed_loop.mpc_tick``)
    with the controller consuming the EKF estimate while the plant
    integrates the truth. Adds ``state_est`` (the per-tick estimate) and
    ``meas_pos`` (the raw position sample) to the output dict.

    ``gp_posterior`` flies a frozen posterior with ``gp_gain`` / ``gp_dt``
    as the conversion (exclusive with ``residual_fn``).

    ``online_gp`` (an ``OnlineFusedGPConfig``) composes IN-FLIGHT LEARNING
    with the estimator: the ring-buffer capture consumes EKF estimates —
    the reference's actual data path, where the flight node's captured
    "state" is PX4-EKF2 output (``src/px4/mpc.py:1889-1907,2016-2021``).
    Adds ``gp_count``.

    ``disturbance_observer`` (a ``DisturbanceEKFConfig``, or ``True`` for
    defaults) swaps the 12-state filter for the 15-state augmented observer
    (``estimation.disturbance``): the EKF additionally estimates a
    slowly-varying acceleration disturbance and the MPC receives it as
    stage-wise residual feedforward — wind rejection WITHOUT learning
    (summed with the GP rows when both are given, so the GP corrects what
    the observer's constant-accel model cannot). Adds ``disturbance_est``.

    ``nominal_body`` is the observer's process model (default: ``body``
    with the wind zeroed — the controller-side model that does NOT know
    the disturbance; passing the true plant parameters would drive
    ``d_est`` to zero and the feedforward with it). The TRUE plant always
    integrates ``body``.

    ``wind_fn(t) -> (3,)`` makes the TRUE plant's wind time-varying —
    gusts, fronts, shear (``body.replace`` per tick). This is the scenario
    that separates the observer from any frozen model: a GP trained on the
    old wind (or the reference's 5 s-stale retrain,
    ``gaussian_process.py:122``) keeps feeding the old correction, while
    the observer re-converges within a few filter time constants. The
    12-state filter (non-observer runs) keeps its generous
    truth-process-model semantics: it sees ``wind_fn(t)`` too.
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
    if gp_posterior is not None:
        if residual_fn is not None:
            raise ValueError("pass gp_posterior OR residual_fn, not both")
        residual_fn = functools.partial(
            build_horizon_residuals, gp_posterior,
            config=ResidualGPConfig(dt=gp_dt, residual_gain=gp_gain),
        )
    learner = (
        OnlineLearner(online_gp, gp_gain, tighten=False)
        if online_gp is not None else None
    )
    if disturbance_observer is not None and disturbance_observer is not False:
        from .disturbance import DisturbanceEKFConfig

        dob_cfg = (
            DisturbanceEKFConfig(base=ekf_cfg)
            if disturbance_observer is True else disturbance_observer
        )
        if nominal_body is None:
            nominal_body = body.replace(wind=(0.0, 0.0, 0.0))
    else:
        dob_cfg = None

    keys = jax.random.split(key, num_steps)
    # sensor noise model: the observer's base config when one was passed
    # explicitly (keeps draw + filter models consistent), ekf_cfg otherwise
    meas_cfg = dob_cfg.base if dob_cfg is not None else ekf_cfg
    if dob_cfg is not None:
        from .disturbance import (
            dekf_init,
            dekf_step,
            disturbance_residual_rows,
        )

    def step(carry, inputs):
        state, ekf, mpc_carry, att_carry, prev_control, gp_state = carry
        i, k = inputs
        t = i.astype(dtype) * cfg.control_dt
        pos_ref, yaw_ref = reference_fn(t)
        pos_ref = jnp.asarray(pos_ref, dtype)
        yaw_ref = jnp.asarray(yaw_ref, dtype)

        body_t = (
            body if wind_fn is None
            else body.replace(wind=jnp.asarray(wind_fn(t), dtype))
        )

        # sensor sample of the TRUE state; EKF predicts with the control
        # that was actually applied over the last interval
        z = measure(state, k, meas_cfg)
        if dob_cfg is not None:
            # observer predicts with the NOMINAL model — the innovation the
            # nominal plant cannot explain is attributed to d
            ekf, x_est, d_est = dekf_step(
                ekf, prev_control, z, nominal_body, rate_loop,
                cfg.control_dt, dob_cfg,
            )
        else:
            ekf, x_est = ekf_step(
                ekf, prev_control, z, body_t, rate_loop, cfg.control_dt,
                ekf_cfg,
            )

        Xg, Ug = mpc_carry.X_prev, mpc_carry.U_prev
        residuals = residual_fn(Xg, Ug) if residual_fn is not None else None
        if learner is not None:
            # the ring buffer learns from ESTIMATES (est_{k-1}, u_{k-1}) ->
            # est_k: the reference's capture consumes EKF2 output, not truth
            (ds, post), residuals, _ = learner.update(gp_state, x_est, i, Xg, Ug)
        if dob_cfg is not None:
            dob_rows = disturbance_residual_rows(
                d_est, mpc.config.horizon, dtype
            )
            residuals = (
                dob_rows if residuals is None else residuals + dob_rows
            )
        ref_states = (
            preview_reference_states(
                reference_fn, t, mpc.config.horizon, cfg.control_dt, dtype
            )
            if preview else None
        )
        new_state, mpc_carry, att_carry, out = mpc_tick(
            mpc, cfg, body_t, rate_loop, state, mpc_carry, att_carry,
            pos_ref, yaw_ref, residuals, ref_states, est=x_est,
        )
        command = out.pop("control")
        if learner is not None:
            gp_state = (ds, post, x_est, command)
            out["gp_count"] = ds.count
        out["state_est"] = x_est
        out["meas_pos"] = z[0:3]
        if dob_cfg is not None:
            out["disturbance_est"] = d_est
        control = jnp.concatenate([out["thrust"][None], out["rates_cmd"]])
        return (new_state, ekf, mpc_carry, att_carry, control, gp_state), out

    init = (
        initial_state,
        dekf_init(initial_state, dob_cfg, dtype) if dob_cfg is not None
        else ekf_init(initial_state, ekf_cfg, dtype),
        mpc.init_carry(initial_state[0:6]),
        attitude_loop_init(dtype),
        jnp.asarray([1.0, 0.0, 0.0, 0.0], dtype),  # hover command
        learner.init(initial_state, initial_dataset, dtype)
        if learner is not None else None,
    )
    (final_state, ekf, *_), outs = jax.lax.scan(
        step, init, (jnp.arange(num_steps), keys)
    )
    outs["final_state"] = final_state
    outs["final_covariance"] = ekf.P
    return outs


def noisy_rigid_mpc_rollout(
    controller,
    reference_fn: Callable,
    num_steps: int,
    key: jax.Array,
    ekf_cfg: EKFConfig = EKFConfig(),
    body=None,
    dt: float = 0.02,
    initial_state: jnp.ndarray | None = None,
    takeoff_height: float = 3.0,
    plant_step_fn: Callable | None = None,
    plant_step_tfn: Callable | None = None,
    process_step_fn: Callable | None = None,
    yaw_channel: bool = True,
    disturbance_observer=None,
    dtype=jnp.float32,
):
    """Noisy-sensor loop for the 12-STATE controller family: sensors ->
    EKF -> controller -> torque-input rigid body.

    The 6-state loops above estimate over the PX4 surrogate; here the
    process model is the true rigid body (``models.rigid_body``, the plant
    the SQP/iLQR/MPPI engines fly — reference
    ``src/px4/mpc_FULL.py:86-549``), linearised per tick with ``jacfwd``
    through the RK4 step. ``controller`` is any of the family's engines —
    the shared ``solve(carry, state12, target_pos, target_yaw)`` surface
    (the ``cli fly`` shape). The
    controller flies the ESTIMATE; the plant integrates the truth.

    ``plant_step_fn(x, u) -> x_next`` overrides the TRUTH plant and
    ``process_step_fn`` the EKF's model (default: same as the plant) —
    the direct-rate engine flies its rate-lag model this way
    (``mpc_direct_rates.py:153-190``); ``yaw_channel=False`` for engines
    whose ``solve`` takes no yaw target (direct-rate tracks position only).
    ``plant_step_tfn(x, u, t) -> x_next`` is the TIME-VARYING truth plant
    (the torque family's ``wind_fn`` analogue: a pushing force that steps
    mid-flight); it requires an explicit ``process_step_fn`` (the filter's
    model must not silently track the disturbance being estimated).

    ``reference_fn(t) -> (pos_ref, yaw_ref)``. Returns the staged loop's
    output dict plus ``state_est``/``meas_pos``.

    ``disturbance_observer`` (a ``DisturbanceEKFConfig``, or ``True``)
    brings the 15-state augmented filter (``estimation.disturbance``) to
    the torque family: the filter attributes the innovation
    ``process_step_fn`` cannot explain to an acceleration disturbance and
    the estimate feeds the engine's traced residual input as
    ``(N, 12)`` derivative rows. Requires the residual-channel engine —
    direct-rate, ``solve(carry, x, pos, residuals=)`` — i.e.
    ``yaw_channel=False`` (the SQP/iLQR/MPPI solves have no residual
    hook). Make the scenario real by passing a DISTURBED truth via
    ``plant_step_fn`` while ``process_step_fn`` stays nominal.
    """
    from ..models import X500_PARAMS
    from ..models.rigid_body import rigid_body_rk4_step

    if body is None:
        body = X500_PARAMS
    if initial_state is None:
        initial_state = jnp.zeros(12, dtype).at[2].set(takeoff_height)
    initial_state = initial_state.astype(dtype)

    if plant_step_tfn is not None:
        if plant_step_fn is not None:
            raise ValueError("pass plant_step_fn OR plant_step_tfn, not both")
        if process_step_fn is None:
            raise ValueError(
                "plant_step_tfn= (time-varying truth) requires an explicit "
                "process_step_fn — the filter's model must not silently "
                "track the disturbance being estimated"
            )
    elif plant_step_fn is None:
        # truth and the EKF process model: the same RK4 step
        plant_step_fn = lambda x, u: rigid_body_rk4_step(x, u, body, dt)
        if process_step_fn is None:
            process_step_fn = plant_step_fn
    elif process_step_fn is None:
        process_step_fn = plant_step_fn
    ekf_step_fn = process_step_fn

    if disturbance_observer is not None and disturbance_observer is not False:
        if yaw_channel:
            raise ValueError(
                "disturbance_observer= on the 12-state loop requires the "
                "residual-channel engine (direct-rate: solve(carry, x, "
                "pos, residuals=), yaw_channel=False); the SQP/iLQR/MPPI "
                "solves have no residual input"
            )
        from .disturbance import (
            DisturbanceEKFConfig,
            dekf_init,
            dekf_step,
            disturbance_residual_rows12,
        )

        dob_cfg = (
            DisturbanceEKFConfig(base=ekf_cfg)
            if disturbance_observer is True else disturbance_observer
        )
        horizon12 = int(controller.mpc.config.horizon)
    else:
        dob_cfg = None
    meas_cfg = dob_cfg.base if dob_cfg is not None else ekf_cfg

    keys = jax.random.split(key, num_steps)
    u_hover = controller.u_hover

    def step(carry, inputs):
        state, ekf, mc, prev_u = carry
        i, k = inputs
        t = i.astype(dtype) * dt
        pos_ref, yaw_ref = reference_fn(t)
        pos_ref = jnp.asarray(pos_ref, dtype)
        yaw_ref = jnp.asarray(yaw_ref, dtype)

        z = measure(state, k, meas_cfg)
        if dob_cfg is not None:
            ekf, x_est, d_est = dekf_step(
                ekf, prev_u, z, dt=dt, config=dob_cfg, step_fn=ekf_step_fn
            )
        else:
            ekf, x_est = ekf_step(
                ekf, prev_u, z, dt=dt, config=ekf_cfg, step_fn=ekf_step_fn
            )

        if yaw_channel:
            u, _, mc = controller.solve(mc, x_est, pos_ref, yaw_ref)
        elif dob_cfg is not None:
            rows = disturbance_residual_rows12(d_est, horizon12, dtype)
            u, _, mc = controller.solve(mc, x_est, pos_ref, residuals=rows)
        else:
            u, _, mc = controller.solve(mc, x_est, pos_ref)
        new_state = (plant_step_fn(state, u) if plant_step_tfn is None
                     else plant_step_tfn(state, u, t))

        out = {
            "state": state,
            "state_est": x_est,
            "meas_pos": z[0:3],
            "pos_ref": pos_ref,
            "u": u,
        }
        if dob_cfg is not None:
            out["disturbance_est"] = d_est
        return (new_state, ekf, mc, u), out

    init = (
        initial_state,
        dekf_init(initial_state, dob_cfg, dtype) if dob_cfg is not None
        else ekf_init(initial_state, ekf_cfg, dtype),
        controller.init_carry(initial_state),
        u_hover.astype(dtype),
    )
    (final_state, ekf, _, _), outs = jax.lax.scan(
        step, init, (jnp.arange(num_steps), keys)
    )
    outs["final_state"] = final_state
    outs["final_covariance"] = ekf.P
    return outs


def noisy_ltv_rollout(
    controller,
    reference_window_fn: Callable,
    num_steps: int,
    key: jax.Array,
    ekf_cfg: EKFConfig = EKFConfig(),
    body=None,
    dt_plant: float = 0.01,
    substeps_per_tick: int = 10,
    obstacles: jnp.ndarray | None = None,
    initial_state: jnp.ndarray | None = None,
    disturbance_observer=None,
    nominal_body=None,
    dtype=jnp.float32,
):
    """Multi-rate noisy loop for the LTV tracking MPC: plant + EKF at the
    100 Hz sensor rate, the controller at its own 10 Hz cadence.

    The reference's standalone system runs exactly this rate split — the
    RK4 plant at 100 Hz against the cvxpy MPC's 10 Hz timer
    (``quadrotor_gp_mpc/main.py:814-826``,
    ``mpc_controller.py:116,370-392``) — with state estimation delegated to
    Gazebo truth / PX4's EKF2. Here the estimation role is in-graph: each
    plant tick draws one sensor sample, the rigid-body EKF fuses it, and
    the LTV solve (every ``substeps_per_tick``-th plant tick) flies the
    ESTIMATE while the true plant integrates the commanded wrench under
    zero-order hold.

    ``controller`` is an ``LTVTrackingMPC``; ``reference_window_fn(i) ->
    (N+1, 12)`` stage references for control tick ``i`` (the node's
    shifting reference window, ``mpc_controller.py:64-67``). Returns one
    row per CONTROL tick: truth/estimate/measurement at the tick boundary
    plus the applied control.

    ``disturbance_observer`` (a ``DisturbanceEKFConfig``, or ``True``)
    swaps in the 15-state augmented filter — fused at the 100 Hz sensor
    rate over the NOMINAL process model (``nominal_body``, default
    ``body`` with the wind zeroed) — and feeds the estimated acceleration
    disturbance to the 10 Hz LTV solve as its traced ``(N, 12)``
    derivative-space residual rows (the cvxpy engine's GP hook,
    ``mpc_controller.py:144``). Obstacle rows compose.
    """
    from ..models import GZ_QUADROTOR_PARAMS
    from ..models.rigid_body import rigid_body_rk4_step

    if body is None:
        body = GZ_QUADROTOR_PARAMS
    if initial_state is None:
        initial_state = reference_window_fn(0)[0].astype(dtype)
    initial_state = initial_state.astype(dtype)

    if disturbance_observer is not None and disturbance_observer is not False:
        from .disturbance import (
            DisturbanceEKFConfig,
            dekf_init,
            dekf_step,
            disturbance_residual_rows12,
        )

        dob_cfg = (
            DisturbanceEKFConfig(base=ekf_cfg)
            if disturbance_observer is True else disturbance_observer
        )
        if nominal_body is None:
            nominal_body = body.replace(wind=(0.0, 0.0, 0.0))
        horizon12 = int(controller.mpc.config.horizon)
    else:
        dob_cfg = None
    meas_cfg = dob_cfg.base if dob_cfg is not None else ekf_cfg

    plant_step_fn = lambda x, u: rigid_body_rk4_step(x, u, body, dt_plant)
    process_body = nominal_body if dob_cfg is not None else body
    process_step_fn = lambda x, u: rigid_body_rk4_step(x, u, process_body,
                                                       dt_plant)

    keys = jax.random.split(key, num_steps * substeps_per_tick).reshape(
        num_steps, substeps_per_tick, 2
    )

    def tick(carry, inputs):
        state, ekf, mc = carry
        i, tick_keys = inputs
        window = reference_window_fn(i).astype(dtype)

        # the 10 Hz solve flies the current ESTIMATE; obstacles ride the
        # same linearised half-space rows as the noiseless path
        if dob_cfg is not None:
            rows = disturbance_residual_rows12(
                ekf.x[12:], horizon12, dtype
            )
            u, _, mc = controller.solve(
                mc, ekf.x[:12], window, residuals=rows, obstacles=obstacles
            )
        else:
            u, _, mc = controller.solve(mc, ekf.x, window,
                                        obstacles=obstacles)

        out = {
            "state": state,
            "state_est": ekf.x[:12],
            "pos_ref": window[0, 0:3],
            "u": u,
        }
        if dob_cfg is not None:
            out["disturbance_est"] = ekf.x[12:]

        def sub(c, k):
            st, ek = c
            st2 = plant_step_fn(st, u)           # truth under ZOH control
            z = measure(st2, k, meas_cfg)
            if dob_cfg is not None:
                ek, _, _ = dekf_step(
                    ek, u, z, dt=dt_plant, config=dob_cfg,
                    step_fn=process_step_fn,
                )
            else:
                ek, _ = ekf_step(
                    ek, u, z, dt=dt_plant, config=ekf_cfg,
                    step_fn=process_step_fn,
                )
            return (st2, ek), z[0:3]

        (state, ekf), zs = jax.lax.scan(sub, (state, ekf), tick_keys)
        out["meas_pos"] = zs[-1]
        return (state, ekf, mc), out

    init = (
        initial_state,
        dekf_init(initial_state, dob_cfg, dtype) if dob_cfg is not None
        else ekf_init(initial_state, ekf_cfg, dtype),
        controller.init_carry(initial_state),
    )
    (final_state, ekf, _), outs = jax.lax.scan(
        tick, init, (jnp.arange(num_steps), keys)
    )
    outs["final_state"] = final_state
    outs["final_covariance"] = ekf.P
    return outs
