"""Fully-coupled online GP-MPC system: fly, collect, retrain — in one program.

Rebuild of the reference's multi-rate "full system"
(``/root/reference/quadrotor_gp_mpc/quadrotor_gp_mpc/main.py:765-1052``):
three ROS 2 timers on a ``MultiThreadedExecutor`` — plant at 100 Hz, MPC at
10 Hz, GP retraining at 0.2 Hz — plus a data-collector thread computing
residuals (``main.py:212-246``). Also covers the flight node's online data
capture (``src/px4/mpc.py:2016-2021``) and periodic retraining policy
(``gaussian_process.py:122,360-367``).

Here the timers become **one** ``lax.scan`` with modular-arithmetic
rate dividers; the retraining thread becomes a ``lax.cond``-gated masked GP
refit (static shapes, one Cholesky) every ``gp_refit_every`` ticks; the GP
posterior rides the scan carry. No executors, no threads, no topic hops —
and the whole mission (fly + learn) is one compiled program that can be
vmapped over fleets.

Failure handling (SURVEY.md section 5): a non-finite MPC command falls back
to the hover command in-graph (the reference's Ipopt-failure -> hover path,
``src/px4/mpc.py:1627-1630``).
"""

from __future__ import annotations

from typing import Callable

from .. import struct
import jax
import jax.numpy as jnp

from ..control.allocation import attitude_loop_init, geometric_control_allocation
from ..control.mpc_linear import LinearMPC
from ..gp.residual_gp import (
    ResidualDataset,
    ResidualGPConfig,
    build_horizon_residuals,
    empty_dataset,
    fit_online_gp,
    online_gp_update,
)
from ..models.params import RigidBodyParams
from ..models.px4_surrogate import RateLoopParams
from .closed_loop import FlightLoopConfig, _plant_substeps, preview_reference_states


@struct.dataclass
class OnlineGPMPCConfig:
    flight: FlightLoopConfig = FlightLoopConfig()
    gp: ResidualGPConfig = ResidualGPConfig()
    gp_refit_every: int = 250      # ticks; 5 s at 50 Hz (gaussian_process.py:122)
    gp_min_samples: int = 30       # simple_gp.py:158
    mpc_every: int = 1             # solve every k-th tick (10 Hz MPC = 5)
    preview: bool = False          # per-stage horizon references
    # opt-in standardize-equivalent ARD refits (as OnlineFusedGPConfig;
    # gp.residual_gp.standardized_params)
    standardize_inputs: bool = False


def online_gp_mpc_rollout(
    mpc: LinearMPC,
    reference_fn: Callable,
    num_steps: int,
    cfg: OnlineGPMPCConfig = OnlineGPMPCConfig(),
    body: RigidBodyParams = RigidBodyParams(),
    rate_loop: RateLoopParams = RateLoopParams(),
    initial_state: jnp.ndarray | None = None,
    initial_dataset: ResidualDataset | None = None,
    dtype=jnp.float32,
):
    """Closed loop with in-flight data collection and periodic GP refits.

    Returns the stacked per-tick outputs plus the final dataset (ready for
    checkpointing — the reference saves its dataset on shutdown,
    ``src/px4/mpc.py:1874-1883``).
    """
    fcfg = cfg.flight
    if initial_state is None:
        initial_state = jnp.zeros(12, dtype).at[2].set(fcfg.takeoff_height)
    if initial_dataset is None:
        initial_dataset = empty_dataset(cfg.gp.max_data_points, dtype)

    accel_lo = jnp.asarray(fcfg.accel_lower, dtype)
    accel_hi = jnp.asarray(fcfg.accel_upper, dtype)
    hover_u = jnp.zeros(4, dtype)  # zero-acceleration command = hover

    posterior0 = fit_online_gp(initial_dataset, cfg.gp, cfg.standardize_inputs)

    def step(carry, i):
        (state, mpc_carry, att_carry, dataset, posterior,
         prev_state, prev_control, last_u) = carry
        t = i.astype(dtype) * fcfg.control_dt
        pos_ref, yaw_ref = reference_fn(t)
        # guard against x64 promotion leaking in from user reference fns
        pos_ref = jnp.asarray(pos_ref, dtype)
        yaw_ref = jnp.asarray(yaw_ref, dtype)

        # --- online data capture + periodic cond-gated refit ------------
        dataset, posterior, trained = online_gp_update(
            dataset, posterior, prev_state, prev_control, state, i, cfg.gp,
            cfg.gp_refit_every, cfg.gp_min_samples, cfg.standardize_inputs,
        )

        # --- MPC tick (rate-divided), GP residuals gated on is_trained --
        residuals = jnp.where(
            trained,
            build_horizon_residuals(posterior, mpc_carry.X_prev,
                                    mpc_carry.U_prev, cfg.gp),
            jnp.zeros((mpc.config.horizon, 6), dtype),
        )

        ref_states = (
            preview_reference_states(
                reference_fn, t, mpc.config.horizon, fcfg.control_dt, dtype
            )
            if cfg.preview else None
        )

        def do_solve(args):
            mc, st = args
            u, _, mc = mpc.solve(
                mc, st[0:6], pos_ref, residuals, reference_states=ref_states
            )
            return u, mc

        def hold(args):
            mc, _ = args
            return last_u, mc

        u_opt, mpc_carry = jax.lax.cond(
            i % cfg.mpc_every == 0, do_solve, hold, (mpc_carry, state)
        )
        # solver-failure fallback: hover on non-finite commands
        u_opt = jnp.where(jnp.all(jnp.isfinite(u_opt)), u_opt, hover_u)

        accel_des = jnp.clip(u_opt[0:3], accel_lo, accel_hi)
        yawrate_des = jnp.clip(u_opt[3], -fcfg.yawrate_limit, fcfg.yawrate_limit)

        thrust, rate_cmd, att_sp, att_carry = geometric_control_allocation(
            att_carry, accel_des, yaw_ref, yawrate_des,
            state[6:9], state[9:12], dt_attitude=fcfg.control_dt,
        )
        control = jnp.concatenate([thrust[None], rate_cmd])
        new_state = _plant_substeps(state, control, body, rate_loop, fcfg)

        mpc_control = jnp.concatenate([accel_des, yawrate_des[None]])
        out = {
            "state": state,
            "pos_ref": pos_ref,
            "thrust": thrust,
            "gp_count": dataset.count,
            "gp_active": trained,
        }
        new_carry = (new_state, mpc_carry, att_carry, dataset, posterior,
                     state, mpc_control, u_opt)
        return new_carry, out

    init = (
        initial_state,
        mpc.init_carry(initial_state[0:6]),
        attitude_loop_init(dtype),
        initial_dataset,
        posterior0,
        initial_state,
        jnp.zeros(4, dtype),
        jnp.zeros(4, dtype),
    )
    (final_state, _, _, dataset, posterior, *_), outs = jax.lax.scan(
        step, init, jnp.arange(num_steps)
    )
    outs["final_state"] = final_state
    return outs, dataset, posterior
