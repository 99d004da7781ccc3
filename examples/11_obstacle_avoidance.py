"""Obstacle-constrained flight on the 12-state LTV engine, three ways.

The reference poses spherical keep-out constraints in its cvxpy LTV-MPC
(``quadrotor_gp_mpc/mpc_controller.py:223-316``); here the same constraint
class runs (1) per-tick — the reference cadence, (2) as the multitick loop
(relinearise once per K=2 ticks, plan re-anchored through the true plant,
attitude-recovery fallback), and (3) straight through, unconstrained, to
show the penetration the rows prevent.

Run: python examples/11_obstacle_avoidance.py
(UAV_FAST_EXAMPLES=1 shrinks the flights for the CI smoke run.)
"""

import jax
import jax.numpy as jnp
import numpy as np

from unmanned_aerial_vehicles_tpu.control import LTVTrackingMPC
from unmanned_aerial_vehicles_tpu.loop.rigid_loop import (
    make_attitude_recovery_fallback,
    sqp_multitick_rollout,
)
from unmanned_aerial_vehicles_tpu.models import (
    GZ_QUADROTOR_PARAMS,
    rigid_body_rk4_step,
    rigid_body_rk4_substeps,
)
from unmanned_aerial_vehicles_tpu.utils import scaled

DT = 0.1                                     # the 10 Hz LTV cadence
T = scaled(400, 80)                          # laps of the circle
OBSTACLE = jnp.asarray([[0.0, 1.5, 1.0, 0.3]], jnp.float32)  # ON the path


def ref12(t):
    w = 2.0 * jnp.pi / 20.0
    r = jnp.zeros(12, jnp.float32)
    r = r.at[0].set(1.5 * jnp.cos(w * t)).at[1].set(1.5 * jnp.sin(w * t))
    r = r.at[2].set(1.0)
    return r.at[3].set(-1.5 * w * jnp.sin(w * t)).at[4].set(
        1.5 * w * jnp.cos(w * t))


def plant(x, u):
    return rigid_body_rk4_substeps(x, u, GZ_QUADROTOR_PARAMS, DT, substeps=2)


def report(name, st):
    ts = np.arange(st.shape[0]) * DT
    refs = np.stack([np.asarray(ref12(t)) for t in ts])
    rms = float(np.sqrt(np.mean(
        np.sum((st[:, 0:3] - refs[:, 0:3]) ** 2, -1))))
    d = np.linalg.norm(st[:, 0:3] - np.asarray(OBSTACLE[0, 0:3]), axis=1)
    print(f"{name:28s} rms {rms:.3f} m   min dist to obstacle "
          f"{d.min():.3f} m (r = 0.30)")
    return d.min()


# --- 1. per-tick LTV (reference cadence) with the obstacle rows -----------
mpc_con = LTVTrackingMPC(num_obstacles=1, obstacle_margin=0.2)
N = mpc_con.mpc.config.horizon


@jax.jit
def fly_pertick(x0):
    def step(c, i):
        st, mc = c
        ts = (i + jnp.arange(N + 1)).astype(jnp.float32) * DT
        window = jax.vmap(ref12)(ts)
        u, _, mc = mpc_con.solve(mc, st, window, obstacles=OBSTACLE)
        return (plant(st, u), mc), st
    (_, _), sts = jax.lax.scan(
        step, (x0, mpc_con.init_carry(x0)), jnp.arange(T))
    return sts


d_pt = report("per-tick LTV + rows", np.asarray(fly_pertick(ref12(0.0))))

# --- 2. multitick loop (relinearise once per 2 ticks) ---------------------


def reference_fn(ticks):
    def one(i):
        ts = (i + 1 + jnp.arange(N)).astype(jnp.float32) * DT
        return jax.vmap(ref12)(ts)
    return jax.vmap(one)(ticks)


def plan_roll(x_fin, U_fin, residuals):
    """Re-anchor the plan through the true plant (one RK4 step per stage)."""
    def body(x, u):
        xn = rigid_body_rk4_step(x, u, GZ_QUADROTOR_PARAMS, DT)
        return xn, xn
    return jax.lax.scan(body, x_fin, U_fin)[1]


@jax.jit
def fly_multitick(x0):
    outs = sqp_multitick_rollout(
        mpc_con.mpc, mpc_con.cost, reference_fn, plant, x0, T,
        ticks_per_dispatch=2, admm_iterations=100,
        u_init=mpc_con.u_hover, obstacles=OBSTACLE,
        plan_roll_fn=plan_roll,
        fallback_fn=make_attitude_recovery_fallback(GZ_QUADROTOR_PARAMS),
    )
    return outs["state"]


d_mt = report("multitick K=2 + rows", np.asarray(fly_multitick(ref12(0.0))))

# --- 3. unconstrained: flies straight through the sphere ------------------
mpc_free = LTVTrackingMPC()


@jax.jit
def fly_free(x0):
    def step(c, i):
        st, mc = c
        ts = (i + jnp.arange(N + 1)).astype(jnp.float32) * DT
        window = jax.vmap(ref12)(ts)
        u, _, mc = mpc_free.solve(mc, st, window)
        return (plant(st, u), mc), st
    (_, _), sts = jax.lax.scan(
        step, (x0, mpc_free.init_carry(x0)), jnp.arange(T))
    return sts


d_free = report("unconstrained (control)", np.asarray(fly_free(ref12(0.0))))

assert d_free < 0.3, "the control flight should penetrate the sphere"
assert d_pt > 0.3 and d_mt > 0.3, "constrained flights must clear it"
print("both constrained loops clear the sphere the reference path "
      "passes through; the unconstrained flight penetrates it.")
