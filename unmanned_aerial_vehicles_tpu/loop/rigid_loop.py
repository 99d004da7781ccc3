"""Multi-tick closed loops for the 12-state SQP and iLQR families.

The 12-state controllers the reference ships
(``/root/reference/src/px4/mpc_FULL.py:86-549``,
``mpc_direct_rates.py:76-922``) relinearise every tick in their per-tick
form. These loops make one accepted approximation: **relinearise once per
dispatch** of K ticks instead of once per tick.

Why that restructuring is the whole win: the staged SQP tick spends its
time on per-tick ``jacfwd`` (N stages), the condensation scan, and a
traced Cholesky — all of which only exist because the linearisation moves
every tick. Anchoring the linearisation to the warm-start plan for K
consecutive ticks (K*dt = 0.16 s at the default K=8) makes every matrix a
per-dispatch constant:

* per dispatch: one vmapped ``jacfwd``, one condensation, one Ruiz
  equilibration + Cholesky factor + operator composition (exactly the
  ``admm_box_qp_composite`` precomputation);
* per tick: two small matvecs (offset + linear cost), the composite ADMM
  chain (ONE (m,m) matvec per iteration), and the full **nonlinear** plant
  step — the plant is never linearised, only the controller's prediction
  model is.

A structural bonus the per-tick engine cannot have: the equilibration
scalars (d, e) are fixed across the dispatch, so ADMM duals warm-start
ACROSS TICKS in the same scaled space — the iteration count drops from 80
(cold per-tick) to ~30 with no RMS change (the linear-MPC warm-start
result repeats).

Accuracy is bounded by test against the per-tick staged engine
(``tests/test_rigid_multitick.py``): circle-task RMS parity to <2e-3 m at
K=8 for both the torque and direct-rate engines.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp

from ..control.ilqr import ILQRCarry, ILQRRigidBodyMPC, ilqr_solve
from ..control.mpc_sqp import QuadCost, SQPMPC
from ..ops.qp import (
    admm_box_qp_composite,
    condense_ltv_doubling,
)


def make_attitude_recovery_fallback(
    params,
    tilt_limit: float = 0.9,
    kp: float = 0.05,
    kd: float = 0.02,
    tau_max: float = 0.1,
    thrust_max: float | None = None,
):
    """In-graph emergency-recovery law for torque-input 12-state engines
    (``u = [T, tau_x, tau_y, tau_z]``) — the reference's solver-failure /
    emergency-hover semantics (``mpc_controller.py:296-316,363-368``,
    ``src/px4/mpc.py:2276-2282``) as a branch-free per-tick guard.

    The LTV/SQP subproblems clamp |roll|,|pitch| <= pi/4; once a transient
    tips the vehicle past that, the stage-0 state rows are infeasible and
    the QP cannot command a recovery (measured failure mode of the
    obstacle-circle flights: tip -> inversion -> thrust pinned at the
    lower bound -> free fall). This fallback detects the excursion BEFORE
    inversion (``tilt_limit`` < pi/2) and flies a PD level-off (gravity-
    compensating thrust, attitude PD with rate damping) until the MPC's
    linearisation is trustworthy again. Returns ``fb(x, u0) ->
    (u_applied, bad)``; the multitick loop also resets the ADMM duals on
    fallback ticks (windup from the infeasible rows is what kept the
    per-tick recovery from converging).

    ``thrust_max`` optionally clamps the recovery thrust to the vehicle's
    actuator ceiling (the engines bound thrust at 1.2x nominal hover,
    ``mpc_FULL.py`` parity): the gravity-compensating ``mg / cos(tilt)``
    reaches 3.3x mg at the clip floor, which no real actuator delivers.
    Default ``None`` keeps the historical unclamped law (the validated
    obstacle-tier recovery depends on its authority); population
    robustness studies (``loop.monte_carlo_mpc12``) pass the physical
    ceiling so their statistics don't lean on impossible thrust.
    """
    mg = params.mass * params.gravity

    def fb(x, u0):
        bad = (
            ~jnp.all(jnp.isfinite(u0))
            | ~jnp.all(jnp.isfinite(x))
            | (jnp.abs(x[6]) > tilt_limit)
            | (jnp.abs(x[7]) > tilt_limit)
        )
        cos_t = jnp.clip(jnp.cos(x[6]) * jnp.cos(x[7]), 0.3, 1.0)
        thrust = mg / cos_t
        if thrust_max is not None:
            thrust = jnp.minimum(thrust, thrust_max)
        tau_rp = -kp * x[6:8] - kd * x[9:11]
        tau_y = -kd * x[11]
        tau = jnp.clip(
            jnp.concatenate([tau_rp, tau_y[None]]), -tau_max, tau_max)
        u_safe = jnp.concatenate([thrust[None], tau]).astype(u0.dtype)
        return jnp.where(bad, u_safe, u0), bad

    return fb


class MultiTickCarry(NamedTuple):
    state: jnp.ndarray     # (nx,) plant state (true nonlinear state)
    X_plan: jnp.ndarray    # (N+1, nx) warm-start plan (linearisation anchor)
    U_plan: jnp.ndarray    # (N, nu)
    z: jnp.ndarray         # (m,) ADMM slack, unequilibrated space
    y: jnp.ndarray         # (m,) ADMM dual, unequilibrated space


def sqp_multitick_rollout(
    mpc: SQPMPC,
    cost: QuadCost,
    reference_fn: Callable,      # tick index array (K,) -> (K, N, nx) stage refs
    plant_step: Callable,        # (x, u) -> x_next  true plant
    x0: jnp.ndarray,
    num_steps: int,
    ticks_per_dispatch: int = 8,
    admm_iterations: int = 30,
    residuals: jnp.ndarray | None = None,
    u_init: jnp.ndarray | None = None,
    obstacles: jnp.ndarray | None = None,
    plan_roll_fn: Callable | None = None,
    fallback_fn: Callable | None = None,
):
    """Closed-loop rollout of an ``SQPMPC`` engine at dispatch granularity.

    ``reference_fn(tick_idx (K,) int) -> (K, N, nx)`` produces each tick's
    per-stage state reference. Returns a dict of stacked per-tick signals
    (``state`` pre-plant, ``u`` applied, plus the final carry under key
    ``"carry"``).

    ``obstacles (num_obstacles, 4)`` [x,y,z,r]: engines built with
    ``num_obstacles > 0`` carry the linearised spherical half-space rows of
    the per-tick path (``SQPMPC._subproblem``,
    ``mpc_controller.py:223-316`` semantics) at this tier too. The row
    NORMALS anchor to the dispatch's warm-start plan (re-anchored every
    K ticks), the row BOUNDS track the per-tick offset, so avoidance stays
    active between re-anchors. Detour parity vs the per-tick engine is
    pinned in ``tests/test_rigid_multitick.py::test_multitick_obstacle_detour``.

    After the K ticks the warm plan (the next dispatch's linearisation
    anchor) is re-anchored by a ``lax.scan`` of ``mpc.step_fn`` from the
    final state — the SQP semantics. ``plan_roll_fn(x_fin (nx,), U_fin
    (N, nu), residuals (N, nx)) -> X_tail (N, nx)`` replaces that roll.

    ``fallback_fn(x, u0) -> (u_applied, bad)``: optional per-tick
    emergency guard (``make_attitude_recovery_fallback``) — reference
    solver-failure semantics. On fallback ticks the ADMM slack/duals are
    also reset (the infeasible rows' dual windup otherwise poisons the
    recovery).
    """
    cfg = mpc.config
    N, nx, nu = cfg.horizon, mpc.nx, mpc.nu
    n_obs = getattr(mpc, "num_obstacles", 0)
    if obstacles is not None and not n_obs:
        raise ValueError(
            "obstacles passed but the engine was built with num_obstacles=0"
        )
    if n_obs and obstacles is None:
        # inactive placeholders (SQPMPC._defaults): hugely negative radius
        obstacles = (
            jnp.zeros((n_obs, 4), mpc.dtype).at[:, 3].set(-1e9)
        )
    K = ticks_per_dispatch
    if num_steps % K:
        raise ValueError(f"num_steps={num_steps} not a multiple of K={K}")
    dtype = mpc.dtype
    prec = jax.lax.Precision.HIGHEST
    mm = lambda a, b: jnp.matmul(a, b, precision=prec)

    residuals = (jnp.zeros((N, nx), dtype) if residuals is None
                 else residuals.astype(dtype))
    qbar = jnp.concatenate(
        [jnp.tile(cost.q_stage, N - 1), cost.q_terminal]
    ).astype(dtype)
    rbar = jnp.tile(cost.r_control, N).astype(dtype)
    u_ref_flat = jnp.tile(cost.u_ref.astype(dtype), N)

    step_jac = jax.vmap(
        jax.jacfwd(mpc.step_fn, argnums=(0, 1)), in_axes=(0, 0, 0)
    )

    rho = cfg.admm_rho

    def one_dispatch(carry: MultiTickCarry, tick0):
        # ---- per-dispatch: relinearise about the warm plan --------------
        X_warm = carry.X_plan.at[0].set(carry.state)
        X_bar, U_bar = X_warm, carry.U_plan
        A, B = step_jac(X_bar[:-1], U_bar, residuals)
        X_next = jax.vmap(mpc.step_fn)(X_bar[:-1], U_bar, residuals)
        c = X_next - jnp.einsum("kij,kj->ki", A, X_bar[:-1]) - jnp.einsum(
            "kij,kj->ki", B, U_bar
        )
        Sx, Su, Sc = condense_ltv_doubling(A, B, c)
        SuT_q = Su.T * qbar[None, :]                    # (NU, N*nx)
        H = mm(SuT_q, Su) + jnp.diag(rbar)

        G = jnp.concatenate([jnp.eye(N * nu, dtype=dtype), Su], axis=0)
        if n_obs:
            # linearised half-space obstacle rows (SQPMPC._subproblem
            # semantics): normals anchor to the warm-start plan, which
            # already detours — re-anchored per dispatch with the dynamics
            Su3 = Su.reshape(N, nx, N * nu)[:, 0:3, :]       # (N,3,NU)
            p_bar = X_warm[1:, 0:3]                          # (N,3) warm plan
            diff = p_bar[:, None, :] - obstacles[None, :, 0:3]  # (N,K_o,3)
            dist = jnp.sqrt(jnp.sum(diff**2, axis=-1) + 1e-9)
            n_vec = diff / dist[..., None]                   # (N,K_o,3)
            obs_rows = jnp.einsum("nkj,njp->nkp", n_vec, Su3)
            # per-tick bound = r + margin + n'obs - n'off3; split the
            # offset-independent part here, apply the offset term per tick
            lo_obs_base = (
                obstacles[None, :, 3] + mpc.obstacle_margin
                + jnp.einsum("nkj,kj->nk", n_vec, obstacles[:, 0:3])
            ).reshape(-1)
            G = jnp.concatenate([G, obs_rows.reshape(-1, N * nu)], axis=0)
        # Ruiz-style equilibration, FIXED for the whole dispatch — this is
        # what lets duals warm-start across ticks (same scaled space)
        d = 1.0 / jnp.sqrt(jnp.diagonal(H) + 1e-10)
        Hs = H * d[:, None] * d[None, :]
        Gd = G * d[None, :]
        e = 1.0 / jnp.sqrt(jnp.sum(Gd**2, axis=1) + 1e-10)
        Gs = Gd * e[:, None]
        M = Hs + rho * mm(Gs.T, Gs)
        M_chol = jnp.linalg.cholesky(M)
        # explicit M^{-1} once per dispatch: XLA triangular solves are
        # sequential/blocked, so solve for the (NU, NU)
        # inverse here and make every per-tick solve a plain matvec —
        # the per-tick cho_solve was the dominant per-tick cost
        Minv_s = jax.scipy.linalg.cho_solve(
            (M_chol, True), jnp.eye(Hs.shape[0], dtype=dtype))
        GMinvT_s = mm(Minv_s, Gs.T)
        P1 = mm(Gs, GMinvT_s)

        def one_tick(tcarry, k):
            x, U_prev, z, y = tcarry
            # warm-start shift (mpc.py:1632-1646 semantics, per tick)
            U_shift = jnp.concatenate([U_prev[1:], U_prev[-1:]], axis=0)

            def roll_block(vec, width):
                mat = vec.reshape(N, width)
                return jnp.concatenate([mat[1:], mat[-1:]], 0).reshape(-1)

            def shift_zy(vec):
                parts = [
                    roll_block(vec[: N * nu], nu),
                    roll_block(vec[N * nu: N * (nu + nx)], nx),
                ]
                if n_obs:
                    parts.append(roll_block(vec[N * (nu + nx):], n_obs))
                return jnp.concatenate(parts)

            z = shift_zy(z)
            y = shift_zy(y)

            ref_flat = refs_all[k].reshape(-1)
            offset = mm(Sx, x) + Sc
            f = mm(SuT_q, offset - ref_flat) - rbar * u_ref_flat
            lower = jnp.concatenate([mpc._u_lo, mpc._x_lo - offset])
            upper = jnp.concatenate([mpc._u_hi, mpc._x_hi - offset])
            if n_obs:
                off3 = offset.reshape(N, nx)[:, 0:3]
                lo_obs = lo_obs_base - jnp.einsum(
                    "nkj,nj->nk", n_vec, off3
                ).reshape(-1)
                lower = jnp.concatenate([lower, lo_obs])
                upper = jnp.concatenate(
                    [upper, jnp.full(N * n_obs, 1e9, dtype)]
                )

            fs = f * d
            p0 = -mm(GMinvT_s.T, fs)
            minv_f = mm(Minv_s, fs)
            sol = admm_box_qp_composite(
                P1, p0, GMinvT_s, minv_f,
                lower * e, upper * e, z * e, y / e,
                rho, admm_iterations, cfg.admm_over_relax,
            )
            z_new = sol.slack / e
            y_new = sol.dual * e
            U_new = z_new[: N * nu].reshape(N, nu)
            u0 = U_new[0]
            if fallback_fn is not None:
                u0, bad = fallback_fn(x, u0)
                z_new = jnp.where(bad, jnp.zeros_like(z_new), z_new)
                y_new = jnp.where(bad, jnp.zeros_like(y_new), y_new)
            x_new = plant_step(x, u0)
            out = {"state": x, "u": u0}
            return (x_new, U_new, z_new, y_new), out

        refs_all = reference_fn(tick0 + jnp.arange(K)).astype(dtype)
        (x_fin, U_fin, z_fin, y_fin), outs = jax.lax.scan(
            one_tick, (carry.state, carry.U_plan, carry.z, carry.y),
            jnp.arange(K),
        )
        # re-anchor the plan for the next dispatch's linearisation
        if plan_roll_fn is not None:
            X_tail = plan_roll_fn(x_fin, U_fin, residuals)
        else:
            def roll_plan(xc, inp):
                u, dres = inp
                xn = mpc.step_fn(xc, u, dres)
                return xn, xn

            _, X_tail = jax.lax.scan(roll_plan, x_fin, (U_fin, residuals))
        X_plan = jnp.concatenate([x_fin[None, :], X_tail], axis=0)
        return MultiTickCarry(x_fin, X_plan, U_fin, z_fin, y_fin), outs

    carry0 = MultiTickCarry(
        state=x0.astype(dtype),
        X_plan=jnp.tile(x0[None, :].astype(dtype), (N + 1, 1)),
        U_plan=jnp.tile(
            (cost.u_ref if u_init is None else u_init)[None, :].astype(dtype),
            (N, 1),
        ),
        z=jnp.zeros(N * (nu + nx + n_obs), dtype),
        y=jnp.zeros(N * (nu + nx + n_obs), dtype),
    )
    carry_fin, outs = jax.lax.scan(
        one_dispatch, carry0, jnp.arange(0, num_steps, K)
    )
    outs = jax.tree_util.tree_map(
        lambda a: a.reshape((num_steps,) + a.shape[2:]), outs
    )
    outs["carry"] = carry_fin
    return outs


def ilqr_multitick_rollout(
    eng: ILQRRigidBodyMPC,
    position_ref_fn: Callable,   # tick index array (K,) -> (K, 3) positions
    plant_step: Callable,        # (x, u) -> x_next  true plant
    x0: jnp.ndarray,
    num_steps: int,
    ticks_per_dispatch: int = 2,
) -> dict:
    """iLQR at dispatch granularity: ONE full solve per K ticks, then the
    solve's own time-varying LQR policy applied per tick.

    The iLQR tick is serial-chain-bound (rollout + backward + forward
    Riccati scans per iteration), but its Riccati
    backward pass already produces exactly what a cheaper tick needs: the
    feedback gains ``K_k`` of the final subproblem. Per dispatch this runs
    the full fixed-iteration solve from the current state; per tick it
    applies ``u_k = clip(U_plan[k] - K_k (x - X_plan[k]))`` (the ``u = -Kx
    - d`` convention of ``ops.riccati``) and steps the true plant — one
    (nu, nx) matvec instead of ten serial scans. Deviations from the plan
    (plant-vs-prediction mismatch, the moving reference) are absorbed by
    the feedback term until the next re-solve — the same
    per-dispatch-refresh approximation as the SQP multitick loop, bounded
    the same way (``tests/test_rigid_multitick.py``).
    Measured circle-task RMS vs the per-tick staged engine (0.549 m):
    K=1 0.552, K=2 0.559, K=4 0.576, K=8 0.602 — the policy degrades
    gracefully but the Euler-prediction-vs-RK4-plant mismatch accumulates,
    so the default is K=2 (<1.1 cm gap, half the solve cost).

    With ``ILQRRigidBodyMPC(integrator="rk4")`` that mismatch is GONE —
    the engine's internal model is the true plant step — so the plan is
    exact and the per-tick feedback only absorbs the moving reference.

    The ADMM/SQP warm-start result repeats here at dispatch granularity:
    with the shifted ``U_prev`` carried across dispatches, closed-loop RMS
    is iteration-invariant down to ``iterations=1`` (K=2: rms
    1.2364/1.2364/1.2363 m for 3/2/1 iterations); the engine default stays
    3 for cold-transient margin.

    Reference engine being accelerated: the per-tick Ipopt solves of
    ``/root/reference/src/px4/mpc_FULL.py:438-549`` at a <20 ms budget.
    """
    K = ticks_per_dispatch
    if num_steps % K:
        raise ValueError(f"num_steps={num_steps} not a multiple of K={K}")
    N, dtype = eng.N, eng.dtype
    u_ref = jnp.tile(eng.u_hover[None, :], (N, 1))

    def one_dispatch(carry, tick0):
        x, U_prev = carry
        pos_refs = position_ref_fn(tick0 + jnp.arange(K)).astype(dtype)
        # solve against the MID-dispatch target: the staged engine refreshes
        # its (constant) target every tick (mpc_FULL.py:438-460); holding
        # the dispatch-START target for K ticks biases the feedforward by
        # the reference motion over K*dt — centering halves that lag
        # (measured: 3.5 cm -> 1.5 cm RMS gap at K=4 on the circle task)
        x_ref_stage = jnp.concatenate([pos_refs[K // 2], jnp.zeros(9, dtype)])
        x_ref = jnp.tile(x_ref_stage[None, :], (N + 1, 1))
        U0 = jnp.concatenate([U_prev[1:], U_prev[-1:]], axis=0)
        sol = ilqr_solve(
            eng.step_fn, x, U0, eng.q_diag, eng.r_diag, x_ref, u_ref,
            iterations=eng.iterations, reg=eng.reg,
            u_lower=eng.u_lower, u_upper=eng.u_upper,
            parallel=eng.parallel,
        )

        def one_tick(xc, k):
            du = -jnp.einsum("ij,j->i", sol.gains[k], xc - sol.X[k])
            u = jnp.clip(sol.U[k] + du, eng.u_lower, eng.u_upper)
            xn = plant_step(xc, u)
            return xn, {"state": xc, "u": u}

        x_fin, outs = jax.lax.scan(one_tick, x, jnp.arange(K))
        U_next = jnp.concatenate(
            [sol.U[K:], jnp.tile(sol.U[-1:], (K, 1))], axis=0
        )
        return (x_fin, U_next), outs

    carry0 = (x0.astype(dtype), jnp.tile(eng.u_hover[None, :], (N, 1)))
    (x_fin, U_fin), outs = jax.lax.scan(
        one_dispatch, carry0, jnp.arange(0, num_steps, K)
    )
    outs = jax.tree_util.tree_map(
        lambda a: a.reshape((num_steps,) + a.shape[2:]), outs
    )
    outs["carry"] = ILQRCarry(U_prev=U_fin)
    return outs
