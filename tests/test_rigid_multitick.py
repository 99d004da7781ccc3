"""Multi-tick (per-dispatch-relinearisation) tier for the 12-state family.

RMS parity of ``loop.rigid_loop.sqp_multitick_rollout`` against the per-tick
staged SQP engines on the circle task (the per-dispatch relinearisation is
bounded by test, not assumed). Also pins the structural claim that motivates the tier: with the
equilibration frozen across a dispatch, ADMM duals warm-start across ticks
and the iteration count stops mattering (30 vs 80 identical).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from unmanned_aerial_vehicles_tpu.control.ilqr import ILQRRigidBodyMPC
from unmanned_aerial_vehicles_tpu.control.mpc_rigid import (
    DirectRateMPC,
    RigidBodyMPC,
    direct_rate_step,
)
from unmanned_aerial_vehicles_tpu.loop.rigid_loop import (
    ilqr_multitick_rollout,
    sqp_multitick_rollout,
)
from unmanned_aerial_vehicles_tpu.models import X500_PARAMS, rigid_body_rk4_step
from unmanned_aerial_vehicles_tpu.trajectories import ramped_circle_reference

DT = 0.02
H = 3.0
T = 240


def _ref(t):
    pos, _, yaw = ramped_circle_reference(t, amplitude=2.0, height=H)
    return pos, yaw


def _staged_rms(eng, plant, T):
    def step(c, i):
        st, mc = c
        t = i.astype(jnp.float32) * DT
        pos_ref, _ = _ref(t)
        u, _, mc = eng.solve(mc, st, jnp.asarray(pos_ref, jnp.float32))
        st = plant(st, u)
        return (st, mc), jnp.sum((st[0:3] - pos_ref) ** 2)

    x0 = jnp.zeros(12, jnp.float32).at[2].set(H)
    errs = jax.jit(
        lambda x: jax.lax.scan(step, (x, eng.init_carry(x)), jnp.arange(T))[1]
    )(x0)
    return float(jnp.sqrt(jnp.mean(errs)))


def _multitick_rms(eng, plant, T, K, iters):
    N = eng.mpc.config.horizon

    def reference_fn(ticks):
        ts = ticks.astype(jnp.float32) * DT
        pos, _, _ = jax.vmap(
            lambda t: ramped_circle_reference(t, amplitude=2.0, height=H)
        )(ts)
        stage = jnp.concatenate([pos, jnp.zeros((ts.shape[0], 9))], axis=1)
        return jnp.tile(stage[:, None, :], (1, N, 1))

    x0 = jnp.zeros(12, jnp.float32).at[2].set(H)
    outs = jax.jit(lambda x: sqp_multitick_rollout(
        eng.mpc, eng.cost, reference_fn, plant, x, T,
        ticks_per_dispatch=K, admm_iterations=iters, u_init=eng.u_hover,
    ))(x0)
    ps = np.asarray(outs["state"])[:, 0:3]
    rs = np.stack([np.asarray(_ref(t * DT)[0]) for t in range(T)])
    assert np.isfinite(ps).all()
    return float(np.sqrt(np.mean(np.sum((ps - rs) ** 2, -1))))


@pytest.mark.parametrize("engine", ["rigid", "direct_rate"])
def test_multitick_rms_parity(engine):
    if engine == "rigid":
        eng = RigidBodyMPC()
        plant = lambda x, u: rigid_body_rk4_step(x, u, X500_PARAMS, DT)
    else:
        eng = DirectRateMPC()
        plant = lambda x, u: direct_rate_step(
            x, u, jnp.zeros(12, jnp.float32), dt=DT
        )
    staged = _staged_rms(eng, plant, T)
    fused = _multitick_rms(eng, plant, T, K=8, iters=30)
    # per-dispatch relinearisation costs <1 cm RMS on a ~0.5 m task
    # (measured 4-6 mm for both engines at K=4 AND K=8 — the gap is the
    # warm-anchor difference, not dispatch length)
    assert abs(fused - staged) < 0.012, (staged, fused)


def test_multitick_iteration_invariance():
    """Frozen equilibration -> duals warm-start across ticks -> the ADMM
    count stops mattering (30 vs 80 within 1e-4 RMS)."""
    eng = RigidBodyMPC()
    plant = lambda x, u: rigid_body_rk4_step(x, u, X500_PARAMS, DT)
    rms30 = _multitick_rms(eng, plant, T, K=8, iters=30)
    rms80 = _multitick_rms(eng, plant, T, K=8, iters=80)
    assert abs(rms30 - rms80) < 1e-4, (rms30, rms80)


def test_ilqr_multitick_policy_parity():
    """iLQR policy-reuse tier: one solve per dispatch + per-tick LQR
    feedback tracks the per-tick staged engine on the circle task."""
    eng = ILQRRigidBodyMPC()
    plant = lambda x, u: rigid_body_rk4_step(x, u, X500_PARAMS, DT)
    staged = _staged_rms(eng, plant, T)

    def position_ref_fn(ticks):
        ts = ticks.astype(jnp.float32) * DT
        pos, _, _ = jax.vmap(
            lambda t: ramped_circle_reference(t, amplitude=2.0, height=H)
        )(ts)
        return pos

    x0 = jnp.zeros(12, jnp.float32).at[2].set(H)
    rs = np.stack([np.asarray(_ref(t * DT)[0]) for t in range(T)])

    def rms_at(K):
        outs = jax.jit(lambda x: ilqr_multitick_rollout(
            eng, position_ref_fn, plant, x, T, ticks_per_dispatch=K,
        ))(x0)
        ps = np.asarray(outs["state"])[:, 0:3]
        assert np.isfinite(ps).all()
        return float(np.sqrt(np.mean(np.sum((ps - rs) ** 2, -1))))

    # default K=2: policy ticks cost <1.5 cm RMS on a ~0.55 m task
    # (measured trend vs staged 0.549: K=1 0.552, K=2 0.559, K=4 0.576,
    # K=8 0.602 — the Euler-prediction-vs-RK4-plant mismatch accumulates)
    fused2 = rms_at(2)
    assert abs(fused2 - staged) < 0.015, (staged, fused2)
    # longer dispatches degrade gracefully, not catastrophically
    fused8 = rms_at(8)
    assert abs(fused8 - staged) < 0.07, (staged, fused8)


def test_ilqr_multitick_iteration_invariance():
    """The dispatch-carried warm start (shifted U_prev) makes the policy
    loop ITERATION-invariant, the same result the per-tick engines show
    (6/3/2/1 iterations identical RMS), which justifies flying it at one
    iteration."""
    plant = lambda x, u: rigid_body_rk4_step(x, u, X500_PARAMS, DT)

    def position_ref_fn(ticks):
        ts = ticks.astype(jnp.float32) * DT
        pos, _, _ = jax.vmap(
            lambda t: ramped_circle_reference(t, amplitude=2.0, height=H)
        )(ts)
        return pos

    x0 = jnp.zeros(12, jnp.float32).at[2].set(H)
    rs = np.stack([np.asarray(_ref(t * DT)[0]) for t in range(T)])

    def rms_at_iters(iters):
        eng = ILQRRigidBodyMPC(iterations=iters)
        outs = jax.jit(lambda x: ilqr_multitick_rollout(
            eng, position_ref_fn, plant, x, T, ticks_per_dispatch=2,
        ))(x0)
        ps = np.asarray(outs["state"])[:, 0:3]
        assert np.isfinite(ps).all()
        return float(np.sqrt(np.mean(np.sum((ps - rs) ** 2, -1))))

    r3 = rms_at_iters(3)
    r1 = rms_at_iters(1)
    assert abs(r1 - r3) < 2e-3, (r3, r1)


def test_multitick_dispatch_length_insensitive():
    eng = DirectRateMPC()
    plant = lambda x, u: direct_rate_step(
        x, u, jnp.zeros(12, jnp.float32), dt=DT
    )
    r4 = _multitick_rms(eng, plant, T, K=4, iters=30)
    r8 = _multitick_rms(eng, plant, T, K=8, iters=30)
    assert abs(r4 - r8) < 1e-3, (r4, r8)


def test_multitick_obstacle_detour():
    """Obstacle rows at the multitick tier (VERDICT round-4 #3): the same
    sphere-detour scenario as ``test_ltv_flight.py`` flown through
    ``sqp_multitick_rollout`` — the constrained flight must clear the
    sphere the reference passes through, the unconstrained one must
    penetrate, and the cleared distance must agree with the per-tick
    LTV engine's (``mpc_controller.py:223-316`` semantics)."""
    from unmanned_aerial_vehicles_tpu.control import LTVTrackingMPC
    from unmanned_aerial_vehicles_tpu.models import GZ_QUADROTOR_PARAMS

    LDT = 0.1           # 10 Hz MPC (mpc_controller_node.py default rate)
    SUB = 10            # plant RK4 at 100 Hz
    obstacle = jnp.asarray([[1.5, 0.0, 1.0, 0.4]], jnp.float64)
    radius = 0.4

    def ref_of_t(t):
        x = jnp.clip(0.3 * t, 0.0, 3.0)
        r = jnp.zeros(12, jnp.float64)
        r = r.at[0].set(x).at[2].set(1.0)
        return r.at[3].set(jnp.where(x < 3.0, 0.3, 0.0))

    def plant(x, u):
        def sub(xc, _):
            return rigid_body_rk4_step(
                xc, u, GZ_QUADROTOR_PARAMS, LDT / SUB
            ), None
        xn, _ = jax.lax.scan(sub, x, None, length=SUB)
        return xn

    x0 = ref_of_t(0.0)

    def fly(con, obstacles):
        N = con.mpc.config.horizon

        def reference_fn(ticks):
            def one(i):
                ts = (i + 1 + jnp.arange(N)) * LDT
                return jax.vmap(ref_of_t)(ts)
            return jax.vmap(one)(ticks)

        outs = jax.jit(lambda x: sqp_multitick_rollout(
            con.mpc, con.cost, reference_fn, plant, x, 140,
            ticks_per_dispatch=4, admm_iterations=60,
            u_init=con.u_hover, obstacles=obstacles,
        ))(x0)
        st = np.asarray(outs["state"])
        assert np.isfinite(st).all()
        return st

    st_free = fly(LTVTrackingMPC(dtype=jnp.float64), None)
    st_con = fly(
        LTVTrackingMPC(num_obstacles=1, obstacle_margin=0.2,
                       dtype=jnp.float64),
        obstacle,
    )
    centre = np.asarray(obstacle[0, 0:3])
    d_free = float(np.linalg.norm(st_free[:, 0:3] - centre, axis=1).min())
    d_con = float(np.linalg.norm(st_con[:, 0:3] - centre, axis=1).min())
    assert d_free < radius, f"unconstrained flight should penetrate ({d_free:.2f})"
    assert d_con > radius, f"constrained flight hit the sphere ({d_con:.2f})"
    # reaches the far side, like the per-tick test
    assert abs(float(st_con[-1, 0]) - 3.0) < 0.3
    # detour-distance parity with the per-tick engine (which clears by
    # r + margin-ish; both tiers must clear by a comparable amount)
    assert d_con < radius + 0.45, d_con


def test_multitick_rejects_obstacles_without_rows():
    """Passing obstacles to an engine built without reserved rows raises."""
    eng = RigidBodyMPC()
    plant = lambda x, u: rigid_body_rk4_step(x, u, X500_PARAMS, DT)
    with pytest.raises(ValueError, match="num_obstacles=0"):
        sqp_multitick_rollout(
            eng.mpc, eng.cost, lambda t: jnp.zeros((4, 15, 12)), plant,
            jnp.zeros(12), 8, ticks_per_dispatch=4,
            obstacles=jnp.zeros((1, 4)),
        )


def test_attitude_recovery_fallback_levels_off():
    """The in-graph emergency law (reference solver-failure hover,
    mpc_controller.py:296-316): from a badly tipped state with garbage
    controls, the fallback must engage, command gravity-compensating
    thrust + restoring torque, and the closed loop must level off
    instead of inverting."""
    from unmanned_aerial_vehicles_tpu.loop.rigid_loop import (
        make_attitude_recovery_fallback,
    )
    from unmanned_aerial_vehicles_tpu.models import GZ_QUADROTOR_PARAMS

    fb = make_attitude_recovery_fallback(GZ_QUADROTOR_PARAMS)
    x_bad = (jnp.zeros(12, jnp.float64)
             .at[2].set(1.0).at[6].set(1.3).at[9].set(2.0))
    u_junk = jnp.asarray([0.0, -0.1, 0.1, 0.1], jnp.float64)
    u, bad = fb(x_bad, u_junk)
    assert bool(bad)
    assert float(u[0]) > GZ_QUADROTOR_PARAMS.mass * GZ_QUADROTOR_PARAMS.gravity
    assert float(u[1]) < 0.0  # restoring roll torque

    # a level state passes the MPC's command through untouched
    x_ok = jnp.zeros(12, jnp.float64).at[2].set(1.0)
    u_mpc = jnp.asarray([4.9, 0.01, -0.01, 0.0], jnp.float64)
    u2, bad2 = fb(x_ok, u_mpc)
    assert not bool(bad2)
    np.testing.assert_allclose(np.asarray(u2), np.asarray(u_mpc))

    # closed loop from the tipped state with a plain hover passthrough
    # below the threshold: the guard must prevent inversion and kill the
    # tumble rate (full level-off is the MPC's job once it re-engages —
    # pinned on-chip by the obstacle-circle stability runs)
    mg = GZ_QUADROTOR_PARAMS.mass * GZ_QUADROTOR_PARAMS.gravity
    u_hover = jnp.asarray([mg, 0.0, 0.0, 0.0], jnp.float64)

    def step(x, _):
        u, _bad = fb(x, u_hover)
        return rigid_body_rk4_step(x, u, GZ_QUADROTOR_PARAMS, 0.02), x

    x_fin, traj = jax.lax.scan(step, x_bad, None, length=200)
    assert float(jnp.max(jnp.abs(traj[:, 6:8]))) < 1.5  # never inverts
    assert abs(float(x_fin[9])) < 0.5 and abs(float(x_fin[10])) < 0.5
    assert abs(float(x_fin[6])) < 1.0, x_fin[6]


def test_plan_roll_fn_replaces_default_roll():
    """``plan_roll_fn`` replaces the default re-anchor roll (a scan of
    ``mpc.step_fn``): passing that same roll must reproduce the default
    flight exactly, and a roll through the true plant must fly the task
    at comparable RMS (the rolls differ only in anchor quality)."""
    eng = RigidBodyMPC()
    plant = lambda x, u: rigid_body_rk4_step(x, u, X500_PARAMS, DT)
    N = eng.mpc.config.horizon

    def reference_fn(ticks):
        ts = ticks.astype(jnp.float64) * DT
        pos = jax.vmap(lambda t: _ref(t)[0])(ts)
        stage = jnp.concatenate([pos, jnp.zeros((ts.shape[0], 9))], axis=1)
        return jnp.tile(stage[:, None, :], (1, N, 1))

    def same_roll(x_fin, U_fin, residuals):
        def body(xc, inp):
            xn = eng.mpc.step_fn(xc, *inp)
            return xn, xn
        return jax.lax.scan(body, x_fin, (U_fin, residuals))[1]

    def plant_roll(x_fin, U_fin, residuals):
        def body(xc, u):
            xn = plant(xc, u)
            return xn, xn
        return jax.lax.scan(body, x_fin, U_fin)[1]

    def fly(roll):
        x0 = jnp.zeros(12, jnp.float64).at[2].set(H)
        outs = jax.jit(lambda x: sqp_multitick_rollout(
            eng.mpc, eng.cost, reference_fn, plant, x, T,
            ticks_per_dispatch=8, admm_iterations=30, u_init=eng.u_hover,
            plan_roll_fn=roll,
        ))(x0)
        return np.asarray(outs["state"])[:, 0:3]

    def rms(ps):
        rs = np.stack([np.asarray(_ref(t * DT)[0]) for t in range(T)])
        return float(np.sqrt(np.mean(np.sum((ps - rs) ** 2, -1))))

    default, same, through_plant = fly(None), fly(same_roll), fly(plant_roll)
    np.testing.assert_array_equal(default, same)
    assert np.isfinite(through_plant).all()
    assert abs(rms(through_plant) - rms(default)) < 0.05
