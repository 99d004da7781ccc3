"""Adversarial/edge-case robustness tests (SURVEY.md section 5: failure
detection and controller-level fallbacks)."""

import jax
import jax.numpy as jnp
import numpy as np

from unmanned_aerial_vehicles_tpu.control.mpc_linear import LinearMPC, LinearMPCConfig
from unmanned_aerial_vehicles_tpu.gp import (
    fit_residual_gp,
    predict,
    predict_mean,
)
from unmanned_aerial_vehicles_tpu.gp.residual_gp import ResidualGPConfig


def small_mpc(**kw):
    return LinearMPC(
        LinearMPCConfig(horizon=10, admm_iterations=120, **kw), dtype=jnp.float64
    )


def test_mpc_with_infeasible_initial_state():
    """x0 outside the state box (the reference flies through such states
    after aggressive disturbances): the solve must stay finite and the
    CONTROLS must respect their own bounds."""
    mpc = small_mpc()
    state = jnp.asarray([40.0, -40.0, 25.0, 10.0, -10.0, 6.0])  # all outside
    target = jnp.zeros(3)
    u0, X_opt, _ = mpc.solve(mpc.init_carry(state), state, target)
    assert bool(jnp.all(jnp.isfinite(u0)))
    assert bool(jnp.all(jnp.isfinite(X_opt)))
    lo = np.asarray([-4.0, -4.0, -5.0, -1.0])
    hi = np.asarray([4.0, 4.0, 8.0, 1.0])
    assert np.all(np.asarray(u0) >= lo - 1e-9)
    assert np.all(np.asarray(u0) <= hi + 1e-9)


def test_mpc_nan_state_does_not_crash_and_fallback_works():
    """A NaN state produces NaN commands (garbage in); the full-system
    loop's hover fallback must then engage."""
    mpc = small_mpc()
    state = jnp.full(6, jnp.nan)
    u0, _, _ = mpc.solve(mpc.init_carry(jnp.zeros(6)), state, jnp.zeros(3))
    # the in-graph fallback used by loop/full_system.py:
    hover = jnp.zeros(4)
    u_safe = jnp.where(jnp.all(jnp.isfinite(u0)), u0, hover)
    np.testing.assert_array_equal(np.asarray(u_safe), np.zeros(4))


def test_gp_with_duplicate_training_points():
    """Exactly duplicated rows make K singular without regularisation; the
    White noise + alpha jitter must keep the Cholesky finite (the
    reference's jitter-escalation fallback, gaussian_process.py:193-201,
    exists for this failure)."""
    rng = np.random.default_rng(0)
    X = rng.normal(size=(50, 10))
    X[25:] = X[:25]  # every point duplicated
    Y = rng.normal(size=(50, 6)) * 0.1
    post = fit_residual_gp(jnp.asarray(X), jnp.asarray(Y))
    assert bool(jnp.all(jnp.isfinite(post.chol)))
    mean, var = predict(post, jnp.asarray(X[:5]))
    assert bool(jnp.all(jnp.isfinite(mean)))
    assert bool(jnp.all(var > 0))


def test_gp_with_constant_targets():
    """Zero-variance outputs: sklearn's normalize_y guards y_std == 0."""
    rng = np.random.default_rng(0)
    X = rng.normal(size=(40, 10))
    Y = np.ones((40, 6)) * 3.14
    post = fit_residual_gp(jnp.asarray(X), jnp.asarray(Y))
    mean = predict_mean(post, jnp.asarray(X[:3]))
    np.testing.assert_allclose(np.asarray(mean), 3.14, atol=1e-9)


def test_full_system_survives_nan_reference():
    """A reference that goes NaN mid-flight must not take the plant down:
    the hover fallback holds the vehicle."""
    from unmanned_aerial_vehicles_tpu.loop import (
        OnlineGPMPCConfig,
        online_gp_mpc_rollout,
    )

    cfg = OnlineGPMPCConfig(gp=ResidualGPConfig(max_data_points=64),
                            gp_refit_every=1000)
    mpc = small_mpc()

    def ref(t):
        pos = jnp.where(t > 5.0, jnp.nan, 1.0) * jnp.asarray([1.0, 0.0, 3.0])
        return pos, jnp.zeros(())

    outs, _, _ = jax.jit(
        lambda: online_gp_mpc_rollout(mpc, ref, 400, cfg=cfg, dtype=jnp.float64)
    )()
    # after the reference NaNs, commands fall back to hover: the STATE must
    # remain finite for the whole flight
    assert bool(jnp.all(jnp.isfinite(outs["state"])))


def test_trajectory_configs_under_vmap_time_batches():
    from unmanned_aerial_vehicles_tpu.trajectories import get_trajectory_function

    fn = get_trajectory_function("waypoint_square")
    ts = jnp.linspace(0.0, 50.0, 32).reshape(4, 8)
    pos, vel, acc = jax.vmap(fn)(ts)
    assert pos.shape == (4, 8, 3)
    assert bool(jnp.all(jnp.isfinite(pos)))


def test_hover_fallback_combinator():
    """with_hover_fallback replaces non-finite commands in-graph and is a
    no-op on healthy solves (the Ipopt-failure -> hover behaviour of
    mpc.py:1627-1630 as a reusable wrapper)."""
    import jax

    from unmanned_aerial_vehicles_tpu.control import with_hover_fallback

    def bad_controller(x):
        return jnp.where(x[0] > 0, jnp.nan, 1.0) * jnp.ones(4), x

    safe = jax.jit(with_hover_fallback(bad_controller))
    u, _ = safe(jnp.ones(3))
    np.testing.assert_array_equal(np.asarray(u), np.zeros(4))
    u, _ = safe(-jnp.ones(3))
    np.testing.assert_array_equal(np.asarray(u), np.ones(4))

    custom = jax.jit(
        with_hover_fallback(bad_controller, hover_control=[0.0, 0.0, 9.81, 0.0])
    )
    u, _ = custom(jnp.ones(3))
    np.testing.assert_array_equal(np.asarray(u), [0.0, 0.0, 9.81, 0.0])


def test_extreme_states_stay_finite():
    """The flight must stay finite and box-feasible from hostile initial
    conditions (far from target, high speed, saturated)."""
    import jax

    from unmanned_aerial_vehicles_tpu.control.mpc_linear import (
        LinearMPC,
        LinearMPCConfig,
    )
    from unmanned_aerial_vehicles_tpu.loop import (
        FlightLoopConfig,
        mpc_flight_rollout,
    )

    mpc = LinearMPC(LinearMPCConfig(horizon=10, admm_iterations=40))
    cfg = FlightLoopConfig()

    def ref(t):
        return jnp.array([0.0, 0.0, 3.0]), jnp.zeros(())

    for x0 in (
        jnp.asarray([25.0, -25.0, 18.0, 7.0, -7.0, 3.5, 0.5, -0.5, 2.0,
                     1.0, -1.0, 0.5], jnp.float32),
        jnp.zeros(12, jnp.float32).at[2].set(-4.0).at[5].set(-3.9),
    ):
        outs = jax.jit(
            lambda x=x0: mpc_flight_rollout(mpc, ref, 600, cfg=cfg,
                                            initial_state=x)
        )()
        st = np.asarray(outs["state"])
        u = np.asarray(outs["u_mpc"])
        assert np.isfinite(st).all() and np.isfinite(u).all()
        # commands obey the control box at every tick (slack extraction)
        assert (u[:, 0:2] <= 4.0 + 1e-5).all() and (u[:, 0:2] >= -4.0 - 1e-5).all()
        assert (u[:, 2] <= 8.0 + 1e-5).all() and (u[:, 2] >= -5.0 - 1e-5).all()
        # and the flight recovers toward the hover target
        final_err = np.linalg.norm(st[-1, 0:3] - np.array([0.0, 0.0, 3.0]))
        start_err = np.linalg.norm(st[0, 0:3] - np.array([0.0, 0.0, 3.0]))
        assert final_err < start_err
