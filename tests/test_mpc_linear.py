"""Linear MPC tests: QP parity vs scipy, hover behaviour, closed-loop tracking."""

import jax
import jax.numpy as jnp
import numpy as np
import scipy.optimize

from unmanned_aerial_vehicles_tpu.control.mpc_linear import (
    LinearMPC,
    LinearMPCConfig,
)
from unmanned_aerial_vehicles_tpu.loop import (
    FlightLoopConfig,
    mpc_flight_rollout,
    pid_flight_rollout,
)
from unmanned_aerial_vehicles_tpu.metrics import rms_position_error
from unmanned_aerial_vehicles_tpu.trajectories import ramped_figure8_reference


def small_mpc(**kw):
    cfg = LinearMPCConfig(horizon=10, admm_iterations=kw.pop("iters", 300), **kw)
    return LinearMPC(cfg, dtype=jnp.float64)


def test_solve_matches_scipy_reference(rng):
    """One tick vs SLSQP on the identical condensed QP (active accel bounds)."""
    mpc = small_mpc()
    state = jnp.asarray([4.0, -3.0, 1.0, 1.5, -0.5, 0.2])
    target = jnp.asarray([-4.0, 3.0, 3.0])  # far target -> accel bounds active

    H, G, f, lo, hi = map(np.asarray, mpc.qp_data(state, target))
    cons = [
        {"type": "ineq", "fun": lambda u: hi - G @ u, "jac": lambda u: -G},
        {"type": "ineq", "fun": lambda u: G @ u - lo, "jac": lambda u: G},
    ]
    ref = scipy.optimize.minimize(
        lambda u: 0.5 * u @ H @ u + f @ u,
        np.zeros(H.shape[0]),
        jac=lambda u: H @ u + f,
        method="SLSQP",
        constraints=cons,
        # scipy 1.17's SLSQP converges here but reports a line-search
        # failure at ftol=1e-14; 1e-12 still pins u0 to ~1e-9
        options={"ftol": 1e-12, "maxiter": 3000},
    )
    assert ref.success

    carry = mpc.init_carry(state)
    u0, X_opt, _ = mpc.solve(carry, state, target)
    u_ref = ref.x[:4]
    np.testing.assert_allclose(np.asarray(u0), u_ref, atol=2e-5)
    # accel bounds must actually be active for this scenario
    assert np.any(np.isclose(np.abs(u_ref[:2]), 4.0, atol=1e-6))


def test_hover_gives_zero_control():
    mpc = small_mpc()
    state = jnp.asarray([1.0, -2.0, 3.0, 0.0, 0.0, 0.0])
    target = state[0:3]
    u0, X_opt, _ = mpc.solve(mpc.init_carry(state), state, target)
    np.testing.assert_allclose(np.asarray(u0), np.zeros(4), atol=1e-7)
    np.testing.assert_allclose(
        np.asarray(X_opt[-1]), np.asarray(state), atol=1e-7
    )


def test_residuals_shift_solution():
    """A constant +z dynamics residual must reduce commanded az (the MPC
    pre-compensates), mirroring mpc.py:1404-1412 semantics."""
    mpc = small_mpc()
    state = jnp.zeros(6)
    target = jnp.zeros(3)
    D = jnp.zeros((10, 6)).at[:, 5].set(2.0)  # +2 m/s^2 vertical residual
    u_plain, _, _ = mpc.solve(mpc.init_carry(state), state, target)
    u_resid, _, _ = mpc.solve(mpc.init_carry(state), state, target, D)
    assert float(u_resid[2]) < float(u_plain[2]) - 0.1


def test_warm_start_carry_is_consistent():
    """Re-solving the same problem from the returned carry stays at optimum."""
    mpc = small_mpc()
    state = jnp.asarray([0.5, 0.5, 2.0, 0.0, 0.0, 0.0])
    target = jnp.asarray([1.0, 0.0, 2.0])
    carry = mpc.init_carry(state)
    u1, _, carry = mpc.solve(carry, state, target)
    u2, _, carry = mpc.solve(carry, state, target)
    np.testing.assert_allclose(np.asarray(u1), np.asarray(u2), atol=1e-6)


def test_closed_loop_figure8_tracking():
    """Full fused rollout: MPC + allocation + PX4-surrogate plant, 40 s."""
    mpc = LinearMPC(LinearMPCConfig(admm_iterations=60), dtype=jnp.float64)
    cfg = FlightLoopConfig()

    def ref(t):
        pos, yaw = ramped_figure8_reference(t, amplitude=6.0, frequency=0.02)
        return pos + jnp.array([0.0, 0.0, cfg.takeoff_height]), yaw

    outs = jax.jit(
        lambda: mpc_flight_rollout(mpc, ref, num_steps=2000, cfg=cfg, dtype=jnp.float64)
    )()
    pos = outs["state"][:, 0:3]
    rms = float(rms_position_error(outs["pos_ref"], pos))
    assert np.isfinite(rms)
    # Reference campaign: 1.094 m RMS on PX4 SITL (BASELINE.md). Surrogate
    # plant differs from Gazebo, so just require same order or better.
    assert rms < 1.5, f"fig-8 RMS position error too high: {rms:.3f} m"


def test_closed_loop_pid_circle():
    from unmanned_aerial_vehicles_tpu.trajectories import ramped_circle_reference

    cfg = FlightLoopConfig()

    def ref(t):
        pos, _, yaw = ramped_circle_reference(
            t, amplitude=6.0, frequency=0.02, height=cfg.takeoff_height
        )
        return pos, yaw

    outs = jax.jit(
        lambda: pid_flight_rollout(ref, num_steps=2000, cfg=cfg, dtype=jnp.float64)
    )()
    pos = outs["state"][:, 0:3]
    rms = float(rms_position_error(outs["pos_ref"], pos))
    assert np.isfinite(rms)
    # Reference cascade-PID campaign: 2.524 m RMS (BASELINE.md row 7).
    assert rms < 4.0, f"PID circle RMS position error too high: {rms:.3f} m"


def test_preview_mode_slashes_tracking_lag():
    """Per-stage horizon references (preview) must dramatically beat the
    reference's point-target tracking (1.086 m published; measured 8x
    improvement: 0.96 -> 0.14 m RMS)."""
    mpc = LinearMPC(LinearMPCConfig(admm_iterations=60), dtype=jnp.float64)
    cfg = FlightLoopConfig()

    def ref(t):
        pos, yaw = ramped_figure8_reference(t, amplitude=6.0, frequency=0.02)
        return pos + jnp.array([0.0, 0.0, cfg.takeoff_height]), yaw

    outs_point = jax.jit(
        lambda: mpc_flight_rollout(mpc, ref, 1500, cfg=cfg, dtype=jnp.float64)
    )()
    outs_prev = jax.jit(
        lambda: mpc_flight_rollout(
            mpc, ref, 1500, cfg=cfg, preview=True, dtype=jnp.float64
        )
    )()

    def rms(outs):
        return float(
            rms_position_error(outs["pos_ref"], outs["state"][:, 0:3])
        )

    assert rms(outs_prev) < 0.5 * rms(outs_point)
    assert rms(outs_prev) < 0.35


def test_uncertainty_tightening_backs_off_bounds():
    """Zero-order GP-MPC back-off: with tightening the planned velocities
    keep a margin proportional to the propagated GP std; with factor 0 the
    solution is bit-identical to the baseline."""
    from unmanned_aerial_vehicles_tpu.control.mpc_linear import (
        LinearMPC,
        LinearMPCConfig,
    )

    base = LinearMPC(LinearMPCConfig(horizon=15, admm_iterations=120),
                     dtype=jnp.float64)
    tight = LinearMPC(
        LinearMPCConfig(horizon=15, admm_iterations=120,
                        tightening_factor=3.0),
        dtype=jnp.float64,
    )
    # fast state + far target -> the baseline plan stays near the 8 m/s box
    state = jnp.zeros(6).at[2].set(3.0).at[3].set(7.9)
    target = jnp.asarray([60.0, 0.0, 3.0])
    sigma = jnp.zeros((15, 6)).at[:, 3:6].set(25.0)  # large accel-row std

    u_b, X_b, _ = base.solve(base.init_carry(state), state, target)
    u_t, X_t, _ = tight.solve(tight.init_carry(state), state, target,
                              uncertainty=sigma)
    # baseline keeps the speed; the tightened plan brakes toward the
    # shrunken box for as hard as its accel bounds allow
    v_end_b = float(X_b[-1, 3])
    v_end_t = float(X_t[-1, 3])
    assert v_end_b > 7.0
    assert v_end_t < v_end_b - 1.0

    # factor 0 (or no uncertainty): bit-identical to baseline
    zero = LinearMPC(LinearMPCConfig(horizon=15, admm_iterations=120),
                     dtype=jnp.float64)
    u_z, X_z, _ = zero.solve(zero.init_carry(state), state, target,
                             uncertainty=sigma)
    np.testing.assert_array_equal(np.asarray(u_z), np.asarray(u_b))
    np.testing.assert_array_equal(np.asarray(X_z), np.asarray(X_b))


def test_build_horizon_uncertainty_shape(flight_csvs):
    from unmanned_aerial_vehicles_tpu.gp import (
        build_horizon_uncertainty,
        fit_residual_gp,
    )
    from unmanned_aerial_vehicles_tpu.gp.residual_gp import ResidualGPConfig
    from unmanned_aerial_vehicles_tpu.io import load_gp_datasets

    cfg = ResidualGPConfig()
    X, Y = load_gp_datasets(flight_csvs, max_samples=200)
    post = fit_residual_gp(jnp.asarray(X), jnp.asarray(Y), cfg)
    S = build_horizon_uncertainty(
        post, jnp.zeros((11, 6)).at[:, 2].set(3.0), jnp.zeros((10, 4)), cfg
    )
    s = np.asarray(S)
    assert s.shape == (10, 6)
    assert (s[:, 0:3] == 0).all() and (s[:, 3:6] > 0).all()
