"""12-state EKF + noisy-sensor closed loop (estimation/).

The reference consumes PX4-EKF2 output and never runs an estimator of its
own; these tests pin the in-graph replacement: the filter beats the raw
sensors, covariance stays bounded/symmetric, yaw innovations wrap, and a
full sensors->EKF->MPC->plant flight tracks close to the perfect-state
loop.
"""

import jax
import jax.numpy as jnp
import numpy as np

from unmanned_aerial_vehicles_tpu.control.mpc_linear import (
    LinearMPC,
    LinearMPCConfig,
)
from unmanned_aerial_vehicles_tpu.estimation import (
    EKFConfig,
    ekf_init,
    ekf_step,
    measure,
    noisy_mpc_flight_rollout,
)
from unmanned_aerial_vehicles_tpu.loop import mpc_flight_rollout
from unmanned_aerial_vehicles_tpu.models import (
    RateLoopParams,
    RigidBodyParams,
    px4_rate_tracking_step,
)
from unmanned_aerial_vehicles_tpu.trajectories import ramped_circle_reference


def _circle(t):
    pos, _, yaw = ramped_circle_reference(t, amplitude=2.0, height=3.0)
    return pos, yaw


def _run_filter(steps=400, seed=0, control=None, x0=None):
    """True plant + noisy sensors + EKF, open loop (constant command)."""
    cfg = EKFConfig()
    body, rl, dt = RigidBodyParams(), RateLoopParams(), 0.02
    control = (
        jnp.asarray([1.0, 0.05, -0.03, 0.02], jnp.float32)
        if control is None else control
    )
    if x0 is None:
        x0 = jnp.zeros(12, jnp.float32).at[2].set(3.0)
    keys = jax.random.split(jax.random.PRNGKey(seed), steps)

    def step(carry, k):
        s, ekf = carry
        z = measure(s, k, cfg)
        ekf, x_est = ekf_step(ekf, control, z, body, rl, dt, cfg)
        s_new = px4_rate_tracking_step(s, control, body, rl, dt)
        return (s_new, ekf), {"true": s, "est": x_est, "z": z}

    # start the estimate OFF the truth to exercise convergence
    ekf0 = ekf_init(x0 + 0.2, cfg)
    (s, ekf), outs = jax.jit(
        lambda: jax.lax.scan(step, (x0, ekf0), keys)
    )()
    return {k: np.asarray(v) for k, v in outs.items()}, np.asarray(ekf.P)


def test_ekf_beats_raw_measurements():
    outs, P = _run_filter()
    tail = slice(100, None)   # post-transient
    est_err = np.linalg.norm(outs["est"][tail, 0:3] - outs["true"][tail, 0:3],
                             axis=1)
    meas_err = np.linalg.norm(outs["z"][tail, 0:3] - outs["true"][tail, 0:3],
                              axis=1)
    assert est_err.mean() < 0.6 * meas_err.mean(), (
        est_err.mean(), meas_err.mean(),
    )
    # unmeasured velocities are reconstructed to useful accuracy
    vel_err = np.linalg.norm(outs["est"][tail, 3:6] - outs["true"][tail, 3:6],
                             axis=1)
    assert vel_err.mean() < 0.15


def test_ekf_covariance_bounded_symmetric():
    _, P = _run_filter(steps=300)
    assert np.allclose(P, P.T, atol=1e-6)
    eigs = np.linalg.eigvalsh(P.astype(np.float64))
    assert eigs.min() > 0.0
    assert eigs.max() < 1.0   # converged, not blown up


def test_ekf_yaw_wrap():
    """An estimate just below +pi fusing measurements just above -pi must
    not traverse the whole circle."""
    cfg = EKFConfig()
    body, rl, dt = RigidBodyParams(), RateLoopParams(), 0.02
    x_true = jnp.zeros(12, jnp.float32).at[2].set(3.0).at[8].set(jnp.pi - 0.02)
    control = jnp.asarray([1.0, 0.0, 0.0, 0.0], jnp.float32)
    ekf = ekf_init(x_true, cfg)
    # measurement with yaw wrapped past the seam
    z = jnp.asarray(np.concatenate([
        np.asarray(x_true[0:3]),
        [0.0, 0.0, -np.pi + 0.02],
        np.asarray(x_true[9:12]),
    ]), jnp.float32)
    ekf, x_est = jax.jit(
        lambda e, zz: ekf_step(e, control, zz, body, rl, dt, cfg)
    )(ekf, z)
    # the fused yaw stays near the seam (magnitude ~pi), not near 0
    assert abs(abs(float(x_est[8])) - np.pi) < 0.1


def test_noisy_closed_loop_tracks():
    steps = 500
    mpc = LinearMPC(LinearMPCConfig(horizon=10, admm_iterations=40),
                    dtype=jnp.float32)
    ideal = jax.jit(lambda: mpc_flight_rollout(mpc, _circle, steps))()
    noisy = jax.jit(
        lambda: noisy_mpc_flight_rollout(
            mpc, _circle, steps, jax.random.PRNGKey(0)
        )
    )()

    def rms(outs):
        err = np.linalg.norm(
            np.asarray(outs["pos_ref"] - outs["state"][:, 0:3]), axis=1
        )
        return float(np.sqrt((err[100:] ** 2).mean()))

    r_ideal, r_noisy = rms(ideal), rms(noisy)
    assert np.isfinite(np.asarray(noisy["state"])).all()
    # estimator-in-the-loop costs little tracking accuracy
    assert r_noisy < r_ideal + 0.15, (r_noisy, r_ideal)
    # the estimate follows the truth
    est_err = np.linalg.norm(
        np.asarray(noisy["state_est"][:, 0:3] - noisy["state"][:, 0:3]),
        axis=1,
    )
    assert est_err[100:].mean() < 0.05
    assert np.isfinite(np.asarray(noisy["final_covariance"])).all()


def test_noisy_fallback_watches_the_estimate():
    """The divergence fallback on the noisy loop triggers on the ESTIMATED
    position error (the controller never sees the truth): a tight
    threshold must engage it and change the flight, and the loop stays
    healthy."""
    from unmanned_aerial_vehicles_tpu.loop import FlightLoopConfig

    mpc = LinearMPC(LinearMPCConfig(horizon=10, admm_iterations=40),
                    dtype=jnp.float32)
    runs = {
        thr: jax.jit(lambda thr=thr: noisy_mpc_flight_rollout(
            mpc, _circle, 200, jax.random.PRNGKey(0),
            cfg=FlightLoopConfig(fallback_error_m=thr),
        ))()
        for thr in (0.0, 0.05)
    }
    assert all(np.isfinite(np.asarray(o["state"])).all() for o in runs.values())
    gap = np.abs(np.asarray(runs[0.0]["state"]) - np.asarray(runs[0.05]["state"]))
    assert gap.max() > 1e-3


def test_noisy_loop_matches_ideal_with_clean_sensors():
    """Pin against divergence between noisy_mpc_flight_rollout's step and
    the staged mpc_flight_rollout it mirrors (loop/closed_loop.py): with
    near-noiseless sensors the two must fly the same trajectory."""
    steps = 300
    clean = EKFConfig(r_pos=1e-4, r_att=1e-4, r_rate=1e-4,
                      p0_pos=1e-3, p0_vel=1e-3, p0_att=1e-3, p0_rate=1e-3)
    mpc = LinearMPC(LinearMPCConfig(horizon=10, admm_iterations=40),
                    dtype=jnp.float32)
    ideal = jax.jit(lambda: mpc_flight_rollout(mpc, _circle, steps))()
    noisy = jax.jit(
        lambda: noisy_mpc_flight_rollout(
            mpc, _circle, steps, jax.random.PRNGKey(0), ekf_cfg=clean
        )
    )()
    gap = np.abs(
        np.asarray(ideal["state"][:, 0:3]) - np.asarray(noisy["state"][:, 0:3])
    ).max()
    assert gap < 0.02, gap


def _small_posterior():
    from unmanned_aerial_vehicles_tpu.gp import fit_residual_gp
    from unmanned_aerial_vehicles_tpu.gp.residual_gp import ResidualGPConfig

    rng = np.random.default_rng(0)
    X = jnp.asarray(rng.normal(size=(64, 10)), jnp.float32)
    Y = jnp.asarray(0.05 * rng.normal(size=(64, 6)), jnp.float32)
    gcfg = ResidualGPConfig()
    return fit_residual_gp(X, Y, gcfg), gcfg


def test_noisy_gp_posterior_preview_matches_residual_fn():
    """EKF + GP residuals (features from the ESTIMATE trajectory) + preview:
    ``gp_posterior=`` must fly exactly what the explicit ``residual_fn``
    hook flies on the same PRNG stream."""
    from unmanned_aerial_vehicles_tpu.gp import build_horizon_residuals

    post, gcfg = _small_posterior()
    rf = lambda Xg, Ug: build_horizon_residuals(post, Xg, Ug, gcfg)
    mpc = LinearMPC(LinearMPCConfig(horizon=10, admm_iterations=40),
                    dtype=jnp.float32)
    hooks = jax.jit(lambda: noisy_mpc_flight_rollout(
        mpc, _circle, 240, jax.random.PRNGKey(0), residual_fn=rf,
        preview=True,
    ))()
    ours = jax.jit(lambda: noisy_mpc_flight_rollout(
        mpc, _circle, 240, jax.random.PRNGKey(0), gp_posterior=post,
        gp_gain=gcfg.residual_gain, preview=True,
    ))()
    np.testing.assert_array_equal(np.asarray(hooks["state"]),
                                  np.asarray(ours["state"]))


def test_noisy_dob_estimates_wind():
    """The 15-state disturbance observer on the noisy loop: the filter
    predicts with the NOMINAL plant while the truth flies in wind; the
    settled estimate carries the along-wind acceleration gap and the
    augmented covariance stays finite."""
    from unmanned_aerial_vehicles_tpu.models.params import RigidBodyParams

    steps = 240
    body = RigidBodyParams().replace(wind=(1.5, 0.8, 0.0))
    outs = jax.jit(lambda: noisy_mpc_flight_rollout(
        LinearMPC(LinearMPCConfig(horizon=10, admm_iterations=40),
                  dtype=jnp.float32),
        _circle, steps, jax.random.PRNGKey(0), body=body,
        disturbance_observer=True,
    ))()
    d_tail = np.asarray(outs["disturbance_est"])[steps // 2:].mean(axis=0)
    assert d_tail[0] > 0.5, d_tail
    P = np.asarray(outs["final_covariance"])
    assert P.shape == (15, 15)
    assert np.isfinite(P).all()


def test_noisy_dob_composes_with_gp_posterior():
    """Observer + GP must SUM on the residual rows: ``gp_posterior=`` plus
    the observer flies exactly what ``residual_fn`` plus the observer
    flies, and differs from the observer alone."""
    from unmanned_aerial_vehicles_tpu.gp import build_horizon_residuals
    from unmanned_aerial_vehicles_tpu.models.params import RigidBodyParams

    post, gcfg = _small_posterior()
    rf = lambda Xg, Ug: build_horizon_residuals(post, Xg, Ug, gcfg)
    steps = 120
    body = RigidBodyParams().replace(wind=(1.5, 0.8, 0.0))
    mpc = LinearMPC(LinearMPCConfig(horizon=10, admm_iterations=40),
                    dtype=jnp.float32)
    fly = lambda **kw: jax.jit(lambda: noisy_mpc_flight_rollout(
        mpc, _circle, steps, jax.random.PRNGKey(0), body=body,
        disturbance_observer=True, **kw,
    ))()
    hooks = fly(residual_fn=rf)
    ours = fly(gp_posterior=post, gp_gain=gcfg.residual_gain)
    alone = fly()
    np.testing.assert_array_equal(np.asarray(hooks["state"]),
                                  np.asarray(ours["state"]))
    assert np.abs(np.asarray(alone["state"]) - np.asarray(ours["state"])).max() > 0


# ---------------------------------------------------------------------------
# 12-state family noisy loop (rigid-body EKF, noisy_rigid_mpc_rollout)
# ---------------------------------------------------------------------------


def _rigid_truth_flight(eng, steps, dt=0.02):
    """Per-tick truth-state loop (the cli fly12 shape) for comparison."""
    from unmanned_aerial_vehicles_tpu.models import (
        X500_PARAMS,
        rigid_body_rk4_step,
    )

    def step(c, i):
        st, mc = c
        t = i.astype(jnp.float32) * dt
        pos_ref, yaw_ref = _circle(t)
        u, _, mc = eng.solve(mc, st, jnp.asarray(pos_ref, jnp.float32),
                             jnp.asarray(yaw_ref, jnp.float32))
        st = rigid_body_rk4_step(st, u, X500_PARAMS, dt)
        return (st, mc), {"state": st, "pos_ref": pos_ref}

    x0 = jnp.zeros(12, jnp.float32).at[2].set(3.0)
    (_, _), outs = jax.lax.scan(step, (x0, eng.init_carry(x0)),
                                jnp.arange(steps))
    return outs


def test_noisy_rigid_clean_sensors_matches_truth_flight():
    """With near-noiseless sensors the 12-state noisy loop must fly the
    truth-state per-tick loop's trajectory (pins the loop structure: same
    solve semantics, EKF collapses onto the measurement)."""
    from unmanned_aerial_vehicles_tpu.control.mpc_rigid import RigidBodyMPC
    from unmanned_aerial_vehicles_tpu.estimation.noisy_loop import (
        noisy_rigid_mpc_rollout,
    )

    steps = 120
    eng = RigidBodyMPC()
    clean = EKFConfig(r_pos=1e-4, r_att=1e-4, r_rate=1e-4,
                      p0_pos=1e-3, p0_vel=1e-3, p0_att=1e-3, p0_rate=1e-3)
    truth = jax.jit(lambda: _rigid_truth_flight(eng, steps))()
    noisy = jax.jit(lambda: noisy_rigid_mpc_rollout(
        eng, _circle, steps, jax.random.PRNGKey(0), ekf_cfg=clean
    ))()
    gap = np.abs(np.asarray(truth["state"][:, 0:3])
                 - np.asarray(noisy["state"][:, 0:3])).max()
    assert gap < 0.03, gap


def test_noisy_rigid_filter_beats_raw_sensors():
    """At the default sensor noise the EKF's position estimate must be
    closer to the truth than the raw measurements (the filter earns its
    place), velocity (unmeasured) must be reconstructed to the same grade,
    and the flight must still track."""
    from unmanned_aerial_vehicles_tpu.control.mpc_rigid import RigidBodyMPC
    from unmanned_aerial_vehicles_tpu.estimation.noisy_loop import (
        noisy_rigid_mpc_rollout,
    )

    steps = 240
    eng = RigidBodyMPC()
    cfg = EKFConfig()
    outs = jax.jit(lambda: noisy_rigid_mpc_rollout(
        eng, _circle, steps, jax.random.PRNGKey(3), ekf_cfg=cfg
    ))()
    st = np.asarray(outs["state"])
    est = np.asarray(outs["state_est"])
    meas = np.asarray(outs["meas_pos"])
    assert np.isfinite(st).all() and np.isfinite(est).all()

    skip = 40  # transient: P converges from p0
    est_err = np.sqrt(np.mean(np.sum(
        (est[skip:, 0:3] - st[skip:, 0:3]) ** 2, -1)))
    meas_err = np.sqrt(np.mean(np.sum(
        (meas[skip:] - st[skip:, 0:3]) ** 2, -1)))
    assert est_err < meas_err, (est_err, meas_err)

    vel_err = np.sqrt(np.mean(np.sum(
        (est[skip:, 3:6] - st[skip:, 3:6]) ** 2, -1)))
    assert vel_err < 0.2, vel_err

    refs = np.asarray(outs["pos_ref"])
    rms = float(np.sqrt(np.mean(np.sum((st[:, 0:3] - refs) ** 2, -1))))
    truth = jax.jit(lambda: _rigid_truth_flight(eng, steps))()
    rms_truth = float(np.sqrt(np.mean(np.sum(
        (np.asarray(truth["state"][:, 0:3])
         - np.asarray(truth["pos_ref"])) ** 2, -1))))
    # estimator-induced degradation is bounded
    assert rms < rms_truth + 0.1, (rms, rms_truth)


def test_noisy_rigid_family_surface():
    """The same loop flies every yaw-channel 12-state engine (iLQR, MPPI)
    — the shared solve(carry, x, pos, yaw) surface the CLI routes."""
    from unmanned_aerial_vehicles_tpu.control import (
        ILQRRigidBodyMPC,
        MPPIConfig,
        MPPIController,
    )
    from unmanned_aerial_vehicles_tpu.estimation.noisy_loop import (
        noisy_rigid_mpc_rollout,
    )

    steps = 40
    for eng in (ILQRRigidBodyMPC(iterations=1),
                MPPIController(MPPIConfig(horizon=10, num_samples=128))):
        outs = jax.jit(lambda e=eng: noisy_rigid_mpc_rollout(
            e, _circle, steps, jax.random.PRNGKey(1)
        ))()
        st = np.asarray(outs["state"])
        assert np.isfinite(st).all()
        assert abs(st[-1, 2] - 3.0) < 1.5  # holds altitude


def test_noisy_ltv_multirate_estimator_in_the_loop():
    """ltv12's estimation tier: plant + rigid-body EKF at 100 Hz, the LTV
    solve every 10th plant tick flying the ESTIMATE (the reference's
    100 Hz plant / 10 Hz cvxpy rate split, main.py:814-826, with the
    PX4-EKF2 role in-graph). Pins: finite flight, the filter beats the
    raw position sensor, and tracking stays close to the reference
    circle."""
    from unmanned_aerial_vehicles_tpu.control import LTVTrackingMPC
    from unmanned_aerial_vehicles_tpu.estimation.noisy_loop import (
        noisy_ltv_rollout,
    )

    ldt = 0.1
    mpc_ltv = LTVTrackingMPC(horizon=10)
    n = mpc_ltv.mpc.config.horizon

    def window_at(i):
        ts = (i + jnp.arange(n + 1)).astype(jnp.float32) * ldt

        def ref12(t):
            pos, _, _ = ramped_circle_reference(t, amplitude=1.5, height=3.0)
            return jnp.concatenate(
                [jnp.asarray(pos, jnp.float32), jnp.zeros(9, jnp.float32)]
            )

        return jax.vmap(ref12)(ts)

    steps10 = 16
    outs = jax.jit(lambda: noisy_ltv_rollout(
        mpc_ltv, window_at, steps10, jax.random.PRNGKey(5)
    ))()
    st = np.asarray(outs["state"])
    est = np.asarray(outs["state_est"])
    meas = np.asarray(outs["meas_pos"])
    assert np.isfinite(st).all() and np.isfinite(est).all()

    # meas_pos[i] samples the END of tick i == start of tick i+1
    skip = 4  # transient: P converges from p0
    est_err = np.sqrt(np.mean(np.sum(
        (est[skip + 1:, 0:3] - st[skip + 1:, 0:3]) ** 2, -1)))
    meas_err = np.sqrt(np.mean(np.sum(
        (meas[skip:-1] - st[skip + 1:, 0:3]) ** 2, -1)))
    assert est_err < meas_err, (est_err, meas_err)

    ref_pos = np.asarray(outs["pos_ref"])
    rms = np.sqrt(np.mean(np.sum((st[:, 0:3] - ref_pos) ** 2, -1)))
    assert rms < 0.3, rms
