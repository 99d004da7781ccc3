"""Disturbance-observer EKF (estimation/disturbance.py).

The reference's only mechanism for unmodelled forces is the learned GP
residual; the augmented-state observer is the classical, learning-free
alternative this framework adds. These tests pin: (a) the disturbance
estimate converges to the true nominal-vs-plant acceleration gap, (b)
feeding it forward to the MPC improves windy tracking, (c) it is harmless
on a matched plant, and (d) gusts and online learning compose with it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from unmanned_aerial_vehicles_tpu.control.mpc_linear import (
    LinearMPC,
    LinearMPCConfig,
)
from unmanned_aerial_vehicles_tpu.estimation import (
    DisturbanceEKFConfig,
    EKFConfig,
    dekf_init,
    dekf_step,
    measure,
    noisy_mpc_flight_rollout,
)
from unmanned_aerial_vehicles_tpu.models import (
    RateLoopParams,
    RigidBodyParams,
    px4_rate_tracking_step,
)
from unmanned_aerial_vehicles_tpu.models.px4_surrogate import _derivative
from unmanned_aerial_vehicles_tpu.trajectories import ramped_figure8_reference

WINDY = RigidBodyParams(wind=(1.5, 0.8, 0.0))   # the campaign's windy plant
NOMINAL = RigidBodyParams()


def _fig8(t):
    pos, yaw = ramped_figure8_reference(t, amplitude=2.0, frequency=0.1)
    return pos + jnp.asarray([0.0, 0.0, 3.0], jnp.float32), yaw


def test_disturbance_estimate_converges():
    """Open loop: truth flies the WINDY plant, the observer predicts with
    the nominal model — d must converge to the true accel gap at the
    current state (the same quantity the campaign's oracle row computes
    analytically)."""
    steps = 600
    rl, dt = RateLoopParams(), 0.02
    cfg = DisturbanceEKFConfig()
    control = jnp.asarray([1.0, 0.0, 0.0, 0.0], jnp.float32)
    x0 = jnp.zeros(12, jnp.float32).at[2].set(3.0)
    keys = jax.random.split(jax.random.PRNGKey(0), steps)

    def step(carry, k):
        s, ekf = carry
        z = measure(s, k, cfg.base)
        ekf, x_est, d_est = dekf_step(ekf, control, z, NOMINAL, rl, dt, cfg)
        s_new = px4_rate_tracking_step(s, control, WINDY, rl, dt)
        return (s_new, ekf), {"true": s, "d": d_est}

    (s_fin, ekf), outs = jax.jit(
        lambda: jax.lax.scan(step, (x0, dekf_init(x0, cfg)), keys)
    )()
    d = np.asarray(outs["d"])
    true = np.asarray(outs["true"])
    # expected disturbance at each tick: windy-minus-nominal accel at the
    # TRUE state under the applied control
    expected = np.asarray(
        jax.vmap(
            lambda s: _derivative(s, control, WINDY, rl)[3:6]
            - _derivative(s, control, NOMINAL, rl)[3:6]
        )(jnp.asarray(true))
    )
    tail = slice(300, None)
    gap = np.linalg.norm(d[tail] - expected[tail], axis=1)
    sig = np.linalg.norm(expected[tail], axis=1).mean()
    assert sig > 0.5, "windy scenario should produce a real accel gap"
    assert gap.mean() < 0.25 * sig, (gap.mean(), sig)
    # covariance stays finite and symmetric
    P = np.asarray(ekf.P)
    assert np.isfinite(P).all()
    np.testing.assert_allclose(P, P.T, atol=1e-5)


def test_disturbance_feedforward_improves_windy_tracking():
    """Closed loop on the campaign's windy figure-8: the observer's
    residual feedforward must recover most of the wind-induced tracking
    loss without any learned model."""
    steps, tail = 1200, 600
    # the campaign flight configuration: default horizon/iterations — a
    # short-horizon MPC has too little position authority for the wind
    # offset to be feedforward-limited in the first place
    mpc = LinearMPC(LinearMPCConfig(), dtype=jnp.float32)

    def ref(t):
        # the campaign's figure-8 shape; preview mode so tracking is not
        # dominated by point-target phase lag (the wind-rejection rows in
        # tools/run_campaign.py fly exactly this configuration)
        pos, yaw = ramped_figure8_reference(t)
        return pos + jnp.asarray([0.0, 0.0, 3.0], jnp.float32), yaw

    def fly(dob):
        return jax.jit(
            lambda: noisy_mpc_flight_rollout(
                mpc, ref, steps, jax.random.PRNGKey(0), body=WINDY,
                preview=True, disturbance_observer=dob,
            )
        )()

    plain, dob = fly(None), fly(True)

    def rms(outs):
        err = np.linalg.norm(
            np.asarray(outs["pos_ref"] - outs["state"][:, 0:3]), axis=1
        )
        return float(np.sqrt((err[tail:] ** 2).mean()))

    r_plain, r_dob = rms(plain), rms(dob)
    assert np.isfinite(np.asarray(dob["state"])).all()
    # the observer must recover at least 35% of the windy tracking error
    # (measured: 0.978 -> 0.491 m on this window)
    assert r_dob < 0.65 * r_plain, (r_dob, r_plain)
    # and the estimate itself points into the wind (nonzero, bounded)
    d = np.asarray(dob["disturbance_est"])
    assert 0.2 < np.linalg.norm(d[tail:], axis=1).mean() < 5.0


def test_disturbance_observer_clean_plant_harmless():
    """Matched plant: d stays near zero and tracking is unchanged."""
    steps = 400
    mpc = LinearMPC(LinearMPCConfig(horizon=10, admm_iterations=40),
                    dtype=jnp.float32)

    def fly(dob):
        return jax.jit(
            lambda: noisy_mpc_flight_rollout(
                mpc, _fig8, steps, jax.random.PRNGKey(0), body=NOMINAL,
                disturbance_observer=dob,
            )
        )()

    plain, dob = fly(None), fly(True)

    def rms(outs):
        err = np.linalg.norm(
            np.asarray(outs["pos_ref"] - outs["state"][:, 0:3]), axis=1
        )
        return float(np.sqrt((err[200:] ** 2).mean()))

    # note: d is NOT exactly zero on a matched plant — the observer also
    # absorbs the surrogate-vs-double-integrator model gap the controller
    # feels (attitude lag during accelerating arcs), which is why the
    # matched-plant comparison allows a small band rather than equality
    assert rms(dob) < rms(plain) + 0.08, (rms(dob), rms(plain))
    d = np.asarray(dob["disturbance_est"])
    assert np.linalg.norm(d[200:], axis=1).mean() < 1.0


def test_gust_observer_tracks_wind_change():
    """Time-varying wind (``wind_fn=``): a step gust mid-flight. A frozen
    model trained on the old wind keeps feeding the old correction; the
    observer must re-converge to the NEW wind within a couple of seconds
    and keep the tracking improvement on the post-gust window."""
    steps = 1200  # 24 s; gust at 12 s
    t_gust = 12.0
    w0 = jnp.asarray([1.5, 0.8, 0.0], jnp.float32)
    w1 = jnp.asarray([-1.0, 1.5, 0.0], jnp.float32)

    def wind_fn(t):
        return jnp.where(t < t_gust, w0, w1)

    mpc = LinearMPC(LinearMPCConfig(), dtype=jnp.float32)

    def ref(t):
        pos, yaw = ramped_figure8_reference(t)
        return pos + jnp.asarray([0.0, 0.0, 3.0], jnp.float32), yaw

    def fly(dob):
        return jax.jit(
            lambda: noisy_mpc_flight_rollout(
                mpc, ref, steps, jax.random.PRNGKey(0), body=WINDY,
                preview=True, disturbance_observer=dob, wind_fn=wind_fn,
            )
        )()

    plain, dob = fly(None), fly(True)
    d = np.asarray(dob["disturbance_est"])

    # d re-converges: the estimate's direction must flip with the wind —
    # compare its x-component sign on the settled pre/post windows
    pre, post = d[400:600].mean(axis=0), d[1000:].mean(axis=0)
    assert pre[0] > 0.3 and post[0] < -0.1, (pre, post)
    # and the settled post-gust estimate matches the TRUE accel gap of the
    # post-gust plant (drag on airspeed is NOT proportional to wind — the
    # principled expectation is the windy-minus-nominal derivative at the
    # flown states under the applied controls)
    windy_post = RigidBodyParams(wind=(-1.0, 1.5, 0.0))
    states = jnp.asarray(np.asarray(dob["state"])[1000:])
    controls = jnp.asarray(np.concatenate(
        [np.asarray(dob["thrust"])[1000:, None],
         np.asarray(dob["rates_cmd"])[1000:]], axis=1))
    rl = RateLoopParams()
    expected = np.asarray(jax.vmap(
        lambda s, u: _derivative(s, u, windy_post, rl)[3:6]
        - _derivative(s, u, NOMINAL, rl)[3:6]
    )(states, controls)).mean(axis=0)
    gap = np.linalg.norm(post - expected)
    assert gap < 0.35 * np.linalg.norm(expected), (post, expected)
    # and the transient is fast: within 2 s of the gust the x-estimate has
    # crossed zero on its way to the new value
    d_trans = d[int(t_gust / 0.02): int((t_gust + 2.0) / 0.02)]
    assert (d_trans[:, 0] < 0).any()

    # tracking on the post-gust window still beats the plain flight
    def rms_post(outs):
        err = np.linalg.norm(
            np.asarray(outs["pos_ref"] - outs["state"][:, 0:3]), axis=1
        )
        return float(np.sqrt((err[800:] ** 2).mean()))

    assert rms_post(dob) < 0.75 * rms_post(plain), (
        rms_post(dob), rms_post(plain)
    )


def test_constant_wind_fn_matches_steady_wind():
    """``wind_fn`` replaces the truth plant's wind per tick: a constant
    ``wind_fn`` must fly exactly the steady-wind flight (same PRNG), with
    and without the observer."""
    w0 = (1.5, 0.8, 0.0)
    mpc = LinearMPC(LinearMPCConfig(horizon=10, admm_iterations=40),
                    dtype=jnp.float32)

    def fly(dob, wind_fn):
        body = RigidBodyParams(wind=w0)
        return jax.jit(lambda: noisy_mpc_flight_rollout(
            mpc, _fig8, 160, jax.random.PRNGKey(0), body=body,
            disturbance_observer=dob, wind_fn=wind_fn,
            nominal_body=NOMINAL if dob else None,
        ))()

    for dob in (None, True):
        steady = fly(dob, None)
        const = fly(dob, lambda t: jnp.asarray(w0, jnp.float32))
        np.testing.assert_array_equal(np.asarray(steady["state"]),
                                      np.asarray(const["state"]))


def test_gust_composes_with_online_learning():
    """Gusts + ONLINE learning: the per-tick wind (wind_fn) composes with
    the ring-buffer GP trained on EKF estimates — the training data keeps
    flowing through the gust, the refits keep firing, and the flight
    stays finite."""
    from unmanned_aerial_vehicles_tpu.gp.residual_gp import ResidualGPConfig
    from unmanned_aerial_vehicles_tpu.loop import OnlineFusedGPConfig

    steps = 192
    w0 = jnp.asarray([1.5, 0.8, 0.0], jnp.float32)
    w1 = jnp.asarray([-1.0, 1.5, 0.0], jnp.float32)
    wind_fn = lambda t: jnp.where(t < 1.6, w0, w1)

    mpc = LinearMPC(LinearMPCConfig(horizon=10, admm_iterations=40),
                    dtype=jnp.float32)
    outs = jax.jit(
        lambda: noisy_mpc_flight_rollout(
            mpc, _fig8, steps, jax.random.PRNGKey(0), body=WINDY,
            wind_fn=wind_fn, gp_gain=1.0,
            online_gp=OnlineFusedGPConfig(
                gp=ResidualGPConfig(max_data_points=32, residual_gain=1.0),
                refit_every=32, min_samples=8,
            ),
        )
    )()
    assert np.isfinite(np.asarray(outs["state"])).all()
    counts = np.asarray(outs["gp_count"])
    # capture keeps running through the gust (tick 80): the ring fills
    assert counts[-1] == 32 and counts[60] > 8, counts[[60, -1]]
    e = np.linalg.norm(
        np.asarray(outs["pos_ref"]) - np.asarray(outs["state"][:, 0:3]),
        axis=1,
    )
    assert np.isfinite(e).all() and e.max() < 10.0


def test_disturbance_observer_direct_rate12():
    """Torque-family observer: the direct-rate engine's traced residual
    input is the feedforward hook (mpc_direct_rates.py:153-190). Truth =
    rate-lag plant + a constant unmodelled acceleration; the augmented
    filter (nominal process model) must estimate it exactly — the
    disturbance IS constant in this plant's derivative space — and the
    feedforward must improve tracking."""
    from unmanned_aerial_vehicles_tpu.control import DirectRateMPC
    from unmanned_aerial_vehicles_tpu.control.mpc_rigid import (
        direct_rate_step,
    )
    from unmanned_aerial_vehicles_tpu.estimation.noisy_loop import (
        noisy_rigid_mpc_rollout,
    )

    steps, dt = 600, 0.02
    d_true = jnp.asarray([0.6, -0.4, 0.3], jnp.float32)
    d_row = jnp.zeros(12, jnp.float32).at[3:6].set(d_true)
    eng = DirectRateMPC()

    def ref(t):
        pos, yaw = ramped_figure8_reference(t, amplitude=2.0, frequency=0.1)
        return pos + jnp.asarray([0.0, 0.0, 3.0], jnp.float32), yaw

    def fly(dob):
        return jax.jit(
            lambda: noisy_rigid_mpc_rollout(
                eng, ref, steps, jax.random.PRNGKey(0), dt=dt,
                plant_step_fn=lambda x, u: direct_rate_step(
                    x, u, d_row, dt=dt),
                process_step_fn=lambda x, u: direct_rate_step(
                    x, u, jnp.zeros(12, jnp.float32), dt=dt),
                yaw_channel=False, disturbance_observer=dob,
            )
        )()

    plain, dob = fly(None), fly(True)

    # the pushed plant's disturbance is EXACTLY constant in derivative
    # space — the settled estimate must land on it
    d = np.asarray(dob["disturbance_est"])
    np.testing.assert_allclose(d[300:].mean(axis=0), np.asarray(d_true),
                               atol=0.08)

    def rms(outs):
        err = np.linalg.norm(
            np.asarray(outs["pos_ref"] - outs["state"][:, 0:3]), axis=1
        )
        return float(np.sqrt((err[300:] ** 2).mean()))

    assert rms(dob) < rms(plain), (rms(dob), rms(plain))

    # the yaw-channel engines have no residual hook: loud error
    from unmanned_aerial_vehicles_tpu.control import RigidBodyMPC

    with pytest.raises(ValueError, match="residual"):
        noisy_rigid_mpc_rollout(
            RigidBodyMPC(), ref, 4, jax.random.PRNGKey(0),
            disturbance_observer=True,
        )


def test_push_step_observer_direct_rate12():
    """The torque family's GUST: the unmodelled force STEPS mid-flight
    (``plant_step_tfn``). The filter's model stays nominal, so the settled
    estimate must land on the PRE-step force, flip, and land on the
    POST-step force — exactly (the force is constant-in-derivative on each
    side of the step)."""
    from unmanned_aerial_vehicles_tpu.control import DirectRateMPC
    from unmanned_aerial_vehicles_tpu.control.mpc_rigid import (
        direct_rate_step,
    )
    from unmanned_aerial_vehicles_tpu.estimation.noisy_loop import (
        noisy_rigid_mpc_rollout,
    )

    steps, dt = 1000, 0.02  # 20 s; step at 10 s
    d_pre = jnp.asarray([0.6, -0.4, 0.3], jnp.float32)
    d_post = jnp.asarray([-0.5, 0.7, -0.2], jnp.float32)
    row_pre = jnp.zeros(12, jnp.float32).at[3:6].set(d_pre)
    row_post = jnp.zeros(12, jnp.float32).at[3:6].set(d_post)
    eng = DirectRateMPC()

    def ref(t):
        pos, yaw = ramped_figure8_reference(t, amplitude=2.0, frequency=0.1)
        return pos + jnp.asarray([0.0, 0.0, 3.0], jnp.float32), yaw

    outs = jax.jit(
        lambda: noisy_rigid_mpc_rollout(
            eng, ref, steps, jax.random.PRNGKey(0), dt=dt,
            plant_step_tfn=lambda x, u, t: direct_rate_step(
                x, u, jnp.where(t < 10.0, row_pre, row_post), dt=dt),
            process_step_fn=lambda x, u: direct_rate_step(
                x, u, jnp.zeros(12, jnp.float32), dt=dt),
            yaw_channel=False, disturbance_observer=True,
        )
    )()
    d = np.asarray(outs["disturbance_est"])
    np.testing.assert_allclose(d[350:500].mean(axis=0), np.asarray(d_pre),
                               atol=0.08)
    np.testing.assert_allclose(d[850:].mean(axis=0), np.asarray(d_post),
                               atol=0.08)

    # guard rails: tfn + fn together, and tfn without an explicit
    # process model, are loud errors
    with pytest.raises(ValueError, match="not both"):
        noisy_rigid_mpc_rollout(
            eng, ref, 4, jax.random.PRNGKey(0), dt=dt,
            plant_step_fn=lambda x, u: x,
            plant_step_tfn=lambda x, u, t: x,
            process_step_fn=lambda x, u: x, yaw_channel=False,
        )
    with pytest.raises(ValueError, match="process_step_fn"):
        noisy_rigid_mpc_rollout(
            eng, ref, 4, jax.random.PRNGKey(0), dt=dt,
            plant_step_tfn=lambda x, u, t: x, yaw_channel=False,
        )


def test_disturbance_observer_ltv12_multirate():
    """LTV tier observer: the 15-state filter fuses at the 100 Hz sensor
    rate over the NOMINAL model while the true plant flies a windy GZ
    quadrotor; the 10 Hz LTV solve receives the estimate through its
    traced residual rows (mpc_controller.py:144's GP hook). Must beat the
    plain noisy LTV flight on the same windy plant."""
    from unmanned_aerial_vehicles_tpu.control import LTVTrackingMPC
    from unmanned_aerial_vehicles_tpu.estimation.noisy_loop import (
        noisy_ltv_rollout,
    )
    from unmanned_aerial_vehicles_tpu.models import GZ_QUADROTOR_PARAMS
    from unmanned_aerial_vehicles_tpu.trajectories import (
        ramped_circle_reference,
    )

    ldt = 0.1
    mpc_ltv = LTVTrackingMPC(horizon=10)
    n = mpc_ltv.mpc.config.horizon
    windy = GZ_QUADROTOR_PARAMS.replace(wind=(2.5, 1.5, 0.0))

    def window_at(i):
        ts = (i + jnp.arange(n + 1)).astype(jnp.float32) * ldt

        def ref12(t):
            pos, _, _ = ramped_circle_reference(t, amplitude=1.5, height=3.0)
            return jnp.concatenate(
                [jnp.asarray(pos, jnp.float32), jnp.zeros(9, jnp.float32)]
            )

        return jax.vmap(ref12)(ts)

    def fly(dob):
        return jax.jit(lambda: noisy_ltv_rollout(
            mpc_ltv, window_at, 60, jax.random.PRNGKey(5), body=windy,
            disturbance_observer=dob,
        ))()

    plain, dob = fly(None), fly(True)

    def rms(outs):
        st = np.asarray(outs["state"])[30:, 0:3]
        ref = np.asarray(outs["pos_ref"])[30:]
        return float(np.sqrt(np.mean(np.sum((st - ref) ** 2, -1))))

    r_plain, r_dob = rms(plain), rms(dob)
    assert np.isfinite(np.asarray(dob["state"])).all()
    assert r_dob < r_plain, (r_dob, r_plain)
    # the settled estimate points into the wind
    d = np.asarray(dob["disturbance_est"])[30:].mean(axis=0)
    assert d[0] > 0.0 and d[1] > 0.0, d


def test_disturbance_config_passes_base_noise_model():
    """An explicit DisturbanceEKFConfig's base drives the sensor draws."""
    steps = 60
    mpc = LinearMPC(LinearMPCConfig(horizon=10, admm_iterations=40),
                    dtype=jnp.float32)
    loud = DisturbanceEKFConfig(base=EKFConfig(r_pos=1.0))
    outs = jax.jit(
        lambda: noisy_mpc_flight_rollout(
            mpc, _fig8, steps, jax.random.PRNGKey(0), body=NOMINAL,
            disturbance_observer=loud,
        )
    )()
    meas_err = np.linalg.norm(
        np.asarray(outs["meas_pos"] - outs["state"][:, 0:3]), axis=1
    )
    # r_pos=1.0 must show up in the drawn measurements (default is 0.05)
    assert meas_err.mean() > 0.5
