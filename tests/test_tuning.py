"""Differentiable closed-loop auto-tuning (tuning.autotune).

The reference has no counterpart (gains are hand-tuned,
``cascade_pid_demo.py:194-210``); these tests pin that the gradient path
through the flight rollouts is real: losses drop, tuned controllers
track better than their initialisations, and the traced-weight MPC twin
matches the deployment controller.
"""

import jax
import jax.numpy as jnp
import numpy as np

from unmanned_aerial_vehicles_tpu.control.mpc_linear import (
    LinearMPC,
    LinearMPCConfig,
)
from unmanned_aerial_vehicles_tpu.loop import FlightLoopConfig
from unmanned_aerial_vehicles_tpu.loop.closed_loop import (
    mpc_flight_rollout,
    pid_flight_rollout,
)
from unmanned_aerial_vehicles_tpu.trajectories import ramped_circle_reference
from unmanned_aerial_vehicles_tpu.tuning import (
    TuneConfig,
    mpc_config_from_theta,
    mpc_weights_theta,
    tune_cascade_gains,
    tune_cascade_gains_multistart,
    tune_mpc_weights,
    tune_parameters,
)
from unmanned_aerial_vehicles_tpu.tuning.autotune import _TracedWeightMPC


def _circle(t):
    pos, _, yaw = ramped_circle_reference(t, amplitude=2.0, height=3.0)
    return pos, yaw


def _rms(outs):
    err = np.asarray(outs["state"][:, 0:3]) - np.asarray(outs["pos_ref"])
    return float(np.sqrt((np.linalg.norm(err, axis=1) ** 2).mean()))


def test_tune_parameters_quadratic():
    target = jnp.asarray([1.0, -2.0, 0.5], jnp.float32)

    def loss(p):
        return jnp.sum((p["x"] - target) ** 2)

    params, losses, final_loss = tune_parameters(
        loss, {"x": jnp.zeros(3, jnp.float32)}, iterations=400,
        learning_rate=0.05,
    )
    assert float(final_loss) < 1e-4
    assert float(losses[-1]) < float(losses[0])
    np.testing.assert_allclose(np.asarray(params["x"]), np.asarray(target),
                               atol=1e-2)


def test_tune_cascade_gains_improves_tracking():
    steps = 250
    cfg = TuneConfig(iterations=12, learning_rate=0.08, settle_steps=50,
                     effort_weight=1e-3)
    result = tune_cascade_gains(_circle, steps, tune_cfg=cfg)

    assert np.isfinite(np.asarray(result.losses)).all()
    assert float(result.final_loss) < float(result.initial_loss)

    # re-fly both gain sets: the tuned cascade must track the circle better
    base = jax.jit(lambda: pid_flight_rollout(_circle, steps))()
    tuned = jax.jit(
        lambda: pid_flight_rollout(_circle, steps, gains=result.params)
    )()
    assert _rms(tuned) < _rms(base)

    # positivity (log-space parametrisation) and untouched safety limits
    for layer in ("position", "velocity", "attitude"):
        pid = getattr(result.params, layer)
        assert (np.asarray(pid.kp) > 0).all()
        assert (np.asarray(pid.ki) > 0).all()
        assert (np.asarray(pid.kd) > 0).all()
        ref_pid = getattr(
            type(result.params).default(), layer
        )
        np.testing.assert_array_equal(
            np.asarray(pid.max_output, np.float32),
            np.asarray(ref_pid.max_output, np.float32),
        )


def test_tune_cascade_gains_multistart_picks_best():
    steps = 150
    cfg = TuneConfig(iterations=4, learning_rate=0.08, settle_steps=40)
    result = tune_cascade_gains_multistart(
        _circle, steps, n_starts=3, jitter=0.2, tune_cfg=cfg
    )
    assert np.isfinite(float(result.final_loss))
    # the best-of-starts final loss can never exceed the unjittered start's
    # own tuned loss trace minimum
    single = tune_cascade_gains(_circle, steps, tune_cfg=cfg)
    assert float(result.final_loss) <= float(single.final_loss) + 1e-6


def test_traced_weight_mpc_matches_linear_mpc():
    base = LinearMPCConfig(horizon=8, admm_iterations=200)
    ref = LinearMPC(base, dtype=jnp.float32)
    twin = _TracedWeightMPC(mpc_weights_theta(base), base)

    state = jnp.asarray([1.0, -2.0, 2.0, 0.5, 0.0, -0.1], jnp.float32)
    target = jnp.asarray([0.0, 0.0, 3.0], jnp.float32)
    ca, cb = ref.init_carry(state), twin.init_carry(state)
    for _ in range(3):
        ua, Xa, ca = jax.jit(ref.solve)(ca, state, target)
        ub, Xb, cb = jax.jit(twin.solve)(cb, state, target)
    np.testing.assert_allclose(np.asarray(ua), np.asarray(ub), atol=5e-4)
    np.testing.assert_allclose(np.asarray(Xa), np.asarray(Xb), atol=5e-4)


def test_tune_mpc_weights_improves_tracking():
    steps = 150
    base = LinearMPCConfig(horizon=8, admm_iterations=30)
    # start from a deliberately detuned weight set
    detuned = base.replace(q_pos=(5.0, 5.0, 8.0), r_control=(20.0, 20.0, 10.0, 8.0))
    cfg = TuneConfig(iterations=6, learning_rate=0.15, settle_steps=40)
    result, tuned_config = tune_mpc_weights(
        _circle, steps, base_config=detuned, tune_cfg=cfg,
    )
    assert float(result.final_loss) < float(result.initial_loss)

    # the tuned config must drop into the DEPLOYMENT controller and beat
    # the detuned deployment flight
    loop_cfg = FlightLoopConfig()
    fly = lambda c: jax.jit(
        lambda: mpc_flight_rollout(
            LinearMPC(c, dtype=jnp.float32), _circle, steps, cfg=loop_cfg
        )
    )()
    assert _rms(fly(tuned_config)) < _rms(fly(detuned))
    # tuned weights are plain host floats (jit-static config)
    assert isinstance(tuned_config.q_pos[0], float)


# ---------------------------------------------------------------------------
# The gradient the tuner follows
# ---------------------------------------------------------------------------


def test_mpc_weight_gradient_matches_finite_difference():
    """jax.grad of the campaign loss through the whole closed loop (QP
    solver included) agrees with a central finite difference along one
    weight direction."""
    from unmanned_aerial_vehicles_tpu.tuning.autotune import _tracking_loss

    base = LinearMPCConfig(horizon=6)
    steps = 12

    def loss(theta):
        mpc = _TracedWeightMPC(theta, base)
        outs = mpc_flight_rollout(mpc, _circle, steps)
        return _tracking_loss(outs, 2, 1e-3)

    theta0 = mpc_weights_theta(base)
    g = jax.jit(jax.grad(loss))(theta0)
    eps = 1e-2
    shift = lambda sgn: {
        k: (v + sgn * eps if k == "log_q_pos" else v) for k, v in theta0.items()
    }
    f = jax.jit(loss)
    fd = (float(f(shift(1.0))) - float(f(shift(-1.0)))) / (2 * eps)
    analytic = float(jnp.sum(g["log_q_pos"]))
    assert np.isfinite(analytic) and abs(analytic) > 0
    np.testing.assert_allclose(analytic, fd, rtol=5e-2)
