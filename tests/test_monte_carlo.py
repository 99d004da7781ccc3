"""Monte-Carlo robustness harness (loop.monte_carlo) + plant wind model.

No reference counterpart (the reference evaluates one nominal plant per run,
``main.py:417-541``); these tests pin the dispersion machinery: zero jitter
reproduces the nominal flight exactly, wind degrades tracking through the
airspeed-drag term, and crash classification reacts to absurd dispersions.
"""

import jax
import jax.numpy as jnp
import numpy as np

from unmanned_aerial_vehicles_tpu.loop import (
    FlightLoopConfig,
    MonteCarloConfig,
    monte_carlo_mpc,
    monte_carlo_pid,
    pid_flight_rollout,
    sample_conditions,
)
from unmanned_aerial_vehicles_tpu.control.mpc_linear import (
    LinearMPC,
    LinearMPCConfig,
)
from unmanned_aerial_vehicles_tpu.models import (
    RigidBodyParams,
    RateLoopParams,
    px4_rate_tracking_step,
)
from unmanned_aerial_vehicles_tpu.models.rigid_body import rigid_body_derivative
from unmanned_aerial_vehicles_tpu.trajectories import ramped_circle_reference

ZERO_JITTER = MonteCarloConfig(
    n_rollouts=3, mass_jitter_pct=0.0, drag_jitter_pct=0.0,
    tau_jitter_pct=0.0, hover_thrust_jitter_pct=0.0, wind_std=0.0,
    initial_pos_std=0.0, initial_vel_std=0.0, settle_steps=20,
)


def _circle(t):
    pos, _, yaw = ramped_circle_reference(t, amplitude=2.0, height=3.0)
    return pos, yaw


def test_zero_wind_matches_legacy_drag():
    """wind=(0,0,0) must reproduce the pre-wind plant bit-for-bit."""
    body = RigidBodyParams()
    state = jnp.asarray(
        [1.0, -2.0, 3.0, 0.5, -0.3, 0.2, 0.05, -0.02, 0.3, 0.1, 0.0, -0.1],
        jnp.float32,
    )
    control = jnp.asarray([0.9, 0.1, -0.1, 0.05], jnp.float32)
    d = rigid_body_derivative(state, control, body)
    # hand-computed legacy drag on ground velocity
    vel = np.asarray(state[3:6])
    drag = -body.k_drag_linear * np.linalg.norm(vel) * vel
    accel_drag_part = np.asarray(d[3:6], np.float64)
    # remove thrust/gravity: recompute with k_drag=0 and difference
    d0 = rigid_body_derivative(
        state, control, body.replace(k_drag_linear=0.0)
    )
    np.testing.assert_allclose(
        accel_drag_part - np.asarray(d0[3:6], np.float64),
        drag / body.mass, rtol=1e-5,
    )


def test_headwind_adds_drag_at_rest():
    """At rest in wind, drag pushes the vehicle downwind (airspeed model)."""
    body = RigidBodyParams(wind=(2.0, 0.0, 0.0))
    state = jnp.zeros(12, jnp.float32).at[2].set(3.0)
    hover = jnp.asarray([1.0, 0.0, 0.0, 0.0], jnp.float32)
    d = px4_rate_tracking_step(
        state, hover, body, RateLoopParams(), 0.01
    )
    assert float(d[3]) > 0.0  # accelerates with the +x wind
    # zero wind: no lateral acceleration at rest
    d0 = px4_rate_tracking_step(
        state, hover, RigidBodyParams(), RateLoopParams(), 0.01
    )
    assert abs(float(d0[3])) < 1e-9


def test_sample_conditions_batches_all_leaves():
    mc = MonteCarloConfig(n_rollouts=5)
    bodies, rate_loops, x0 = sample_conditions(jax.random.PRNGKey(0), mc)
    assert x0.shape == (5, 12)
    for leaf in jax.tree_util.tree_leaves(bodies):
        assert jnp.shape(leaf)[0] == 5
    for leaf in jax.tree_util.tree_leaves(rate_loops):
        assert jnp.shape(leaf)[0] == 5
    # dispersion is real: masses differ across rollouts
    assert float(jnp.std(bodies.mass)) > 0.0


def test_zero_jitter_reproduces_nominal_flight():
    steps = 100
    stats = jax.jit(
        lambda: monte_carlo_pid(_circle, steps, mc=ZERO_JITTER)
    )()
    nominal = jax.jit(lambda: pid_flight_rollout(_circle, steps))()
    err = np.linalg.norm(
        np.asarray(nominal["state"][:, 0:3]) - np.asarray(nominal["pos_ref"]),
        axis=1,
    )
    rms_nom = float(np.sqrt((err[20:] ** 2).mean()))
    rms_mc = np.asarray(stats["rms_pos"])
    np.testing.assert_allclose(rms_mc, rms_nom, rtol=1e-5)
    assert float(stats["success_rate"]) == 1.0


def test_wind_degrades_tracking_and_stats_ordered():
    steps = 150
    calm = MonteCarloConfig(
        n_rollouts=4, mass_jitter_pct=0.0, drag_jitter_pct=0.0,
        tau_jitter_pct=0.0, hover_thrust_jitter_pct=0.0, wind_std=0.0,
        initial_pos_std=0.0, initial_vel_std=0.0, settle_steps=30,
    )
    windy = calm.replace(wind_std=3.0)
    mpc = LinearMPC(LinearMPCConfig(horizon=10, admm_iterations=40),
                    dtype=jnp.float32)
    s_calm = jax.jit(lambda: monte_carlo_mpc(mpc, _circle, steps, mc=calm))()
    s_windy = jax.jit(lambda: monte_carlo_mpc(mpc, _circle, steps, mc=windy))()
    assert float(s_windy["rms_mean"]) > float(s_calm["rms_mean"])
    # quantiles are ordered
    assert (
        float(s_windy["rms_p50"])
        <= float(s_windy["rms_p90"]) + 1e-9
    )
    assert (
        float(s_windy["rms_p90"])
        <= float(s_windy["rms_p99"]) + 1e-9
    )


def test_crash_classification():
    steps = 150
    absurd = MonteCarloConfig(
        n_rollouts=8, wind_std=60.0, settle_steps=30, crash_error_m=5.0,
    )
    stats = jax.jit(lambda: monte_carlo_pid(_circle, steps, mc=absurd))()
    assert float(stats["success_rate"]) < 1.0
    # stats stay finite even with crashed members
    assert np.isfinite(float(stats["rms_p50"])) or float(
        stats["success_rate"]
    ) == 0.0


def test_monte_carlo_mpc_matches_member_flights():
    """The population study vmaps the same flight the per-member rollout
    flies: each member's RMS must equal a single ``mpc_flight_rollout`` on
    that member's sampled plant and start."""
    from unmanned_aerial_vehicles_tpu.loop import mpc_flight_rollout

    steps = 120
    mc = MonteCarloConfig(n_rollouts=4, settle_steps=30, wind_std=0.5)
    mpc = LinearMPC(LinearMPCConfig(horizon=5, admm_iterations=20),
                    dtype=jnp.float32)
    stats = jax.jit(lambda: monte_carlo_mpc(mpc, _circle, steps, mc=mc))()
    bodies, rates, x0 = sample_conditions(
        jax.random.PRNGKey(mc.seed), mc, RigidBodyParams(), RateLoopParams(),
        FlightLoopConfig().takeoff_height,
    )
    for i in range(mc.n_rollouts):
        pick = lambda tree: jax.tree_util.tree_map(lambda a: a[i], tree)
        outs = mpc_flight_rollout(mpc, _circle, steps, body=pick(bodies),
                                  rate_loop=pick(rates), initial_state=x0[i])
        err = np.linalg.norm(
            np.asarray(outs["state"][mc.settle_steps:, 0:3])
            - np.asarray(outs["pos_ref"][mc.settle_steps:]), axis=1)
        np.testing.assert_allclose(float(stats["rms_pos"][i]),
                                   float(np.sqrt((err**2).mean())),
                                   rtol=1e-4, atol=1e-5)


def test_fallback_bounds_monte_carlo_worst_case():
    """The reference's divergence-triggered hover fallback
    (src/px4/mpc.py:2276-2282) wired into the loop: under the standard
    dispersion model the unguarded population shows multi-meter worst-case
    excursions; with ``fallback_error_m`` the PD recovery law
    (mpc.py:2117-2130) engages on divergence and bounds the worst case
    (measured here: free worst 6.40 m -> guarded 4.88 m, guarded mean RMS
    BETTER, 1.24 -> 1.04 m — VERDICT round-2 #5)."""
    steps = 700
    mc = MonteCarloConfig(n_rollouts=64)
    mpc = LinearMPC(
        LinearMPCConfig(horizon=10, admm_iterations=40), dtype=jnp.float32
    )
    free = jax.jit(
        lambda: monte_carlo_mpc(mpc, _circle, steps, mc=mc)
    )()
    guarded = jax.jit(
        lambda: monte_carlo_mpc(
            mpc, _circle, steps, mc=mc,
            loop_cfg=FlightLoopConfig(fallback_error_m=1.5),
        )
    )()
    w_free = float(free["worst_max_pos"])
    w_guarded = float(guarded["worst_max_pos"])
    assert w_guarded < w_free, (w_free, w_guarded)
    assert w_guarded < 5.0, (w_free, w_guarded)
    # the guard must not cost nominal tracking (it actually helps here)
    assert float(guarded["rms_mean"]) < float(free["rms_mean"]) + 0.05


def test_plot_robustness(tmp_path):
    from unmanned_aerial_vehicles_tpu.metrics import plot_robustness

    stats = jax.jit(
        lambda: monte_carlo_pid(_circle, 100,
                                mc=MonteCarloConfig(n_rollouts=6,
                                                    settle_steps=20))
    )()
    out = str(tmp_path / "mc.png")
    plot_robustness({k: np.asarray(v) for k, v in stats.items()}, out)
    import os

    assert os.path.getsize(out) > 10_000


def test_batched_sweep_fallback_matches_per_flight():
    """The throughput sweep's vectorized divergence fallback must agree
    with the per-flight staged fallback (same law, same recovery
    authority)."""
    from unmanned_aerial_vehicles_tpu.loop.closed_loop import (
        batched_mpc_flight_sweep,
        mpc_flight_rollout,
    )

    mpc = LinearMPC(
        LinearMPCConfig(horizon=10, admm_iterations=40), dtype=jnp.float32,
    )
    cfg = FlightLoopConfig(fallback_error_m=0.5)  # binds during the ramp
    starts = jnp.zeros((3, 12), jnp.float32).at[:, 2].set(3.0)
    starts = starts.at[:, 0].set(jnp.asarray([-2.0, 0.0, 2.0]))
    T = 120
    batched = batched_mpc_flight_sweep(mpc, _circle, T, starts, cfg=cfg)
    for i in range(3):
        single = mpc_flight_rollout(
            mpc, _circle, T, cfg=cfg, initial_state=starts[i]
        )
        np.testing.assert_allclose(
            np.asarray(batched["state"][:, i]),
            np.asarray(single["state"]), atol=2e-3,
        )


def test_monte_carlo_mpc12_dispersion():
    """12-state-family population study (loop.monte_carlo_mpc12): the
    multitick torque engine flies its NOMINAL model against jittered true
    plants — dispersion must be real (mass axis spreads the per-member
    RMS), zero-jitter must collapse to one deterministic flight, and the
    stats stay finite/ordered."""
    from unmanned_aerial_vehicles_tpu.control.mpc_rigid import RigidBodyMPC
    from unmanned_aerial_vehicles_tpu.loop import monte_carlo_mpc12

    steps = 64
    eng = RigidBodyMPC()
    zero = MonteCarloConfig(
        n_rollouts=3, mass_jitter_pct=0.0, drag_jitter_pct=0.0,
        tau_jitter_pct=0.0, hover_thrust_jitter_pct=0.0, wind_std=0.0,
        initial_pos_std=0.0, initial_vel_std=0.0, settle_steps=16,
    )
    jittered = zero.replace(n_rollouts=4, mass_jitter_pct=0.15)

    s_zero = jax.jit(
        lambda: monte_carlo_mpc12(eng, _circle, steps, mc=zero,
                                  ticks_per_dispatch=8)
    )()
    rms0 = np.asarray(s_zero["rms_pos"])
    assert np.isfinite(rms0).all()
    np.testing.assert_allclose(rms0, rms0[0], rtol=1e-6)  # identical members

    s_jit = jax.jit(
        lambda: monte_carlo_mpc12(eng, _circle, steps, mc=jittered,
                                  ticks_per_dispatch=8)
    )()
    rms_j = np.asarray(s_jit["rms_pos"])
    assert np.isfinite(rms_j).all()
    assert float(np.std(rms_j)) > 0.0        # the mass axis actually bites
    assert float(s_jit["rms_p50"]) <= float(s_jit["rms_p90"]) + 1e-9
