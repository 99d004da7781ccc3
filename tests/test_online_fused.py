"""Capabilities of the closed loop beyond the plain MPC flight: online
in-flight GP learning, frozen-posterior flights with variance tightening,
mid-flight resume, dispersed plants under vmap and the batched sweep.

Each is checked against an independent path: the full-system online loop,
the explicit residual/uncertainty hooks, per-flight rollouts, or an
uninterrupted flight.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from unmanned_aerial_vehicles_tpu.control.mpc_linear import LinearMPC, LinearMPCConfig
from unmanned_aerial_vehicles_tpu.gp import build_horizon_residuals, fit_residual_gp
from unmanned_aerial_vehicles_tpu.gp.residual_gp import (
    ResidualGPConfig,
    build_horizon_uncertainty,
)
from unmanned_aerial_vehicles_tpu.loop import (
    FlightLoopConfig,
    OnlineFusedGPConfig,
    OnlineGPMPCConfig,
    mpc_flight_rollout,
    online_gp_mpc_rollout,
)
from unmanned_aerial_vehicles_tpu.loop.closed_loop import batched_mpc_flight_sweep
from unmanned_aerial_vehicles_tpu.models import RigidBodyParams
from unmanned_aerial_vehicles_tpu.trajectories import ramped_figure8_reference


def small_mpc(**kw):
    kw.setdefault("horizon", 10)
    kw.setdefault("admm_iterations", 40)
    return LinearMPC(LinearMPCConfig(**kw))


def circle_ref(t):
    pos = jnp.stack(
        [0.5 * jnp.sin(0.3 * t), 0.5 * jnp.cos(0.3 * t), 3.0 + 0.0 * t]
    )
    return pos, jnp.float32(0.0)


def fig8_ref(t):
    pos, yaw = ramped_figure8_reference(t, amplitude=6.0, frequency=0.02)
    return pos + jnp.array([0.0, 0.0, 3.0]), yaw


def rms(outs, tail=0):
    err = np.linalg.norm(
        np.asarray(outs["pos_ref"] - outs["state"][:, 0:3]), axis=1
    )
    return float(np.sqrt((err[tail:] ** 2).mean()))


def small_posterior(rng, n=64, scale=0.05):
    X = jnp.asarray(rng.normal(size=(n, 10)), jnp.float32)
    Y = jnp.asarray(scale * rng.normal(size=(n, 6)), jnp.float32)
    return fit_residual_gp(X, Y, ResidualGPConfig())


# ---------------------------------------------------------------------------
# dispersed plants
# ---------------------------------------------------------------------------


def test_dispersed_plants_vmap():
    """One compiled flight serves a whole dispersion batch: ``vmap`` over
    ``RigidBodyParams`` batches (mass/drag/wind) must equal the per-plant
    runs — the Monte-Carlo path."""
    mpc = small_mpc()
    T = 80
    masses = jnp.asarray([0.45, 0.5, 0.55, 0.6])
    winds = jnp.asarray(
        [[0.0, 0.0, 0.0], [1.0, 0.0, 0.0], [0.0, -1.0, 0.5], [0.5, 0.5, 0.0]]
    )
    bodies = jax.vmap(
        lambda m, w: RigidBodyParams().replace(mass=m, wind=(w[0], w[1], w[2]))
    )(masses, winds)

    def flight(body):
        return mpc_flight_rollout(mpc, circle_ref, T, body=body)["state"]

    batched = jax.vmap(flight)(bodies)
    for i in range(4):
        body_i = jax.tree_util.tree_map(lambda a: a[i], bodies)
        np.testing.assert_allclose(
            np.asarray(batched[i]), np.asarray(flight(body_i)), atol=1e-5
        )
    # the wind really reaches the plant
    assert float(jnp.max(jnp.abs(batched[1] - batched[0]))) > 1e-2


# ---------------------------------------------------------------------------
# online in-flight GP learning
# ---------------------------------------------------------------------------


def test_online_rollout_matches_full_system():
    """``mpc_flight_rollout(online_gp=...)`` and the full-system online loop
    (``loop.full_system.online_gp_mpc_rollout``, MPC every tick) are two
    entry points to the same capture/refit policy: same flight, same ring
    buffer."""
    body = RigidBodyParams(wind=(0.8, 0.3, 0.0))
    gcfg = ResidualGPConfig(max_data_points=64, residual_gain=0.5)
    mpc = small_mpc()
    T = 160
    ogp = OnlineFusedGPConfig(gp=gcfg, refit_every=32, min_samples=10)
    ours = jax.jit(lambda: mpc_flight_rollout(
        mpc, circle_ref, T, body=body, online_gp=ogp, gp_gain=0.5,
    ))()
    theirs, ds, _ = jax.jit(lambda: online_gp_mpc_rollout(
        mpc, circle_ref, T, OnlineGPMPCConfig(
            gp=gcfg, gp_refit_every=32, gp_min_samples=10,
        ), body=body,
    ))()
    np.testing.assert_allclose(
        np.asarray(ours["state"]), np.asarray(theirs["state"]), atol=1e-6
    )
    np.testing.assert_array_equal(
        np.asarray(ours["gp_count"]), np.asarray(theirs["gp_count"])
    )
    assert int(ds.count) == 64   # the ring filled and kept cycling


def test_online_gp_learns_wind_disturbance():
    """The ONLINE ring-buffer GP recovers a large share of the
    wind-induced tracking penalty on the figure-8 campaign setup."""
    windy = RigidBodyParams(wind=(1.5, 0.8, 0.0))
    steps = 2000  # 40 s
    mpc = small_mpc(horizon=20, admm_iterations=60)
    plain = jax.jit(
        lambda: mpc_flight_rollout(mpc, fig8_ref, steps, body=windy,
                                   preview=True)
    )()
    ogp = OnlineFusedGPConfig(
        gp=ResidualGPConfig(max_data_points=256, residual_gain=1.0),
        refit_every=200,
    )
    online = jax.jit(
        lambda: mpc_flight_rollout(
            mpc, fig8_ref, steps, body=windy, preview=True,
            online_gp=ogp, gp_gain=1.0,
        )
    )()
    r_plain = rms(plain, tail=1000)
    r_online = rms(online, tail=1000)
    assert int(online["gp_count"][-1]) > 100   # in-flight data collection
    assert r_online < 0.75 * r_plain, (r_online, r_plain)


def test_online_gp_guards(rng):
    mpc = small_mpc()
    ogp = OnlineFusedGPConfig(gp=ResidualGPConfig(max_data_points=32))
    post = small_posterior(rng, n=16)
    with pytest.raises(ValueError, match="in-flight"):
        mpc_flight_rollout(mpc, circle_ref, 8, online_gp=ogp,
                           gp_posterior=post)
    with pytest.raises(ValueError, match="in-flight"):
        mpc_flight_rollout(mpc, circle_ref, 8, online_gp=ogp,
                           residual_fn=lambda X, U: jnp.zeros((10, 6)))
    with pytest.raises(ValueError, match="initial_dataset"):
        mpc_flight_rollout(mpc, circle_ref, 8,
                           initial_dataset=ogp.gp.max_data_points)
    with pytest.raises(ValueError, match="OR residual_fn"):
        mpc_flight_rollout(mpc, circle_ref, 8, gp_posterior=post,
                           residual_fn=lambda X, U: jnp.zeros((10, 6)))


def test_online_tightening_fallback_wind_compose():
    """Online learning + variance tightening + divergence fallback + wind
    at once: the combinations must compose and stay healthy."""
    windy = RigidBodyParams(wind=(1.0, 0.5, 0.0))
    mpc = small_mpc(tightening_factor=1.0)
    cfg = FlightLoopConfig(fallback_error_m=2.0)
    ogp = OnlineFusedGPConfig(
        gp=ResidualGPConfig(max_data_points=64, residual_gain=1.0),
        refit_every=64, min_samples=16,
    )
    outs = jax.jit(
        lambda: mpc_flight_rollout(
            mpc, circle_ref, 320, body=windy, cfg=cfg, online_gp=ogp,
            gp_gain=1.0,
        )
    )()
    assert np.isfinite(np.asarray(outs["state"])).all()
    assert int(outs["gp_count"][-1]) > 16       # learning happened
    assert rms(outs, tail=160) < 1.0            # and the loop stays sane


def test_online_standardized_inputs_change_flight():
    """``standardize_inputs=True`` refits with ARD scales: vs the unscaled
    run the flight must change after the first refit, and stay healthy
    under wind."""
    windy = RigidBodyParams(wind=(1.2, 0.6, 0.0))
    mpc = small_mpc()
    base = dict(
        gp=ResidualGPConfig(max_data_points=128, residual_gain=1.0),
        refit_every=64, min_samples=16,
    )
    T = 320
    runs = {}
    for name, std in (("raw", False), ("scaled", True)):
        ogp = OnlineFusedGPConfig(**base, standardize_inputs=std)
        runs[name] = jax.jit(
            lambda o=ogp: mpc_flight_rollout(
                mpc, circle_ref, T, body=windy, online_gp=o, gp_gain=1.0,
            )
        )()
    for outs in runs.values():
        assert np.isfinite(np.asarray(outs["state"])).all()
        assert int(outs["gp_count"][-1]) > 16
    gap = np.max(
        np.abs(np.asarray(runs["raw"]["state"])
               - np.asarray(runs["scaled"]["state"]))
    )
    assert gap > 1e-4, gap
    assert rms(runs["scaled"], tail=160) < 1.0


# ---------------------------------------------------------------------------
# frozen posterior: gp_posterior= and variance tightening
# ---------------------------------------------------------------------------


def test_gp_posterior_tightening_matches_explicit_hooks(rng):
    """``gp_posterior=`` must fly exactly what the explicit hooks fly
    (``residual_fn`` = ``build_horizon_residuals``, ``uncertainty_fn`` =
    ``build_horizon_uncertainty``), in a regime where the tightened bounds
    BIND."""
    X = jnp.asarray(rng.normal(size=(64, 10)) * 2.0, jnp.float32)
    Y = jnp.asarray(4.0 * rng.normal(size=(64, 6)), jnp.float32)
    gcfg = ResidualGPConfig()
    post = fit_residual_gp(X, Y, gcfg)

    def fast_ref(t):
        pos = jnp.stack([2.0 * jnp.sin(t), 2.0 * jnp.cos(t), 3.0 + 0.0 * t])
        return pos, jnp.float32(0.0)

    T = 80
    kw = dict(
        state_lower=(-5.0, -5.0, 2.0, -2.5, -2.5, -1.0),
        state_upper=(5.0, 5.0, 4.0, 2.5, 2.5, 1.0),
    )
    flights = {}
    for kappa in (0.0, 3.0):
        mpc = small_mpc(tightening_factor=kappa, **kw)
        ours = mpc_flight_rollout(mpc, fast_ref, T, gp_posterior=post,
                                  gp_gain=gcfg.residual_gain)
        hooks = mpc_flight_rollout(
            mpc, fast_ref, T,
            residual_fn=lambda Xg, Ug: build_horizon_residuals(
                post, Xg, Ug, gcfg
            ),
            uncertainty_fn=(
                (lambda Xg, Ug: build_horizon_uncertainty(post, Xg, Ug, gcfg))
                if kappa > 0 else None
            ),
        )
        np.testing.assert_array_equal(
            np.asarray(ours["state"]), np.asarray(hooks["state"])
        )
        flights[kappa] = np.asarray(ours["state"][:, 0:3])
    # the back-off must actually bind in this regime
    assert np.max(np.abs(flights[3.0] - flights[0.0])) > 0.05


def test_standardized_ard_posterior_matches_residual_fn():
    """An ARD (standardized-input-equivalent), centered posterior through
    ``gp_posterior=`` must match the ``residual_fn`` path bit for bit."""
    from unmanned_aerial_vehicles_tpu.gp.residual_gp import (
        ResidualDataset,
        fit_residual_gp_masked,
        masked_input_stats,
        standardized_params,
    )

    rng = np.random.default_rng(3)
    scales = np.r_[6.0, 6.0, 3.0, 1.5, 1.5, 0.8, 1.0, 0.5, 0.5, 0.3]
    offsets = np.r_[0.0, 0.0, 3.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0]
    X = np.asarray(rng.normal(size=(64, 10)) * scales + offsets, np.float32)
    Y = np.asarray(0.05 * rng.normal(size=(64, 6)), np.float32)
    ds = ResidualDataset(
        X=jnp.asarray(X), Y=jnp.asarray(Y),
        head=jnp.asarray(64, jnp.int32), count=jnp.asarray(64, jnp.int32),
    )
    gcfg = ResidualGPConfig(residual_gain=1.0)
    post = fit_residual_gp_masked(
        ds, gcfg, params=standardized_params(ds, gcfg),
        x_shift=masked_input_stats(ds)[0],
    )
    ls = np.asarray(post.params.length_scale)
    assert ls.shape == (10,) and ls.std() > 0.1   # ARD really engaged
    assert post.x_shift is not None               # centered fit engaged

    mpc = small_mpc()
    T = 80
    hooks = mpc_flight_rollout(
        mpc, circle_ref, T,
        residual_fn=lambda Xg, Ug: build_horizon_residuals(post, Xg, Ug, gcfg),
    )
    ours = mpc_flight_rollout(mpc, circle_ref, T, gp_posterior=post,
                              gp_gain=gcfg.residual_gain)
    np.testing.assert_array_equal(
        np.asarray(hooks["state"]), np.asarray(ours["state"])
    )


# ---------------------------------------------------------------------------
# mid-flight resume
# ---------------------------------------------------------------------------


def test_mid_flight_checkpoint_resume(tmp_path):
    """Elastic recovery the reference lacks (its checkpoints are GP models
    only; no mid-run resume anywhere — SURVEY section 5): an online flight
    saved mid-way and resumed from disk must be BIT-EXACT vs the
    uninterrupted flight, ring buffer included."""
    from unmanned_aerial_vehicles_tpu.io import (
        load_resume_state,
        save_resume_state,
    )

    mpc = small_mpc(admm_iterations=20)
    ogp = OnlineFusedGPConfig(
        gp=ResidualGPConfig(max_data_points=256), refit_every=32,
        min_samples=10,
    )
    body = RigidBodyParams(wind=(0.8, 0.3, 0.0))

    full = mpc_flight_rollout(mpc, circle_ref, 160, body=body, online_gp=ogp)
    seg1, rs = mpc_flight_rollout(mpc, circle_ref, 81, body=body,
                                  online_gp=ogp, return_resume=True)
    assert rs.tick == 81
    path = str(tmp_path / "resume.npz")
    save_resume_state(path, rs)
    # structure template from a cheap one-tick segment
    _, tmpl = mpc_flight_rollout(mpc, circle_ref, 1, body=body,
                                 online_gp=ogp, return_resume=True)
    rs2 = load_resume_state(path, tmpl)
    assert rs2.tick == 81
    seg2 = mpc_flight_rollout(mpc, circle_ref, 79, body=body,
                              online_gp=ogp, resume=rs2)

    cat = np.concatenate(
        [np.asarray(seg1["state"]), np.asarray(seg2["state"])]
    )
    np.testing.assert_array_equal(cat, np.asarray(full["state"]))
    # ring buffer kept filling across the boundary (capacity not yet hit)
    assert int(seg2["gp_count"][-1]) > int(seg1["gp_count"][-1])
    assert int(seg2["gp_count"][-1]) == int(full["gp_count"][-1])

    # mismatched-config checkpoints fail loudly
    _, tmpl_other = mpc_flight_rollout(
        small_mpc(horizon=5, admm_iterations=20), circle_ref, 1, body=body,
        online_gp=ogp, return_resume=True,
    )
    with pytest.raises(ValueError, match="mismatch"):
        load_resume_state(path, tmpl_other)


# ---------------------------------------------------------------------------
# the batched sweep
# ---------------------------------------------------------------------------


def _starts(B):
    starts = jnp.zeros((B, 12), jnp.float32).at[:, 2].set(3.0)
    return starts.at[:, 0].set(jnp.linspace(-0.5, 0.5, B, dtype=jnp.float32))


def test_batched_sweep_matches_vmapped_rollout():
    """Throughput mode must reproduce single-flight rollouts across a batch
    of flights."""

    def ref(t):
        pos, yaw = ramped_figure8_reference(t, amplitude=2.0, frequency=0.1)
        return pos + jnp.array([0.0, 0.0, 3.0]), yaw

    mpc = small_mpc(admm_iterations=60)
    B, T = 4, 40
    starts = _starts(B)
    out_b = jax.jit(lambda: batched_mpc_flight_sweep(mpc, ref, T, starts))()
    sb = np.asarray(out_b["state"])                       # (T, B, 12)
    assert sb.shape == (T, B, 12)
    for b in range(B):
        single = mpc_flight_rollout(mpc, ref, T, initial_state=starts[b])
        np.testing.assert_allclose(
            sb[:, b], np.asarray(single["state"]), atol=1e-5
        )


def test_batched_sweep_gp_posterior_matches_single_flights(rng):
    """``gp_posterior=`` on the sweep (one posterior-mean call over all
    B*N stages) flies what per-flight ``mpc_flight_rollout(gp_posterior=)``
    flies."""
    post = small_posterior(rng, n=120)
    gcfg = ResidualGPConfig()
    mpc = small_mpc(admm_iterations=20)
    starts = _starts(4)
    T = 30
    sweep = batched_mpc_flight_sweep(mpc, circle_ref, T, starts,
                                     gp_posterior=post, gp_cfg=gcfg)
    for b in range(4):
        single = mpc_flight_rollout(
            mpc, circle_ref, T, initial_state=starts[b], gp_posterior=post,
            gp_gain=gcfg.residual_gain, gp_dt=gcfg.dt,
        )
        np.testing.assert_allclose(
            np.asarray(sweep["state"][:, b]), np.asarray(single["state"]),
            atol=1e-5,
        )


def test_batched_residuals_match_vmapped(rng):
    """build_horizon_residuals_batched == vmap(build_horizon_residuals), on
    the XLA path and through the Triton kernel in the interpreter."""
    from unmanned_aerial_vehicles_tpu.gp.residual_gp import (
        build_horizon_residuals_batched,
    )

    cfg = ResidualGPConfig()
    post = small_posterior(rng, n=150)
    B, N = 5, 12
    Xg = jnp.asarray(rng.normal(size=(B, N + 1, 6)), jnp.float32)
    Ug = jnp.asarray(rng.normal(size=(B, N, 4)), jnp.float32)
    ref = jax.vmap(lambda a, b: build_horizon_residuals(post, a, b, cfg))(Xg, Ug)
    for interpret in (False, True):
        got = build_horizon_residuals_batched(post, Xg, Ug, cfg,
                                              interpret=interpret)
        np.testing.assert_allclose(np.asarray(got), np.asarray(ref), atol=1e-6)


def test_sweep_gp_rate_divider_parity(rng):
    """batched_mpc_flight_sweep(gp_every=5): multi-rate GP evaluation (the
    reference's own 10 Hz-MPC-vs-100 Hz-plant pattern) must track the
    every-tick GP closely — the held disturbances change slowly along the
    warm-start trajectory."""
    post = small_posterior(rng)
    gcfg = ResidualGPConfig()
    rf = lambda Xg, Ug: build_horizon_residuals(post, Xg, Ug, gcfg)
    mpc = small_mpc()
    starts = jnp.zeros((4, 12), jnp.float32).at[:, 2].set(3.0)
    starts = starts.at[:, 0].set(
        jnp.linspace(-0.3, 0.3, 4, dtype=jnp.float32)
    )
    T = 100
    exact = batched_mpc_flight_sweep(mpc, circle_ref, T, starts, residual_fn=rf)
    held = batched_mpc_flight_sweep(
        mpc, circle_ref, T, starts, residual_fn=rf, gp_every=5
    )
    gap = np.max(
        np.abs(np.asarray(exact["state"]) - np.asarray(held["state"]))
    )
    assert gap < 5e-3, gap
    # and it must differ from zero somewhere (the divider is really active)
    assert gap > 0.0


# ---------------------------------------------------------------------------
# online learning composed with the estimator (online + noisy)
# ---------------------------------------------------------------------------


def test_online_noisy_clean_sensors_matches_online_truth():
    """online_gp on the NOISY loop (the GP trains on EKF estimates — the
    reference's EKF2-fed capture, mpc.py:1889-1907, 2016-2021): with
    near-noiseless sensors the estimate collapses onto the truth, so the
    captured dataset, the refits and the flight must all match the
    truth-capture online flight."""
    from unmanned_aerial_vehicles_tpu.estimation import (
        EKFConfig,
        noisy_mpc_flight_rollout,
    )

    steps = 400
    mpc = small_mpc(horizon=20)
    ogp = OnlineFusedGPConfig(
        gp=ResidualGPConfig(max_data_points=128), refit_every=200,
        min_samples=30,
    )
    clean = EKFConfig(r_pos=1e-5, r_att=1e-5, r_rate=1e-5,
                      p0_pos=1e-4, p0_vel=1e-4, p0_att=1e-4, p0_rate=1e-4)
    truth = jax.jit(lambda: mpc_flight_rollout(
        mpc, circle_ref, steps, online_gp=ogp
    ))()
    noisy = jax.jit(lambda: noisy_mpc_flight_rollout(
        mpc, circle_ref, steps, jax.random.PRNGKey(0), ekf_cfg=clean,
        online_gp=ogp
    ))()
    assert int(noisy["gp_count"][-1]) == int(truth["gp_count"][-1])
    gap = np.abs(np.asarray(truth["state"][:, 0:3])
                 - np.asarray(noisy["state"][:, 0:3])).max()
    assert gap < 0.05, gap


def test_online_noisy_learns_wind_from_estimates():
    """The full composition: wind + noisy sensors + in-flight learning.
    The GP trained on EKF ESTIMATES must still recover a substantial share
    of the wind-induced tracking penalty."""
    from unmanned_aerial_vehicles_tpu.estimation import (
        EKFConfig,
        noisy_mpc_flight_rollout,
    )

    windy = RigidBodyParams(wind=(1.5, 0.8, 0.0))
    steps = 1600  # 32 s
    mpc = small_mpc(horizon=20, admm_iterations=60)
    plain = jax.jit(lambda: noisy_mpc_flight_rollout(
        mpc, fig8_ref, steps, jax.random.PRNGKey(2), ekf_cfg=EKFConfig(),
        body=windy, preview=True
    ))()
    ogp = OnlineFusedGPConfig(
        gp=ResidualGPConfig(max_data_points=256, residual_gain=1.0),
        refit_every=200,
    )
    online = jax.jit(lambda: noisy_mpc_flight_rollout(
        mpc, fig8_ref, steps, jax.random.PRNGKey(2), ekf_cfg=EKFConfig(),
        body=windy, preview=True, online_gp=ogp, gp_gain=1.0
    ))()
    r_plain = rms(plain, tail=800)
    r_online = rms(online, tail=800)
    assert int(online["gp_count"][-1]) > 100
    assert r_online < 0.75 * r_plain, (r_online, r_plain)


def test_online_noisy_guards(rng):
    from unmanned_aerial_vehicles_tpu.estimation import (
        noisy_mpc_flight_rollout,
    )

    mpc = small_mpc()
    ogp = OnlineFusedGPConfig(gp=ResidualGPConfig(max_data_points=64))
    with pytest.raises(ValueError, match="in-flight"):
        noisy_mpc_flight_rollout(
            mpc, circle_ref, 8, jax.random.PRNGKey(0), online_gp=ogp,
            gp_posterior=small_posterior(rng, n=16),
        )
