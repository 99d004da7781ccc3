"""GP parity tests: sklearn posterior/LML to 1e-6 on flight data,
hyperparameter optimisation, ring-buffer filters, horizon residuals,
checkpoint round-trip (SURVEY.md section 7 stage 3)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from sklearn.gaussian_process import GaussianProcessRegressor
from sklearn.gaussian_process.kernels import RBF, WhiteKernel

from unmanned_aerial_vehicles_tpu.gp import (
    GPParams,
    add_training_sample,
    build_horizon_residuals,
    empty_dataset,
    fit_gp,
    fit_residual_gp,
    log_marginal_likelihood,
    optimize_hyperparameters,
    predict,
    predict_residual,
)
from unmanned_aerial_vehicles_tpu.gp.residual_gp import ResidualGPConfig
from unmanned_aerial_vehicles_tpu.io import (
    load_gp_dataset,
    load_gp_checkpoint,
    save_gp_checkpoint,
)


@pytest.fixture(scope="module")
def flight_data(flight_csvs):
    """The first synthetic flight CSV, read back through the loader. Like
    the reference's CSVs it records a constant yawrate command."""
    X, Y = load_gp_dataset(flight_csvs[0])
    X = X.copy()
    X[:, 9] = 0.0
    return X[:300], Y[:300], X[300:350], Y[300:350]


def sklearn_reference(X, Y):
    kernel = RBF(length_scale=0.5) + WhiteKernel(noise_level=0.1)
    gp = GaussianProcessRegressor(
        kernel=kernel, alpha=1e-4, normalize_y=True, optimizer=None
    )
    gp.fit(X, Y)
    return gp


def test_posterior_mean_parity_with_sklearn(flight_data):
    X, Y, Xt, _ = flight_data
    skl = sklearn_reference(X, Y)
    mean_ref, std_ref = skl.predict(Xt, return_std=True)

    post = fit_residual_gp(jnp.asarray(X), jnp.asarray(Y))
    mean, var = predict(post, jnp.asarray(Xt))

    np.testing.assert_allclose(np.asarray(mean), mean_ref, atol=1e-6)
    np.testing.assert_allclose(np.sqrt(np.asarray(var)), std_ref, atol=1e-6)


def test_lml_parity_with_sklearn(flight_data):
    X, Y, _, _ = flight_data
    skl = sklearn_reference(X, Y)
    lml_ref = skl.log_marginal_likelihood()

    params = GPParams.create(0.5, 1.0, 0.1)
    lml = log_marginal_likelihood(
        params, jnp.asarray(X), jnp.asarray(Y), jitter=1e-4, normalize_y=True
    )
    np.testing.assert_allclose(float(lml), lml_ref, rtol=1e-9)


def test_hyperparameter_optimization_improves_lml(flight_data):
    X, Y, _, _ = flight_data
    Xj, Yj = jnp.asarray(X), jnp.asarray(Y)
    params = GPParams.create(2.0, 0.5, 0.5)  # deliberately bad start
    lml0 = log_marginal_likelihood(params, Xj, Yj, jitter=1e-4, normalize_y=True)
    best, nll = optimize_hyperparameters(
        params, Xj, Yj, jitter=1e-4, normalize_y=True, steps=60
    )
    lml1 = log_marginal_likelihood(best, Xj, Yj, jitter=1e-4, normalize_y=True)
    assert float(lml1) > float(lml0) + 10.0
    np.testing.assert_allclose(float(nll), -float(lml1), rtol=1e-6)


def test_unfitted_region_reverts_to_prior(flight_data):
    """Far from data the mean must go to the (de-normalised) prior mean."""
    X, Y, _, _ = flight_data
    post = fit_residual_gp(jnp.asarray(X), jnp.asarray(Y))
    far = jnp.full((1, 10), 100.0)
    mean, var = predict(post, far)
    np.testing.assert_allclose(np.asarray(mean[0]), Y.mean(axis=0), atol=1e-6)
    # prior variance = (signal + noise) * y_std^2 per output
    np.testing.assert_allclose(
        np.asarray(var[0]), 1.1 * Y.std(axis=0) ** 2, rtol=1e-6
    )


def test_ring_buffer_filters():
    cfg = ResidualGPConfig(max_data_points=4, dt=0.02)
    ds = empty_dataset(4, jnp.float64)

    ok_state = jnp.zeros(6)
    ok_ctrl = jnp.asarray([1.0, 0.0, 0.0, 0.0])
    ok_next = jnp.asarray([0.0, 0.0, 0.0, 0.021, 0.0, 0.0])

    ds = add_training_sample(ds, ok_state, ok_ctrl, ok_next, cfg)
    assert int(ds.count) == 1

    fast_state = jnp.zeros(6).at[3].set(9.0)  # ||v|| > 5 -> reject
    ds = add_training_sample(ds, fast_state, ok_ctrl, ok_next, cfg)
    assert int(ds.count) == 1

    big_ctrl = jnp.asarray([5.0, 0.0, 0.0, 0.0])  # ||u|| > 3 -> reject
    ds = add_training_sample(ds, ok_state, big_ctrl, ok_next, cfg)
    assert int(ds.count) == 1

    big_res_next = jnp.asarray([5.0, 0.0, 0.0, 0.0, 0.0, 0.0])  # ||res|| > 2
    ds = add_training_sample(ds, ok_state, ok_ctrl, big_res_next, cfg)
    assert int(ds.count) == 1

    for _ in range(5):  # wrap the ring
        ds = add_training_sample(ds, ok_state, ok_ctrl, ok_next, cfg)
    assert int(ds.count) == 4

    # stored residual = next - nominal
    nominal = np.zeros(6)
    nominal[0] = 0.0
    expected_res = np.asarray(ok_next) - (
        np.asarray(ok_state) + 0.02 * np.array([0, 0, 0, 1.0, 0, 0])
    )
    np.testing.assert_allclose(np.asarray(ds.Y[0]), expected_res, atol=1e-12)


def test_horizon_residuals_shape_and_conversion(flight_data):
    X, Y, _, _ = flight_data
    cfg = ResidualGPConfig()
    post = fit_residual_gp(jnp.asarray(X), jnp.asarray(Y), cfg)

    N = 25
    X_guess = jnp.tile(jnp.asarray(X[0, :6])[None, :], (N + 1, 1))
    U_guess = jnp.tile(jnp.asarray(X[0, 6:10])[None, :], (N, 1))
    D = build_horizon_residuals(post, X_guess, U_guess, cfg)
    assert D.shape == (N, 6)
    np.testing.assert_allclose(np.asarray(D[:, 0:3]), 0.0)  # position rows zero

    mean, _ = predict_residual(post, jnp.asarray(X[0, :6]), jnp.asarray(X[0, 6:10]))
    expected = cfg.residual_gain * np.asarray(mean)[3:6] / cfg.dt
    np.testing.assert_allclose(np.asarray(D[0, 3:6]), expected, atol=1e-9)


def test_standardized_params_match_sklearn_scaled_fit():
    """``standardized_params`` (ARD ls = l * sigma_d) must reproduce a
    sklearn fit on ``StandardScaler``-transformed inputs — the reference's
    own OFFLINE practice (gp_trainer.py:121-135) expressed as ARD (the mean
    shift cancels in RBF distances), opt-in for the ONLINE path.

    Synthetic multi-scale data: real flight CSVs carry a CONSTANT yawrate
    column (std ~1e-19) that sklearn's scaler divides by — amplifying float
    noise to O(1) features — while our 1e-8 guard falls back to the plain
    RBF distance on that lane; equivalence holds on non-degenerate dims."""
    from sklearn.preprocessing import StandardScaler

    from unmanned_aerial_vehicles_tpu.gp.residual_gp import (
        ResidualDataset,
        fit_residual_gp_masked,
        masked_input_stats,
        standardized_params,
    )

    rng = np.random.default_rng(7)
    scales = np.r_[6.0, 6.0, 3.0, 1.5, 1.5, 0.8, 1.0, 0.5, 0.5, 0.3]
    offsets = np.r_[0.0, 0.0, 3.0, 0.0, 0.0, 0.0, 0.7, 0.0, 0.0, 0.0]
    X = rng.normal(size=(200, 10)) * scales + offsets
    Y = 0.05 * rng.normal(size=(200, 6))
    Xt = rng.normal(size=(40, 10)) * scales + offsets
    n = X.shape[0]
    ds = ResidualDataset(
        X=jnp.asarray(X), Y=jnp.asarray(Y),
        head=jnp.asarray(n, jnp.int32), count=jnp.asarray(n, jnp.int32),
    )
    cfg = ResidualGPConfig()
    params = standardized_params(ds, cfg)
    assert np.asarray(params.length_scale).shape == (10,)
    shift, _ = masked_input_stats(ds)
    np.testing.assert_allclose(np.asarray(shift), X.mean(axis=0), rtol=1e-9)
    post = fit_residual_gp_masked(ds, cfg, params=params, x_shift=shift)
    mean, var = predict(post, jnp.asarray(Xt))

    scaler = StandardScaler().fit(X)   # population std, like our masked std
    skl = sklearn_reference(scaler.transform(X), Y)
    mean_ref, std_ref = skl.predict(scaler.transform(Xt), return_std=True)
    np.testing.assert_allclose(np.asarray(mean), mean_ref, atol=1e-6)
    np.testing.assert_allclose(np.sqrt(np.asarray(var)), std_ref, atol=1e-6)


def test_standardized_params_half_full_buffer(flight_data):
    """Masked std uses VALID rows only: a half-full ring buffer must give
    the same ARD scales as the dense fit on the valid prefix; degenerate
    (constant) dims fall back to plain RBF distance on that lane."""
    from unmanned_aerial_vehicles_tpu.gp.residual_gp import (
        ResidualDataset,
        empty_dataset,
        standardized_params,
    )

    X, Y, _, _ = flight_data
    n = X.shape[0] // 2
    cap = X.shape[0]
    ds = ResidualDataset(
        X=jnp.asarray(X).at[n:].set(777.0),   # garbage beyond count
        Y=jnp.asarray(Y),
        head=jnp.asarray(n, jnp.int32), count=jnp.asarray(n, jnp.int32),
    )
    cfg = ResidualGPConfig()
    ls = np.asarray(standardized_params(ds, cfg).length_scale)
    std = np.asarray(X[:n]).std(axis=0)
    # the constant yawrate column exercises the degenerate-dim fallback:
    # plain RBF distance on that lane
    expected = cfg.length_scale * np.where(std > 1e-8, std, 1.0)
    np.testing.assert_allclose(ls, expected, rtol=1e-6)

    empty = empty_dataset(cap)
    ls0 = np.asarray(standardized_params(empty, cfg).length_scale)
    np.testing.assert_allclose(ls0, cfg.length_scale)  # all dims degenerate


def test_checkpoint_roundtrip(tmp_path, flight_data):
    X, Y, Xt, _ = flight_data
    post = fit_residual_gp(jnp.asarray(X), jnp.asarray(Y))
    mean0, var0 = predict(post, jnp.asarray(Xt))

    path = tmp_path / "gp.npz"
    save_gp_checkpoint(str(path), post, X, Y, jitter=1e-4)
    post2, _, _, _, _ = load_gp_checkpoint(str(path))
    mean1, var1 = predict(post2, jnp.asarray(Xt))
    np.testing.assert_allclose(np.asarray(mean0), np.asarray(mean1), atol=1e-12)
    np.testing.assert_allclose(np.asarray(var0), np.asarray(var1), atol=1e-12)


def test_hyperopt_restarts_at_least_as_good(flight_data):
    import jax
    from unmanned_aerial_vehicles_tpu.gp import optimize_hyperparameters_restarts

    X, Y, _, _ = flight_data
    Xj, Yj = jnp.asarray(X[:150]), jnp.asarray(Y[:150])
    params = GPParams.create(2.0, 0.5, 0.5)
    _, nll_single = optimize_hyperparameters(
        params, Xj, Yj, jitter=1e-4, normalize_y=True, steps=30
    )
    _, nll_multi = optimize_hyperparameters_restarts(
        params, Xj, Yj, jax.random.PRNGKey(0), restarts=3,
        jitter=1e-4, normalize_y=True, steps=30,
    )
    assert float(nll_multi) <= float(nll_single) + 1e-6


def test_output_correction_generation(flight_csvs):
    """The reference's earlier GP-MPC generation (mpc_gp.py:341-372, byte-
    identical to mpc_original.py): GP corrects the solved control POST-solve.
    Checks the gates and that the two GP modes genuinely differ in flight."""
    from unmanned_aerial_vehicles_tpu.gp import (
        OutputCorrectionConfig,
        build_horizon_residuals,
        fit_residual_gp,
        make_output_correction_fn,
        output_correction,
    )
    from unmanned_aerial_vehicles_tpu.gp.residual_gp import ResidualGPConfig
    from unmanned_aerial_vehicles_tpu.io import load_gp_datasets
    from unmanned_aerial_vehicles_tpu.control.mpc_linear import (
        LinearMPC,
        LinearMPCConfig,
    )
    from unmanned_aerial_vehicles_tpu.loop import mpc_flight_rollout
    from unmanned_aerial_vehicles_tpu.trajectories import ramped_figure8_reference

    cfg = ResidualGPConfig()
    X, Y = load_gp_datasets(flight_csvs, max_samples=600)
    post = fit_residual_gp(jnp.asarray(X), jnp.asarray(Y), cfg)

    state = jnp.zeros(6).at[2].set(3.0).at[3].set(0.5)
    u0 = jnp.asarray([1.0, 0.5, 0.2, 0.0])
    target = jnp.asarray([1.0, 0.5, 3.0])

    # generous gates -> the correction applies and is clipped to +-0.1
    loose = OutputCorrectionConfig(confidence_threshold=1e3)
    u_corr = output_correction(post, state, u0, target, X.shape[0], loose)
    delta = np.asarray(u_corr - u0)
    assert np.any(delta != 0.0), "correction never applied"
    assert np.all(np.abs(delta[:3]) <= 0.1 + 1e-7)
    assert delta[3] == 0.0  # yaw-rate channel untouched (mpc_gp.py:369)

    # n_train gate: below 500 samples the control must pass through intact
    u_gated = output_correction(post, state, u0, target, 499, loose)
    np.testing.assert_array_equal(np.asarray(u_gated), np.asarray(u0))

    # instability gate: fast states disable the correction
    fast = state.at[3].set(5.0)
    u_fast = output_correction(post, fast, u0, target, X.shape[0], loose)
    np.testing.assert_array_equal(np.asarray(u_fast), np.asarray(u0))

    # closed loop: the two generations produce genuinely different flights
    mpc = LinearMPC(LinearMPCConfig(horizon=10, admm_iterations=40))

    def ref(t):
        pos, yaw = ramped_figure8_reference(t, amplitude=2.0, frequency=0.1)
        return pos + jnp.array([0.0, 0.0, 3.0]), yaw

    fly = lambda **kw: jax.jit(
        lambda: mpc_flight_rollout(mpc, ref, num_steps=80, **kw)
    )()
    out_dyn = fly(residual_fn=lambda Xg, Ug: build_horizon_residuals(post, Xg, Ug, cfg))
    out_out = fly(output_correction_fn=make_output_correction_fn(
        post, n_train=X.shape[0], config=loose))
    u_dyn = np.asarray(out_dyn["u_mpc"])
    u_out = np.asarray(out_out["u_mpc"])
    assert np.isfinite(u_dyn).all() and np.isfinite(u_out).all()
    assert np.abs(u_dyn - u_out).max() > 1e-4, "the two GP modes coincide"


def test_posterior_compression(rng):
    """gp.sparse: post-fit mean compression onto anchors.

    Positive case: a SMOOTH GP (length scale ~ data spread) compresses
    accurately — the anchor expansion interpolates the mean function.
    Negative case (the measured flight-config result): RBF(0.5) over
    unscaled wide inputs is a sum of near-disjoint bumps and compression
    FAILS — compression_error must report it loudly."""
    from unmanned_aerial_vehicles_tpu.gp import (
        GPParams,
        compress_posterior,
        compression_error,
        fit_gp,
        predict_mean,
    )

    # smooth regime: inputs in [-1,1]^3, ls=1.0
    X = jnp.asarray(rng.uniform(-1, 1, (300, 2)))
    Y = jnp.asarray(
        np.sin(2.0 * np.asarray(X[:, :1])) + 0.01 * rng.normal(size=(300, 1))
    )
    params = GPParams.create(length_scale=1.0, noise_variance=0.01)
    post = fit_gp(params, X, Y, jitter=1e-6, normalize_y=True)
    comp = compress_posterior(post, m=64)
    Xq = jnp.asarray(rng.uniform(-1, 1, (100, 2)))
    err = float(jnp.max(compression_error(post, comp, Xq)))
    scale = float(jnp.max(jnp.abs(predict_mean(post, Xq))))
    assert err < 0.05 * scale, (err, scale)
    # exact at the anchors by construction
    from unmanned_aerial_vehicles_tpu.gp.sparse import select_anchors
    Z = select_anchors(post.X_train, 64)
    err_z = float(jnp.max(compression_error(post, comp, Z)))
    # near-exact at anchors (the small interpolation jitter bounds it)
    assert err_z < 1e-5 * max(scale, 1.0)

    # flight regime: narrow kernel over wide inputs -> compression invalid,
    # and the error probe says so
    Xw = jnp.asarray(rng.uniform(-6, 6, (300, 10)))
    Yw = jnp.asarray(0.1 * rng.normal(size=(300, 6)))
    post_w = fit_gp(
        GPParams.create(length_scale=0.5, noise_variance=0.1),
        Xw, Yw, jitter=1e-4, normalize_y=True,
    )
    comp_w = compress_posterior(post_w, m=48)
    err_w = np.asarray(compression_error(post_w, comp_w, Xw))
    scale_w = np.abs(np.asarray(predict_mean(post_w, Xw))).max(axis=0)
    assert (err_w > 0.5 * scale_w).any()   # loudly wrong, as documented
