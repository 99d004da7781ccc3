"""Offline GP evaluation, per-dim GP trainer and comparison-harness tests
(SURVEY.md section 6, GP offline rows), on the seeded synthetic corpus."""

import csv

import jax.numpy as jnp
import numpy as np
import pytest

from unmanned_aerial_vehicles_tpu.gp import (
    evaluate_gp,
    evaluate_gp_residuals,
    fit_per_dim_gp,
    fit_residual_gp,
    per_dim_training_report,
    predict_mean,
    predict_per_dim,
    write_metrics_csv,
)
from unmanned_aerial_vehicles_tpu.io import load_gp_dataset
from unmanned_aerial_vehicles_tpu.loop import (
    comparison_summary,
    run_comparison,
    run_full_comparison,
)
from unmanned_aerial_vehicles_tpu.metrics import (
    constraint_violations,
    gp_metrics_summary,
    mpc_metrics_summary,
)

@pytest.fixture
def flight_csv(flight_csvs):
    return flight_csvs[0]


def test_evaluator_with_our_gp(tmp_path, flight_csv):
    """Our JAX GP through the evaluator: must improve over nominal in-sample
    and write the reference CSV layout."""
    X, Y = load_gp_dataset(flight_csv)
    Xj, Yj = jnp.asarray(X[:400]), jnp.asarray(Y[:400])
    post = fit_residual_gp(Xj, Yj)
    results = evaluate_gp(
        lambda x: np.asarray(predict_mean(post, jnp.asarray(x))),
        X[:400],
        Y[:400],
        save_prefix=str(tmp_path / "ours"),
    )
    assert results["global"]["improvement_%"] > 50.0  # in-sample fit
    with open(tmp_path / "ours_metrics.csv") as f:
        rows = list(csv.DictReader(f))
    assert [r["component"] for r in rows] == ["dx", "dy", "dz", "dvx", "dvy", "dvz"]


def test_evaluate_gp_residuals_identities(rng):
    R = rng.normal(size=(50, 6))
    perfect = evaluate_gp_residuals(R, R)
    assert perfect["global"]["mse_gp"] == 0.0
    assert perfect["global"]["improvement_%"] == pytest.approx(100.0)
    zero = evaluate_gp_residuals(R, np.zeros_like(R))
    assert zero["global"]["improvement_%"] == pytest.approx(0.0)
    assert zero["global"]["mse_nom"] == pytest.approx(zero["global"]["mse_gp"])


def test_per_dim_gp_fits_and_predicts(flight_csv):
    X, Y = load_gp_dataset(flight_csv)
    Xtr, Ytr = jnp.asarray(X[:250]), jnp.asarray(Y[:250])
    Xte, Yte = jnp.asarray(X[250:300]), jnp.asarray(Y[250:300])

    model = fit_per_dim_gp(Xtr, Ytr)
    mean, var = predict_per_dim(model, Xte)
    assert mean.shape == (50, 6) and var.shape == (50, 6)
    assert bool(jnp.all(var > 0))

    report = per_dim_training_report(model, Xte, Yte, Xtr, Ytr)
    assert set(report) == {
        "x_residual", "y_residual", "z_residual",
        "vx_residual", "vy_residual", "vz_residual",
    }
    # in-sample prediction should beat predicting the mean on train data
    mean_tr, _ = predict_per_dim(model, Xtr)
    mse_gp = float(jnp.mean((mean_tr - Ytr) ** 2))
    mse_mean = float(jnp.mean((Ytr - jnp.mean(Ytr, axis=0)) ** 2))
    assert mse_gp < mse_mean


def test_comparison_harness_matches_reference_behaviour():
    """Fig-8: the 'GP-MPC' surrogate must beat PID roughly as published
    (PID avg ~0.37 m vs MPC ~0.15 m, docs/images/comparison_figure8.png)."""
    outs = run_comparison("figure8", duration=30.0, dt=0.1, dtype=jnp.float64)
    s = comparison_summary(outs)
    assert s["winner"] == "GP-MPC"
    assert 0.05 < s["mpc_avg_error"] < 0.35
    assert s["pid_avg_error"] > s["mpc_avg_error"]
    assert np.isfinite(s["pid_rmse"]) and np.isfinite(s["mpc_rmse"])


def test_full_comparison_all_trajectories():
    results = run_full_comparison(duration=10.0)
    assert set(results) == {"hover", "circle", "figure8", "step"}
    for s in results.values():
        assert np.isfinite(s["pid_avg_error"])
        assert np.isfinite(s["mpc_avg_error"])


def test_metrics_summaries(rng):
    e = rng.normal(size=(100, 9))
    u = rng.normal(size=(100, 4))
    st = np.abs(rng.normal(size=8)) * 1e-3
    cv = constraint_violations(u, -2.0 * np.ones(4), 2.0 * np.ones(4))
    m = mpc_metrics_summary(e, u, st, cv)
    np.testing.assert_allclose(m["position_rmse"], np.sqrt(np.mean(e[:, :3] ** 2)))
    np.testing.assert_allclose(m["control_effort"], np.mean(np.sum(u**2, axis=1)))
    assert 0.0 <= m["constraint_violation_rate"] <= 1.0
    assert m["max_solve_time"] >= m["mean_solve_time"]

    g = gp_metrics_summary(rng.normal(size=(50, 6)), np.abs(rng.normal(size=(50, 6))))
    assert len(g["mean_prediction_error"]) == 6
    assert g["rmse"] > 0


def test_metrics_csv_files_skipped_in_multi_load(tmp_path, flight_csv):
    """The gp_datasets dir mixes flight CSVs with *_metrics.csv analysis
    outputs (9 columns); the multi-file loader must skip those (found by
    driving the fly CLI with the default glob)."""
    import warnings
    from unmanned_aerial_vehicles_tpu.io import load_gp_datasets

    metrics = str(tmp_path / "flight_metrics.csv")
    with open(metrics, "w") as f:
        f.write("component,mse_nom,mse_gp,rmse_nom,rmse_gp,improvement_%,"
                "r2_nom,r2_gp,frac_better\n")
        f.write("dx,1,1,1,1,0,0,0,0\n")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        X, Y = load_gp_datasets([flight_csv, metrics])
    X_only, _ = load_gp_datasets([flight_csv])
    assert X.shape == X_only.shape


def test_per_dim_residuals_drive_mpc(flight_csv):
    from unmanned_aerial_vehicles_tpu.gp import (
        build_horizon_residuals_per_dim,
        fit_per_dim_gp,
    )

    X, Y = load_gp_dataset(flight_csv)
    model = fit_per_dim_gp(jnp.asarray(X[:200]), jnp.asarray(Y[:200]))
    Xg = jnp.tile(jnp.asarray(X[0, :6])[None, :], (11, 1))
    Ug = jnp.tile(jnp.asarray(X[0, 6:10])[None, :], (10, 1))
    D = build_horizon_residuals_per_dim(model, Xg, Ug)
    assert D.shape == (10, 6)
    np.testing.assert_allclose(np.asarray(D[:, 0:3]), 0.0)
    assert bool(jnp.all(jnp.isfinite(D)))
    assert float(jnp.max(jnp.abs(D[:, 3:6]))) > 0


def test_per_dim_gp_with_hyperopt(flight_csv):
    """The optimize=True path: vmapped per-dimension ARD LML ascent."""
    X, Y = load_gp_dataset(flight_csv)
    Xtr, Ytr = jnp.asarray(X[:120]), jnp.asarray(Y[:120])
    Xte, Yte = jnp.asarray(X[120:160]), jnp.asarray(Y[120:160])

    plain = fit_per_dim_gp(Xtr, Ytr)
    tuned = fit_per_dim_gp(Xtr, Ytr, optimize=True, opt_steps=25)

    def mse(model):
        mean, _ = predict_per_dim(model, Xte)
        return float(jnp.mean((mean - Yte) ** 2))

    assert np.isfinite(mse(tuned))
    # tuned hyperparameters must differ from the defaults (opt actually ran)
    ls_plain = np.asarray(plain.posteriors.params.log_length_scale)
    ls_tuned = np.asarray(tuned.posteriors.params.log_length_scale)
    assert np.max(np.abs(ls_plain - ls_tuned)) > 1e-3
