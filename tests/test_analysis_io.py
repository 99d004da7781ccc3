"""GP analysis module, plotting utilities, native CSV loader."""

import os

import jax.numpy as jnp
import numpy as np

from unmanned_aerial_vehicles_tpu.gp import fit_residual_gp, predict
from unmanned_aerial_vehicles_tpu.gp.analysis import (
    analyze_gp_model,
    generate_generic_test_points,
    generate_physical_test_points,
)
from unmanned_aerial_vehicles_tpu.io import load_gp_dataset
from unmanned_aerial_vehicles_tpu.io.fast_csv import (
    load_numeric_csv,
    native_available,
)
from unmanned_aerial_vehicles_tpu.loop import run_comparison
from unmanned_aerial_vehicles_tpu.metrics.plots import (
    plot_comparison,
    plot_flight_log,
)

import pytest


@pytest.fixture
def flight_csv(flight_csvs):
    return flight_csvs[0]


def test_physical_test_points():
    pts = generate_physical_test_points(500)
    assert pts.shape == (800, 10)  # 500 + 100 hover + 200 trajectory
    assert np.isfinite(pts).all()
    g = generate_generic_test_points(7, 100)
    assert g.shape == (100, 7) and np.abs(g).max() <= 1.0


def test_analyze_gp_model(flight_csv):
    X, Y = load_gp_dataset(flight_csv)
    post = fit_residual_gp(jnp.asarray(X[:200]), jnp.asarray(Y[:200]))

    def predict_fn(pts):
        m, v = predict(post, jnp.asarray(pts))
        return np.asarray(m), np.asarray(v)

    report = analyze_gp_model(predict_fn, generate_physical_test_points(200))
    assert report["n_test_points"] == 500
    assert set(report["prediction_stats"]) == {
        "res_dx", "res_dy", "res_dz", "res_dvx", "res_dvy", "res_dvz"
    }
    assert report["uncertainty_stats"]["overall_mean_std"] > 0
    assert set(report["uncertainty_stats"]["per_regime"]) == {
        "envelope", "hover", "trajectory"
    }
    # physical envelope is far outside flight data -> more uncertain there
    pr = report["uncertainty_stats"]["per_regime"]
    assert pr["envelope"] >= pr["hover"] * 0.5


def test_plot_flight_log(tmp_path):
    T = 100
    rng = np.random.default_rng(0)
    log = {
        "state": rng.normal(size=(T, 12)) * 0.1,
        "pos_ref": np.zeros((T, 3)),
        "thrust": np.full(T, 0.7),
    }
    path = plot_flight_log(log, str(tmp_path / "flight.png"))
    assert os.path.getsize(path) > 10_000


def test_plot_comparison(tmp_path):
    outs = run_comparison("circle", duration=5.0)
    path = plot_comparison(
        {k: np.asarray(v) for k, v in outs.items()},
        str(tmp_path / "cmp.png"),
        "circle",
    )
    assert os.path.getsize(path) > 10_000


def test_native_csv_parity(flight_csv):
    data_native = load_numeric_csv(flight_csv, 16)
    data_np = np.atleast_2d(np.genfromtxt(flight_csv, delimiter=",", skip_header=1))
    np.testing.assert_array_equal(data_native, data_np)
    assert native_available() or True  # informational; fallback is also valid


def test_native_csv_bad_file(tmp_path):
    bad = tmp_path / "bad.csv"
    bad.write_text("a,b\n1,2,3\n")
    out = load_numeric_csv(str(bad), 3)  # native rejects, numpy fallback
    assert out.shape[1] == 3


def test_native_csv_rejects_extra_columns(tmp_path):
    """A row with MORE than n_cols must not be silently truncated: the
    native parser returns -3 so the loader falls back to genfromtxt, whose
    true width then fails load_gp_dataset's schema check — matching the
    fallback-only environments (ADVICE round 1)."""
    import ctypes

    from unmanned_aerial_vehicles_tpu.io import fast_csv

    wide = tmp_path / "wide.csv"
    wide.write_text("a,b,c\n1,2,3,4\n5,6,7,8\n")

    lib = fast_csv._get_lib()
    if lib is not None:
        buf = np.empty((2, 3), np.float64)
        rc = lib.uav_parse_csv(
            str(wide).encode(),
            buf.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            2, 3, 1,
        )
        assert rc == -3

    out = load_numeric_csv(str(wide), 3)  # falls back; keeps true width
    assert out.shape[1] == 4


def test_analyze_cli_on_artifact(tmp_path, capsys):
    import json as _json

    from unmanned_aerial_vehicles_tpu.cli import main
    from unmanned_aerial_vehicles_tpu.io import save_flight_log

    T = 40
    rng2 = np.random.default_rng(1)
    log = {
        "state": rng2.normal(size=(T, 12)) * 0.1,
        "pos_ref": np.zeros((T, 3)),
        "thrust": np.full(T, 0.7),
    }
    path = str(tmp_path / "f.npz")
    save_flight_log(path, log)
    png = str(tmp_path / "f.png")
    assert main(["analyze", "--log", path, "--plot", png]) == 0
    out = capsys.readouterr().out
    payload = _json.loads(out[: out.rindex("}") + 1])
    assert "rms_pos" in payload
    assert os.path.getsize(png) > 10_000


def test_measure_time_and_metrics_logger(tmp_path):
    from unmanned_aerial_vehicles_tpu.metrics import (
        MetricsLogger,
        measure_time,
        mpc_metrics_summary,
    )

    @measure_time
    def slowish():
        return 42

    assert slowish() == 42 and len(slowish.timings) == 1

    logger = MetricsLogger(str(tmp_path))
    m = mpc_metrics_summary(
        np.zeros((10, 9)), np.ones((10, 4)), np.full(3, 1e-3)
    )
    path = logger.save_mpc_metrics(m)
    assert os.path.exists(path)


def test_gp_checkpoint_metadata(tmp_path, flight_csv):
    import jax.numpy as jnp

    from unmanned_aerial_vehicles_tpu.gp import fit_residual_gp
    from unmanned_aerial_vehicles_tpu.io import save_gp_checkpoint

    X, Y = load_gp_dataset(flight_csv)
    post = fit_residual_gp(jnp.asarray(X[:50]), jnp.asarray(Y[:50]))
    path = str(tmp_path / "m.npz")
    save_gp_checkpoint(path, post, X[:50], Y[:50], jitter=1e-4,
                       metadata={"training_count": 3})
    data = np.load(path)
    assert int(data["meta_training_count"]) == 3


def test_run_complete_gp_analysis(tmp_path, flight_csv):
    """The reference's run_complete_evaluation surface
    (gp_evaluation.py:551-575): quantitative report + the three figures
    (prediction distributions, uncertainty-vs-state, output correlations)."""
    from unmanned_aerial_vehicles_tpu.gp.analysis import (
        run_complete_gp_analysis,
    )

    X, Y = load_gp_dataset(flight_csv)
    post = fit_residual_gp(jnp.asarray(X[:150]), jnp.asarray(Y[:150]))

    def predict_fn(pts):
        m, v = predict(post, jnp.asarray(pts))
        return np.asarray(m), np.asarray(v)

    prefix = str(tmp_path / "gp")
    report = run_complete_gp_analysis(
        predict_fn, prefix, generate_physical_test_points(200)
    )
    # raw arrays stripped -> JSON-serialisable
    import json
    json.dumps(report)
    corr = np.asarray(report["output_correlations"])
    assert corr.shape == (6, 6)
    np.testing.assert_allclose(np.diag(corr), 1.0, atol=1e-12)
    np.testing.assert_allclose(corr, corr.T, atol=1e-12)
    import os
    for suffix in ("_distributions.png", "_uncertainty.png",
                   "_correlations.png"):
        assert os.path.getsize(prefix + suffix) > 10_000


def test_animate_flight(tmp_path):
    """Streaming-visualizer role (results_visualizer.py:17-30): animated
    replay renders headless to GIF; .mp4 falls back to GIF without ffmpeg."""
    from unmanned_aerial_vehicles_tpu.metrics.animate import animate_flight

    T = 120
    t = np.arange(T) * 0.02
    log = {
        "state": np.stack(
            [np.sin(t), np.cos(t), 3 + 0 * t, 0 * t, 0 * t, 0 * t], axis=1
        ),
        "pos_ref": np.stack([np.sin(t + 0.05), np.cos(t + 0.05), 3 + 0 * t],
                            axis=1),
        "thrust": 0.5 + 0.1 * np.sin(3 * t),
    }
    path = animate_flight(log, str(tmp_path / "replay.gif"), stride=20, fps=8)
    assert path.endswith(".gif") and os.path.getsize(path) > 10_000
    # no-thrust logs render with the panel disabled
    log.pop("thrust")
    path2 = animate_flight(log, str(tmp_path / "replay2.mp4"), stride=30,
                           fps=8)
    assert os.path.getsize(path2) > 5_000
