"""CLI smoke tests (train-gp -> evaluate-gp round trip, compare)."""

import json
import os

import numpy as np
import pytest

from unmanned_aerial_vehicles_tpu.cli import main


def test_train_then_evaluate(tmp_path, capsys, flight_csvs):
    data = flight_csvs[0]
    model = str(tmp_path / "gp.npz")

    assert main(["train-gp", "--data", data, "--output", model,
                 "--max-samples", "200"]) == 0
    assert os.path.exists(model)
    assert os.path.islink(str(tmp_path / "gp_model_latest.npz"))
    capsys.readouterr()

    prefix = str(tmp_path / "eval")
    assert main(["evaluate-gp", "--model", model, "--data", data,
                 "--output", prefix, "--full-analysis"]) == 0
    out = capsys.readouterr().out
    payload = json.loads(out[: out.index("}\n}") + 3])
    assert "global" in payload and "acc_only" in payload
    assert os.path.exists(prefix + "_metrics.csv")
    # the GPModelEvaluator surface: the three analysis figures
    for suffix in ("_distributions.png", "_uncertainty.png",
                   "_correlations.png"):
        assert os.path.exists(prefix + suffix)


def test_compare_command(capsys):
    assert main(["compare", "--duration", "5"]) == 0
    results = json.loads(capsys.readouterr().out)
    assert set(results) == {"hover", "circle", "figure8", "step"}


def test_bad_glob_errors():
    assert main(["train-gp", "--data", "/nonexistent/*.csv"]) == 1


def test_mission_command(capsys):
    assert main(["mission", "--duration", "25", "--amplitude", "3"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["phases_reached"] == 5
    assert abs(out["takeoff_altitude_m"] - 3.0) < 0.5


def test_mission_noisy_command(capsys):
    """The whole mission on EKF estimates, with the observer under wind."""
    assert main(["mission", "--duration", "30", "--amplitude", "3",
                 "--noisy", "--wind", "1.0", "0.5", "0",
                 "--disturbance-observer"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["phases_reached"] == 5
    assert out["estimate_rms_pos_m"] < 0.2
    assert np.isfinite(out["disturbance_est_tail"]).all()
    # guard: the observer needs the noisy mission
    assert main(["mission", "--duration", "5",
                 "--disturbance-observer"]) == 1


def test_online_command(tmp_path, capsys):
    model = str(tmp_path / "online.npz")
    assert main(["online", "--duration", "12", "--gp-capacity", "64",
                 "--refit-every", "100", "--save-model", model]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["gp_samples_collected"] > 30
    assert out["gp_active_final"] is True
    assert os.path.exists(model)


def test_fly_mpc12_command(capsys):
    assert main(["fly", "--controller", "mpc12", "--duration", "10",
                 "--amplitude", "2"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["rms_pos"] < 1.3  # reference's early 12-state run: 1.288 m


def test_train_gp_all_samples_sharded(tmp_path, capsys, flight_csvs):
    """--all-samples routes through the mesh-sharded CG trainer."""
    data = flight_csvs[0]
    model = str(tmp_path / "gp_full.npz")
    assert main(["train-gp", "--data", data, "--all-samples",
                 "--cg-iterations", "120", "--output", model]) == 0
    out = capsys.readouterr().out
    assert "sharded fit" in out and "over 8 device(s)" in out
    assert os.path.exists(model)


def test_fly_ilqr12(capsys):
    assert main(["fly", "--controller", "ilqr12", "--duration", "2",
                 "--amplitude", "2"]) == 0
    payload = json.loads(capsys.readouterr().out)
    assert payload["rms_pos"] < 3.0


@pytest.mark.parametrize("flag", [["--fast"], ["--ekf-relin", "tick"],
                                  ["--ekf-cov", "highest"]])
def test_fly_removed_flags_rejected(flag, capsys):
    """The options that chose kernel paths are gone: argparse rejects them
    loudly instead of ignoring them."""
    with pytest.raises(SystemExit) as e:
        main(["fly", "--controller", "mpc", "--duration", "2"] + flag)
    assert e.value.code == 2
    assert "unrecognized arguments" in capsys.readouterr().err


def test_tune_pid_command(tmp_path, capsys):
    out_path = str(tmp_path / "tuned.json")
    assert main(["tune", "--controller", "pid", "--duration", "5",
                 "--amplitude", "2", "--iterations", "5", "--save",
                 out_path]) == 0
    out = capsys.readouterr().out
    payload = json.loads(out[: out.rindex("}") + 1])
    assert payload["rms_pos_m_after"] <= payload["rms_pos_m_before"]
    assert os.path.exists(out_path)


def test_montecarlo_command(capsys):
    assert main(["montecarlo", "--controller", "mpc", "--duration", "4",
                 "--amplitude", "2", "--rollouts", "4"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert 0.0 <= out["success_rate"] <= 1.0
    assert out["rms_pos_m_p50"] <= out["rms_pos_m_p99"] + 1e-9


def test_fly_save_uavlog_roundtrip(tmp_path, capsys):
    log_path = str(tmp_path / "flight.uavlog")
    assert main(["fly", "--controller", "pid", "--duration", "4",
                 "--amplitude", "2", "--trajectory", "circle",
                 "--save-log", log_path]) == 0
    capsys.readouterr()
    assert main(["analyze", "--log", log_path]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["rms_pos"] >= 0.0


def test_fly_noisy_ekf(capsys):
    assert main(["fly", "--controller", "mpc", "--duration", "5",
                 "--amplitude", "2", "--trajectory", "circle",
                 "--noisy"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["rms_pos"] < 2.0


def test_fly_mppi12(capsys):
    assert main(["fly", "--controller", "mppi12", "--duration", "5",
                 "--amplitude", "2", "--trajectory", "circle"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["rms_pos"] < 1.3


def test_montecarlo_gpmpc_command(capsys):
    assert main(["montecarlo", "--controller", "gp-mpc", "--duration", "4",
                 "--amplitude", "2", "--rollouts", "4"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert 0.0 <= out["success_rate"] <= 1.0


def test_fly_pretrained_gp_model(tmp_path, capsys, flight_csvs):
    """train-gp -> fly --gp-model: the pretrained-runtime channel
    (GP_USE_MODEL/GP_MODEL_PATH, src/px4/mpc.py:1744-1750)."""
    data = flight_csvs[0]
    model = str(tmp_path / "gp.npz")
    assert main(["train-gp", "--data", data, "--output", model,
                 "--max-samples", "150"]) == 0
    capsys.readouterr()
    assert main(["fly", "--controller", "gp-mpc", "--duration", "4",
                 "--amplitude", "2", "--trajectory", "circle",
                 "--gp-model", model]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["rms_pos"] < 2.0


def test_fly_noisy_and_online(capsys):
    """--noisy (EKF in the loop) and --online (in-flight learning). Short
    flights; both must produce finite metric JSON, and --online needs the
    gp-mpc controller."""
    assert main(["fly", "--controller", "mpc", "--noisy",
                 "--duration", "3"]) == 0
    out = capsys.readouterr().out
    m = json.loads(out[: out.rindex("}") + 1])
    assert np.isfinite(m["rms_pos"])

    assert main(["fly", "--controller", "gp-mpc", "--online",
                 "--duration", "3"]) == 0
    out = capsys.readouterr().out
    m = json.loads(out[: out.rindex("}") + 1])
    assert np.isfinite(m["rms_pos"])
    assert main(["fly", "--controller", "mpc", "--online",
                 "--duration", "2"]) == 1


def test_fly_animate(tmp_path, capsys):
    gif = str(tmp_path / "replay.gif")
    assert main(["fly", "--controller", "pid", "--duration", "3",
                 "--amplitude", "2", "--trajectory", "circle",
                 "--animate", gif]) == 0
    out = capsys.readouterr().out
    assert "animation written" in out
    import os
    assert os.path.getsize(gif) > 10_000


def test_analyze_animate(tmp_path, capsys):
    log_path = str(tmp_path / "flight.npz")
    assert main(["fly", "--controller", "pid", "--duration", "3",
                 "--amplitude", "2", "--trajectory", "circle",
                 "--save-log", log_path]) == 0
    capsys.readouterr()
    gif = str(tmp_path / "replay.gif")
    assert main(["analyze", "--log", log_path, "--animate", gif]) == 0
    assert "animation written" in capsys.readouterr().out
    import os
    assert os.path.getsize(gif) > 10_000


def test_fly_direct_rate12(capsys):
    """direct-rate12 is a first-class --controller choice (the
    mpc_direct_rates node, VERDICT round-4 #4)."""
    assert main(["fly", "--controller", "direct-rate12", "--duration", "6",
                 "--amplitude", "2"]) == 0
    payload = json.loads(capsys.readouterr().out)
    assert payload["rms_pos"] < 1.5


def test_fly_ltv12_obstacle(capsys):
    """--controller ltv12 flies the 10 Hz LTV engine; --obstacle reserves
    the spherical rows and reports the measured clearance; other
    controllers reject --obstacle loudly."""
    assert main(["fly", "--controller", "ltv12",
                 "--duration", "8", "--trajectory", "circle",
                 "--amplitude", "1.5",
                 "--obstacle", "0,1.5,3.0,0.3"]) == 0
    out = capsys.readouterr().out
    payload = json.loads(out[out.index("{"):])
    assert payload["rms_pos"] < 1.0, payload
    assert "min_obstacle_clearance" in payload

    assert main(["fly", "--controller", "ltv12",
                 "--duration", "4", "--trajectory", "circle",
                 "--amplitude", "1.5"]) == 0
    payload = json.loads(capsys.readouterr().out.strip())
    assert payload["rms_pos"] < 1.0, payload

    assert main(["fly", "--controller", "mpc12", "--duration", "2",
                 "--obstacle", "0,0,3,0.3"]) == 1
    assert main(["fly", "--controller", "ltv12", "--duration", "2",
                 "--obstacle", "bogus"]) == 1


def test_fly_mpc12_noisy(capsys):
    """The 12-state family's estimator-in-the-loop surface (rigid-body
    EKF, estimation.noisy_rigid_mpc_rollout): flies, tracks, and the
    noisy-tier banner reports the estimate error."""
    assert main(["fly", "--controller", "mpc12", "--duration", "4",
                 "--amplitude", "2", "--trajectory", "circle",
                 "--noisy"]) == 0
    raw = capsys.readouterr().out
    assert "# noisy tier: mpc12" in raw
    out = json.loads(raw[raw.index("{"):])
    assert out["rms_pos"] < 2.0


def test_fly_direct_rate12_noisy(capsys):
    """direct-rate12 --noisy estimates over the engine's own rate-lag
    plant (no yaw channel)."""
    assert main(["fly", "--controller", "direct-rate12", "--duration", "4",
                 "--amplitude", "2", "--trajectory", "circle",
                 "--noisy"]) == 0
    raw = capsys.readouterr().out
    assert "rate-lag EKF" in raw
    out = json.loads(raw[raw.index("{"):])
    assert out["rms_pos"] < 2.0


def test_fly_ltv12_noisy(capsys):
    """ltv12 --noisy runs the multi-rate estimation loop (100 Hz EKF
    under the 10 Hz solve, estimation.noisy_ltv_rollout)."""
    assert main(["fly", "--controller", "ltv12", "--duration", "3",
                 "--amplitude", "1.5", "--trajectory", "circle",
                 "--noisy"]) == 0
    raw = capsys.readouterr().out
    assert "# noisy tier: ltv12" in raw
    out = json.loads(raw[raw.index("{"):])
    assert out["rms_pos"] < 1.0


def test_fly_noisy_rejects_unwired_controllers(capsys):
    assert main(["fly", "--controller", "pid", "--duration", "2",
                 "--noisy"]) == 1
    assert main(["fly", "--controller", "mpc12", "--duration", "2",
                 "--noisy", "--push", "1", "0", "0"]) == 1


def test_fly_wind_disturbance_observer(capsys):
    """--wind + --disturbance-observer: the augmented-EKF observer flies
    the campaign's windy plant and reports its accel-disturbance estimate
    (estimation/disturbance.py)."""
    assert main(["fly", "--controller", "mpc", "--duration", "8",
                 "--noisy", "--wind", "1.5", "0.8", "0",
                 "--disturbance-observer", "--preview"]) == 0
    out = capsys.readouterr().out
    assert "disturbance observer" in out
    m = json.loads(out[out.index("{"):])
    assert np.isfinite(m["rms_pos"])
    # non-residual-channel controllers and bare ltv12 --wind keep
    # rejecting loudly
    assert main(["fly", "--controller", "mpc12", "--duration", "2",
                 "--noisy", "--disturbance-observer"]) == 1
    assert main(["fly", "--controller", "ltv12", "--duration", "2",
                 "--wind", "1", "0", "0"]) == 1
    assert main(["fly", "--controller", "ilqr12", "--duration", "2",
                 "--noisy", "--disturbance-observer"]) == 1


def test_fly_gust(capsys):
    """--gust: a wind step-change on the true plant mid-flight; the
    observer's reported tail estimate reflects the POST-gust wind."""
    assert main(["fly", "--controller", "mpc", "--duration", "10",
                 "--noisy", "--wind", "1.5", "0", "0",
                 "--gust", "3", "-1.5", "0", "0",
                 "--disturbance-observer", "--preview"]) == 0
    out = capsys.readouterr().out
    m = json.loads(out[out.index("{"):])
    assert np.isfinite(m["rms_pos"])
    # the printed tail-mean disturbance must point INTO the post-gust wind
    line = [ln for ln in out.splitlines() if "disturbance observer" in ln]
    assert line and "-" in line[0].split("[")[1]
    # ... and composes with in-flight ONLINE learning (ring-buffer GP on
    # EKF estimates while the wind changes)
    assert main(["fly", "--controller", "gp-mpc", "--online",
                 "--noisy", "--duration", "6", "--wind", "1.5", "0", "0",
                 "--gust", "2", "-1.5", "0", "0"]) == 0
    out = capsys.readouterr().out
    assert "online+noisy" in out
    # guard rails: --gust without --wind / --noisy
    assert main(["fly", "--controller", "mpc", "--duration", "2",
                 "--noisy", "--gust", "1", "1", "0", "0"]) == 1
    assert main(["fly", "--controller", "mpc", "--duration", "2",
                 "--wind", "1", "0", "0",
                 "--gust", "1", "0", "1", "0"]) == 1


def test_fly_push_disturbance_observer_direct_rate12(capsys):
    """direct-rate12: --push (constant unmodelled accel on the true
    plant) + --disturbance-observer via the engine's residual channel."""
    assert main(["fly", "--controller", "direct-rate12", "--duration", "8",
                 "--noisy", "--push", "0.6", "-0.4", "0.3",
                 "--disturbance-observer"]) == 0
    out = capsys.readouterr().out
    assert "disturbance observer (direct-rate12)" in out
    m = json.loads(out[out.index("{"):])
    assert np.isfinite(m["rms_pos"])
    # --push is the direct-rate12 scenario knob only
    assert main(["fly", "--controller", "mpc", "--duration", "2",
                 "--noisy", "--push", "1", "0", "0"]) == 1
    # --push-step: the force STEPS at t=T (the torque family's --gust);
    # the printed tail estimate reflects the POST-step force
    assert main(["fly", "--controller", "direct-rate12", "--duration", "16",
                 "--noisy", "--push", "0.6", "-0.4", "0.3",
                 "--push-step", "8", "-0.5", "0.7", "-0.2",
                 "--disturbance-observer"]) == 0
    out = capsys.readouterr().out
    line = [ln for ln in out.splitlines()
            if "disturbance observer (direct-rate12)" in ln]
    assert line
    vals = [float(v) for v in
            line[0].split("[")[1].split("]")[0].split()]
    # tail mean over the second half (step at 8 s of 16): post-step force
    # dominates — sign pattern must match (-0.5, +0.7, -0.2)
    assert vals[0] < 0.0 < vals[1] and vals[2] < 0.0, vals
    # guard rails: --push-step needs --push, --noisy and direct-rate12
    assert main(["fly", "--controller", "direct-rate12", "--duration", "2",
                 "--noisy", "--push-step", "1", "1", "0", "0"]) == 1
    assert main(["fly", "--controller", "mpc", "--duration", "2", "--noisy",
                 "--push", "1", "0", "0",
                 "--push-step", "1", "0", "1", "0"]) == 1


def test_fly_ltv12_wind_disturbance_observer(capsys):
    """ltv12 --noisy: the 100 Hz observer's estimate feeds the 10 Hz LTV
    solve's residual rows; a windy GZ plant flies against the nominal
    process model."""
    assert main(["fly", "--controller", "ltv12", "--duration", "6",
                 "--noisy", "--wind", "2.5", "1.5", "0",
                 "--disturbance-observer"]) == 0
    out = capsys.readouterr().out
    assert "disturbance observer (ltv12" in out
    m = json.loads(out[out.index("{"):])
    assert np.isfinite(m["rms_pos"])
