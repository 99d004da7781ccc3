"""Command-line entry points.

Replaces the reference's ad-hoc launch surface — the shell driver
``/root/reference/run_mpc_velocity_control.sh:1-220``, the offline trainer
``src/px4/train_gp_offline.py:79-247`` and evaluator
``src/px4/evaluate_gp_offline.py:371-406``, plus the env-var config channel
(``GP_DATA_COLLECTION``/``GP_USE_MODEL``/``GP_MODEL_PATH``,
``src/px4/mpc.py:1744-1750``) — with argparse subcommands over the typed
config dataclasses:

    python -m unmanned_aerial_vehicles_tpu train-gp --data 'gp_datasets/*.csv'
    python -m unmanned_aerial_vehicles_tpu evaluate-gp --model gp.npz --data f.csv
    python -m unmanned_aerial_vehicles_tpu fly --controller gp-mpc --duration 60
    python -m unmanned_aerial_vehicles_tpu compare
    python -m unmanned_aerial_vehicles_tpu sweep --flights 64
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
import time


def _cmd_train_gp(args) -> int:
    import jax.numpy as jnp

    from .gp import log_marginal_likelihood, optimize_hyperparameters
    from .gp.residual_gp import ResidualGPConfig, default_params
    from .io import save_gp_checkpoint
    from .gp.exact_gp import fit_gp

    max_samples = None if args.all_samples else args.max_samples
    corpus = _load_gp_corpus(args.data, max_samples)
    if corpus is None:
        print(f"no CSV files match {args.data!r}", file=sys.stderr)
        return 1
    X, Y, source = corpus
    print(f"loaded {X.shape[0]} samples from {source}")

    cfg = ResidualGPConfig()

    if args.all_samples:
        # full-corpus fit, rows sharded over the device mesh (removes the
        # reference's 10k cap, train_gp_offline.py:155-163) — distributed
        # Gram matvec + preconditioned CG with psum/all_gather collectives
        from .parallel import (
            fit_residual_gp_sharded,
            make_mesh,
            optimize_hyperparameters_sharded,
            predict_mean_sharded,
        )

        mesh = make_mesh()
        params = default_params(cfg)
        if args.optimize:
            # full-corpus LML ascent: stochastic-trace gradients through the
            # sharded CG (no Cholesky/logdet anywhere)
            import jax

            t0 = time.time()
            params = optimize_hyperparameters_sharded(
                params, X, Y, mesh=mesh, config=cfg, steps=args.opt_steps,
                num_probes=16, cg_iterations=args.cg_iterations,
                key=jax.random.PRNGKey(0),
            )
            print(
                f"hyperparameters optimised on the full corpus in "
                f"{time.time()-t0:.1f}s: ls={float(params.length_scale):.4f} "
                f"sf2={float(params.signal_variance):.4f} "
                f"sn2={float(params.noise_variance):.4f}"
            )
        t0 = time.time()
        post_s = fit_residual_gp_sharded(
            X, Y, mesh=mesh, config=cfg, params=params,
            cg_iterations=args.cg_iterations,
        )
        mean = predict_mean_sharded(post_s, jnp.asarray(X[:4]), mesh=mesh)
        print(
            f"sharded fit: n={X.shape[0]} over {mesh.devices.size} device(s) "
            f"in {time.time()-t0:.1f}s, CG residual "
            f"{float(post_s.cg_residual):.2e}, smoke predict "
            f"{['%.4f' % v for v in mean[0][:3]]}"
        )
        save_gp_checkpoint(args.output, post_s.to_gp_posterior(), X, Y,
                           jitter=cfg.alpha)
        print(f"saved checkpoint to {args.output}")
        return 0
    # precision follows the environment: f64 when JAX_ENABLE_X64 is set
    # (offline parity work), f32 otherwise (device-friendly default)
    Xj, Yj = jnp.asarray(X), jnp.asarray(Y)
    params = default_params(cfg)
    if args.optimize:
        t0 = time.time()
        params, nll = optimize_hyperparameters(
            params, Xj, Yj, jitter=cfg.alpha, normalize_y=True, steps=args.opt_steps
        )
        print(f"hyperparameters optimised in {time.time()-t0:.1f}s, nll={float(nll):.2f}")
    post = fit_gp(params, Xj, Yj, jitter=cfg.alpha, normalize_y=True)
    lml = log_marginal_likelihood(params, Xj, Yj, jitter=cfg.alpha, normalize_y=True)
    print(f"fitted GP: n={X.shape[0]}, log marginal likelihood={float(lml):.2f}")

    out = args.output
    save_gp_checkpoint(out, post, X, Y, jitter=cfg.alpha)
    # 'latest' symlink like train_gp_offline.py:205-214
    latest = os.path.join(os.path.dirname(out) or ".", "gp_model_latest.npz")
    try:
        if os.path.islink(latest) or os.path.exists(latest):
            os.remove(latest)
        os.symlink(os.path.basename(out), latest)
    except OSError:
        pass
    print(f"saved checkpoint to {out} (+ gp_model_latest.npz symlink)")
    return 0


def _cmd_evaluate_gp(args) -> int:
    import jax.numpy as jnp
    import numpy as np

    from .gp import evaluate_gp, predict, predict_mean
    from .io import load_gp_checkpoint, load_gp_dataset

    if args.model.endswith(".pkl"):
        from .io import load_reference_gp

        kind, loaded, _ = load_reference_gp(args.model)
        if kind != "single":
            print("evaluate-gp needs a single-GP model", file=sys.stderr)
            return 1
        post = loaded
    else:
        post, _, _, _, _ = load_gp_checkpoint(args.model)
    X, Y = load_gp_dataset(args.data, residual_norm_limit=np.inf)
    prefix = args.output or os.path.splitext(args.data)[0]
    results = evaluate_gp(
        lambda x: np.asarray(predict_mean(post, jnp.asarray(x))), X, Y,
        save_prefix=prefix,
    )
    print(json.dumps({k: results[k] for k in ("global", "acc_only", "fractions")}, indent=2))
    print(f"per-component metrics written to {prefix}_metrics.csv")

    if args.full_analysis:
        # the GPModelEvaluator surface (gp_evaluation.py:551-575):
        # physical test regimes, uncertainty analysis + the three figures
        from .gp.analysis import run_complete_gp_analysis

        def predict_fn(pts):
            m, v = predict(post, jnp.asarray(pts))
            return np.asarray(m), np.asarray(v)

        report = run_complete_gp_analysis(predict_fn, prefix)
        print(json.dumps(
            {k: report[k] for k in ("n_test_points", "uncertainty_stats")},
            indent=2,
        ))
        print(f"analysis figures written to {prefix}_distributions.png, "
              f"{prefix}_uncertainty.png, {prefix}_correlations.png")
    return 0


def _cmd_fly(args) -> int:
    import jax
    import jax.numpy as jnp
    import numpy as np

    from .control.mpc_linear import LinearMPC, LinearMPCConfig
    from .gp import build_horizon_residuals
    from .gp.residual_gp import ResidualGPConfig
    from .loop import FlightLoopConfig, mpc_flight_rollout, pid_flight_rollout
    from .metrics import tracking_metrics

    cfg = FlightLoopConfig()
    num_steps = int(args.duration / cfg.control_dt)
    ref = _reference_fn(args.trajectory, args.amplitude, cfg.takeoff_height)

    if args.noisy and args.controller == "pid":
        print("--noisy supports mpc/gp-mpc (PX4-surrogate EKF), the "
              "12-state family (rigid-body / rate-lag EKF) and ltv12 "
              "(multi-rate: 100 Hz EKF under the 10 Hz solve)",
              file=sys.stderr)
        return 1
    if args.wind is not None and not (
        args.controller in ("mpc", "gp-mpc")
        or (args.controller == "ltv12" and args.noisy)
    ):
        print("--wind (steady world-frame wind on the true plant) is "
              "wired for the mpc/gp-mpc family and ltv12 --noisy; the "
              "campaign tool (tools/run_campaign.py) drives the other "
              "scenarios", file=sys.stderr)
        return 1
    if args.disturbance_observer:
        if not args.noisy or args.controller not in (
            "mpc", "gp-mpc", "direct-rate12", "ltv12"
        ):
            print("--disturbance-observer is the augmented-EKF wind/"
                  "mismatch observer: requires --noisy and --controller "
                  "mpc/gp-mpc (6-state family), direct-rate12 or ltv12 "
                  "(the 12-state residual-channel engines) "
                  "(estimation.disturbance)", file=sys.stderr)
            return 1
    if args.push is not None and args.controller != "direct-rate12":
        print("--push (a constant unmodelled acceleration on the TRUE "
              "plant) is the direct-rate12 scenario knob; the 6-state "
              "family uses --wind", file=sys.stderr)
        return 1
    if args.push_step is not None and (
        args.push is None or not args.noisy
        or args.controller != "direct-rate12"
    ):
        print("--push-step T AX AY AZ (the unmodelled force steps at t=T "
              "on the TRUE plant — the torque family's --gust) requires "
              "--push (the pre-step force), --noisy and "
              "--controller direct-rate12", file=sys.stderr)
        return 1
    if args.gust is not None:
        if args.wind is None or not args.noisy:
            print("--gust T WX WY WZ (a wind step-change at t=T on the "
                  "TRUE plant) requires --wind (the pre-gust wind) and "
                  "--noisy", file=sys.stderr)
            return 1
    body6 = None
    wind_fn6 = None
    if args.wind is not None:
        from .models import RigidBodyParams

        body6 = RigidBodyParams(wind=tuple(args.wind))
        if args.gust is not None:
            import jax.numpy as _jnp

            t_g = float(args.gust[0])
            w_pre = _jnp.asarray(args.wind, _jnp.float32)
            w_post = _jnp.asarray(args.gust[1:4], _jnp.float32)
            wind_fn6 = lambda t: _jnp.where(t < t_g, w_pre, w_post)
    if args.obstacle and args.controller != "ltv12":
        print("--obstacle is the LTV engine's constraint class: use "
              "--controller ltv12 (mpc_controller.py:223-316)",
              file=sys.stderr)
        return 1
    if args.controller == "pid":
        # campaign-calibrated plant: the PID bags hover at ~0.7 normalized
        # thrust (see models.px4_surrogate.PID_CAMPAIGN_RATE_LOOP)
        from .models import PID_CAMPAIGN_RATE_LOOP

        outs = jax.jit(
            lambda: pid_flight_rollout(
                ref, num_steps, cfg=cfg, rate_loop=PID_CAMPAIGN_RATE_LOOP
            )
        )()
    elif args.controller == "ltv12":
        # cvxpy-LTV-equivalent tracking MPC at its own 10 Hz cadence on
        # the GZ quadrotor (mpc_controller.py:123-368), with optional
        # spherical obstacles (--obstacle, repeatable)
        from .control import LTVTrackingMPC
        from .models import GZ_QUADROTOR_PARAMS, rigid_body_rk4_substeps

        LDT = 0.1
        obstacles = None
        n_obs = 0
        if args.obstacle:
            try:
                rows = [tuple(float(v) for v in s.split(",")) for s in args.obstacle]
            except ValueError:
                print("--obstacle expects X,Y,Z,R (numbers)", file=sys.stderr)
                return 1
            if any(len(r) != 4 for r in rows):
                print("--obstacle expects exactly 4 values: X,Y,Z,R",
                      file=sys.stderr)
                return 1
            obstacles = jnp.asarray(rows, jnp.float32)
            n_obs = len(rows)
        mpc_ltv = LTVTrackingMPC(num_obstacles=n_obs, obstacle_margin=0.2)
        N_ltv = mpc_ltv.mpc.config.horizon
        mg_gz = GZ_QUADROTOR_PARAMS.mass * GZ_QUADROTOR_PARAMS.gravity
        steps10 = max(1, int(args.duration / LDT))

        def ref12_at(ts):
            pos, _ = jax.vmap(ref)(ts)
            return jnp.concatenate(
                [jnp.asarray(pos, jnp.float32),
                 jnp.zeros((ts.shape[0], 9), jnp.float32)], axis=1)

        def plant_ltv(x, u):
            return rigid_body_rk4_substeps(
                x, u, GZ_QUADROTOR_PARAMS, LDT, substeps=2)

        x0_ltv = ref12_at(jnp.zeros((1,), jnp.float32))[0]
        if args.noisy:
            # multi-rate estimation tier: plant + rigid-body EKF at 100 Hz,
            # the LTV solve every 10th plant tick flying the ESTIMATE — the
            # reference's 100 Hz plant / 10 Hz cvxpy rate split
            # (main.py:814-826) with the PX4-EKF2 role in-graph
            # (estimation.noisy_ltv_rollout)
            from .estimation import EKFConfig
            from .estimation.noisy_loop import noisy_ltv_rollout

            def window_at(i):
                ts = (i + jnp.arange(N_ltv + 1)).astype(jnp.float32) * LDT
                return ref12_at(ts)

            ltv_body = GZ_QUADROTOR_PARAMS
            if args.wind is not None:
                ltv_body = ltv_body.replace(wind=tuple(args.wind))
            outs_ltv = jax.jit(lambda: noisy_ltv_rollout(
                mpc_ltv, window_at, steps10, jax.random.PRNGKey(args.seed),
                ekf_cfg=EKFConfig(), body=ltv_body,
                obstacles=obstacles,
                disturbance_observer=(
                    True if args.disturbance_observer else None
                ),
            ))()
            est_rms = jnp.sqrt(jnp.mean(jnp.sum(
                (outs_ltv["state_est"][:, 0:3]
                 - outs_ltv["state"][:, 0:3]) ** 2, -1)))
            print(f"# noisy tier: ltv12, 100 Hz EKF under the 10 Hz "
                  f"solve; estimate RMS vs truth {float(est_rms):.4f} m")
            if args.disturbance_observer:
                import numpy as _np

                d_tail = _np.asarray(outs_ltv["disturbance_est"])
                d_tail = d_tail[len(d_tail) // 2:].mean(axis=0)
                print(f"# disturbance observer (ltv12, 100 Hz fuse / "
                      f"10 Hz feedforward): mean estimated accel "
                      f"disturbance (tail) = [{d_tail[0]:+.3f} "
                      f"{d_tail[1]:+.3f} {d_tail[2]:+.3f}] m/s^2")
        else:
            @jax.jit
            def fly_ltv(x0):
                def step(c, i):
                    st, mc = c
                    ts = (i + jnp.arange(N_ltv + 1)).astype(jnp.float32) * LDT
                    window = ref12_at(ts)
                    u, _, mc = mpc_ltv.solve(mc, st, window,
                                             obstacles=obstacles)
                    st2 = plant_ltv(st, u)
                    return (st2, mc), {"state": st, "u": u}
                (_, _), o = jax.lax.scan(
                    step, (x0, mpc_ltv.init_carry(x0)),
                    jnp.arange(steps10))
                return o

            outs_ltv = fly_ltv(x0_ltv)
        ts10 = jnp.arange(steps10, dtype=jnp.float32) * LDT
        outs = {
            "state": outs_ltv["state"],
            "pos_ref": ref12_at(ts10)[:, 0:3],
            "thrust": outs_ltv["u"][:, 0] / (2.0 * mg_gz),
        }
        m = tracking_metrics(outs["pos_ref"], outs["state"][:, 0:3],
                             thrust_normalized=outs["thrust"])
        if obstacles is not None:
            d = outs["state"][:, None, 0:3] - obstacles[None, :, 0:3]
            clear = jnp.min(
                jnp.sqrt(jnp.sum(d**2, -1)) - obstacles[None, :, 3])
            m["min_obstacle_clearance"] = float(clear)
        print(json.dumps({k: round(float(v), 4) for k, v in m.items()},
                         indent=2))
        if args.save_log:
            from .io import save_flight_log

            save_flight_log(args.save_log, outs, control_dt=LDT)
            print(f"flight log written to {args.save_log}")
        return 0
    elif args.controller in ("mpc12", "direct-rate12", "ilqr12", "mppi12"):
        # 12-state controllers flying the z-up rigid-body plant directly
        # (the mpc_FULL node's role, src/px4/mpc_FULL.py:613-1060);
        # direct-rate12 is the body-rate-input engine
        # (mpc_direct_rates.py:76-922); ilqr12 runs the same task on the
        # Riccati-based iLQR engine instead of SQP+ADMM; mppi12 on the
        # sampling-based MPPI controller (512 rollouts per tick).
        import numpy as np

        from .control import ILQRRigidBodyMPC, RigidBodyMPC
        from .models import X500_PARAMS, rigid_body_rk4_step
        from .metrics import tracking_metrics

        mg = X500_PARAMS.mass * X500_PARAMS.gravity
        if args.controller == "ilqr12":
            # integrator="rk4": the engine's internal model IS the plant
            # step — better tracking than the historical Euler engine
            # (RMS 0.5668 -> 0.5081 on the circle task)
            mpc12 = ILQRRigidBodyMPC(integrator="rk4")
            thrust_of_u = lambda u: u[..., 0] / mg
        elif args.controller == "mppi12":
            from .control import MPPIController

            mpc12 = MPPIController()
            thrust_of_u = lambda u: u[..., 0] / mg
        elif args.controller == "direct-rate12":
            from .control import DirectRateMPC
            from .control.mpc_rigid import direct_rate_step

            mpc12 = DirectRateMPC()
            thrust_of_u = lambda u: u[..., 3]  # normalized thrust channel
        else:
            mpc12 = RigidBodyMPC()
            thrust_of_u = lambda u: u[..., 0] / mg

        x0 = jnp.zeros(12, jnp.float32).at[2].set(cfg.takeoff_height)
        if args.noisy:
            # estimator in the loop for the 12-state family: sensors ->
            # rigid-body EKF -> controller (flying the ESTIMATE) -> true
            # plant (estimation.noisy_rigid_mpc_rollout)
            from .estimation import EKFConfig
            from .estimation.noisy_loop import noisy_rigid_mpc_rollout

            noisy_kw = {}
            if args.controller == "direct-rate12":
                # the direct-rate engine's true plant is its rate-lag
                # model, and its solve has no yaw channel
                # (mpc_direct_rates.py:153-190 tracks position only)
                from .control.mpc_rigid import direct_rate_step

                # --push: a constant unmodelled acceleration on the TRUE
                # plant (the torque family's wind analogue — this model
                # has no drag, so the force enters the derivative
                # directly); the EKF's process model stays nominal
                push_row = jnp.zeros(12, jnp.float32)
                if args.push is not None:
                    push_row = push_row.at[3:6].set(
                        jnp.asarray(args.push, jnp.float32))
                noisy_kw = dict(
                    process_step_fn=lambda x, u: direct_rate_step(
                        x, u, jnp.zeros(12, jnp.float32),
                        dt=float(cfg.control_dt)),
                    yaw_channel=False,
                )
                if args.push_step is not None:
                    # --push-step: the unmodelled force STEPS at t=T on
                    # the TRUE plant (the torque family's --gust); the
                    # filter's model stays nominal, so only the observer
                    # adapts
                    t_p = float(args.push_step[0])
                    post_row = jnp.zeros(12, jnp.float32).at[3:6].set(
                        jnp.asarray(args.push_step[1:], jnp.float32))
                    noisy_kw["plant_step_tfn"] = (
                        lambda x, u, t: direct_rate_step(
                            x, u,
                            jnp.where(t < t_p, push_row, post_row),
                            dt=float(cfg.control_dt),
                        )
                    )
                else:
                    noisy_kw["plant_step_fn"] = (
                        lambda x, u: direct_rate_step(
                            x, u, push_row, dt=float(cfg.control_dt))
                    )
                if args.disturbance_observer:
                    noisy_kw["disturbance_observer"] = True
            outs12 = jax.jit(lambda: noisy_rigid_mpc_rollout(
                mpc12, ref, num_steps, jax.random.PRNGKey(args.seed),
                ekf_cfg=EKFConfig(), body=X500_PARAMS,
                dt=float(cfg.control_dt),
                takeoff_height=float(cfg.takeoff_height),
                **noisy_kw,
            ))()
            if args.controller == "direct-rate12" and \
                    args.disturbance_observer:
                import numpy as _np

                d_tail = _np.asarray(outs12["disturbance_est"])
                d_tail = d_tail[len(d_tail) // 2:].mean(axis=0)
                print(f"# disturbance observer (direct-rate12): mean "
                      f"estimated accel disturbance (tail) = "
                      f"[{d_tail[0]:+.3f} {d_tail[1]:+.3f} "
                      f"{d_tail[2]:+.3f}] m/s^2")
            outs = {
                "state": outs12["state"],
                "pos_ref": outs12["pos_ref"],
                "thrust": thrust_of_u(outs12["u"]),
            }
            est_rms = jnp.sqrt(jnp.mean(jnp.sum(
                (outs12["state_est"][:, 0:3]
                 - outs12["state"][:, 0:3]) ** 2, -1)))
            model = ("rate-lag" if args.controller == "direct-rate12"
                     else "rigid-body")
            print(f"# noisy tier: {args.controller} on {model} EKF "
                  f"estimate; estimate RMS vs truth "
                  f"{float(est_rms):.4f} m")
        else:
            @jax.jit
            def fly12():
                def step(c, i):
                    st, mc = c
                    t = i.astype(jnp.float32) * cfg.control_dt
                    pos_ref, yaw_ref = ref(t)
                    if args.controller == "direct-rate12":
                        # DirectRateMPC has no yaw target channel
                        # (mpc_direct_rates tracks position only)
                        u, _, mc = mpc12.solve(
                            mc, st, jnp.asarray(pos_ref, jnp.float32))
                    else:
                        u, _, mc = mpc12.solve(
                            mc, st, jnp.asarray(pos_ref, jnp.float32),
                            jnp.asarray(yaw_ref, jnp.float32))
                    if args.controller == "direct-rate12":
                        st = direct_rate_step(
                            st, u, jnp.zeros(12, jnp.float32),
                            dt=cfg.control_dt)
                    else:
                        st = rigid_body_rk4_step(
                            st, u, X500_PARAMS, cfg.control_dt)
                    out = {"state": st,
                           "pos_ref": jnp.asarray(pos_ref, jnp.float32),
                           "thrust": thrust_of_u(u)}
                    return (st, mc), out

                (_, _), outs = jax.lax.scan(
                    step, (x0, mpc12.init_carry(x0)), jnp.arange(num_steps)
                )
                return outs

            outs = fly12()
        m = tracking_metrics(outs["pos_ref"], outs["state"][:, 0:3],
                             thrust_normalized=outs["thrust"])
        print(json.dumps({k: round(float(v), 4) for k, v in m.items()}, indent=2))
        if args.save_log:
            from .io import save_flight_log

            save_flight_log(args.save_log, outs,
                            control_dt=float(cfg.control_dt))
            print(f"flight log written to {args.save_log}")
        if getattr(args, "animate", None):
            from .metrics.animate import animate_flight

            path = animate_flight(outs, args.animate,
                                  dt=float(cfg.control_dt),
                                  title=args.trajectory)
            print(f"animation written to {path}")
        return 0
    else:
        mpc = LinearMPC(LinearMPCConfig())
        residual_fn = None
        output_correction_fn = None
        gp_gain = 0.1
        online_gp = None
        if args.online:
            # ONLINE in-flight learning: ring-buffer capture every tick +
            # cond-gated masked refit every 250 ticks — no pretrained
            # model needed, the GP learns from scratch during the flight
            if args.controller != "gp-mpc":
                print("--online is in-flight GP learning: use "
                      "--controller gp-mpc", file=sys.stderr)
                return 1
            if args.gp_model or args.gp_mode == "output":
                print("--online learns in flight; drop --gp-model/"
                      "--gp-mode output", file=sys.stderr)
                return 1
            from .loop import OnlineFusedGPConfig

            gcfg = ResidualGPConfig()
            online_gp = OnlineFusedGPConfig(gp=gcfg)
            gp_gain = gcfg.residual_gain
        elif args.controller == "gp-mpc":
            gp_cfg = ResidualGPConfig()
            if args.gp_model:
                # pretrained-model runtime — the reference's GP_USE_MODEL /
                # GP_MODEL_PATH channel (src/px4/mpc.py:1744-1750,
                # pretrained_gp.py): fly a saved checkpoint (possibly
                # hyperparameter-optimised by 'train-gp --optimize')
                # instead of refitting from CSVs
                from .gp.exact_gp import fit_gp
                from .io import load_gp_checkpoint

                if not os.path.exists(args.gp_model):
                    print(f"GP model not found: {args.gp_model!r}",
                          file=sys.stderr)
                    return 1
                if args.gp_model.endswith(".pkl"):
                    # the REFERENCE's sklearn pickle formats (single GP or
                    # per-dim package) load directly — a reference user's
                    # trained models work unchanged (io.sklearn_import)
                    from .io import load_reference_gp

                    kind, loaded, _meta = load_reference_gp(
                        args.gp_model, dtype=jnp.float32
                    )
                    if kind == "per_dim":
                        from .gp.per_dim import (
                            build_horizon_residuals_per_dim,
                        )

                        perdim = loaded
                        residual_fn = lambda Xg, Ug: (
                            build_horizon_residuals_per_dim(
                                perdim, Xg, Ug, dt=gp_cfg.dt,
                                residual_gain=gp_cfg.residual_gain,
                            )
                        )
                        post, X = None, np.zeros((0, 10))
                    else:
                        post = loaded
                        X = np.asarray(post.X_train)
                        # original targets back out of the stored
                        # normalisation (for any capacity-capped refit)
                        Ys = np.asarray(
                            post.y_train_norm * post.y_std + post.y_mean
                        )
                    # any capacity-capped refit below must reuse the
                    # regressor's ACTUAL fit settings (surfaced by
                    # load_reference_gp in meta), not config defaults — a
                    # bare pickle with normalize_y=False or a non-default
                    # alpha round-trips faithfully
                    jitter = _meta.get("jitter", gp_cfg.alpha)
                    norm_y = _meta.get("normalize_y", True)
                else:
                    post, X, Ys, jitter, norm_y = load_gp_checkpoint(
                        args.gp_model, dtype=jnp.float32
                    )
                if X.shape[0] > gp_cfg.max_data_points:
                    # cap to the flight-loop design size (the per-tick GP
                    # products are sized for max_data_points; a 10k/19.8k
                    # offline checkpoint would run uncapped)
                    n = gp_cfg.max_data_points
                    print(f"checkpoint has {X.shape[0]} rows; refitting the "
                          f"flight posterior on the first {n} "
                          "(checkpoint hyperparameters kept)")
                    X = X[:n]
                    post = fit_gp(post.params, jnp.asarray(X, jnp.float32),
                                  jnp.asarray(Ys[:n], jnp.float32),
                                  jitter=jitter, normalize_y=norm_y)
            else:
                fitted = _fit_corpus_gp(args.gp_data)
                if fitted is None:
                    print(f"no GP data matches {args.gp_data!r}",
                          file=sys.stderr)
                    return 1
                post, gp_cfg, X = fitted
            if post is None:
                # per-dim pickle: residual_fn already bound above
                if args.gp_mode == "output":
                    print("--gp-mode output needs a single-GP model "
                          "(per-dim packages drive the dynamics mode)",
                          file=sys.stderr)
                    return 1
            elif args.gp_mode == "output":
                # the reference's earlier generation (mpc_gp.py:341-372):
                # GP corrects the solved control post-solve
                from .gp import make_output_correction_fn

                output_correction_fn = make_output_correction_fn(
                    post, n_train=X.shape[0]
                )
            else:
                residual_fn = lambda Xg, Ug: build_horizon_residuals(
                    post, Xg, Ug, gp_cfg
                )
        if args.noisy:
            # estimator in the loop: sensors -> EKF -> controller -> plant
            if output_correction_fn is not None:
                print("--noisy supports the in-dynamics GP mode only "
                      "(--gp-mode dynamics)", file=sys.stderr)
                return 1
            from .estimation import EKFConfig, noisy_mpc_flight_rollout

            ekf_cfg = EKFConfig()
            body_kw = {"body": body6} if body6 is not None else {}
            if wind_fn6 is not None:
                body_kw["wind_fn"] = wind_fn6
            outs = jax.jit(
                lambda: noisy_mpc_flight_rollout(
                    mpc, ref, num_steps, jax.random.PRNGKey(args.seed),
                    cfg=cfg, residual_fn=residual_fn, preview=args.preview,
                    gp_gain=gp_gain, ekf_cfg=ekf_cfg, online_gp=online_gp,
                    disturbance_observer=(
                        True if args.disturbance_observer else None
                    ),
                    **body_kw,
                )
            )()
            if args.disturbance_observer:
                import numpy as _np

                d_tail = _np.asarray(outs["disturbance_est"])
                d_tail = d_tail[len(d_tail) // 2:].mean(axis=0)
                print(f"# disturbance observer: mean estimated accel "
                      f"disturbance (tail) = "
                      f"[{d_tail[0]:+.3f} {d_tail[1]:+.3f} "
                      f"{d_tail[2]:+.3f}] m/s^2")
            if online_gp is not None:
                print(f"# online+noisy: GP trained on EKF estimates "
                      f"(the reference's EKF2-fed capture path); "
                      f"samples {int(outs['gp_count'][-1])}")
        else:
            body_kw = {"body": body6} if body6 is not None else {}
            outs = jax.jit(
                lambda: mpc_flight_rollout(
                    mpc, ref, num_steps, cfg=cfg, residual_fn=residual_fn,
                    output_correction_fn=output_correction_fn,
                    preview=args.preview, gp_gain=gp_gain,
                    online_gp=online_gp,
                    **body_kw,
                )
            )()

    m = tracking_metrics(
        outs["pos_ref"], outs["state"][:, 0:3],
        vel_setpoint=outs["vel_ref"], vel_current=outs["state"][:, 3:6],
        att_setpoint=outs["att_ref"], att_current=outs["state"][:, 6:9],
        thrust_normalized=outs["thrust"],
    )
    print(json.dumps({k: round(float(v), 4) for k, v in m.items()}, indent=2))
    if args.save_log:
        from .io import save_flight_log

        save_flight_log(args.save_log, outs,
                        control_dt=float(cfg.control_dt))
        print(f"flight log written to {args.save_log}")
    if getattr(args, "animate", None):
        from .metrics.animate import animate_flight

        path = animate_flight(outs, args.animate, dt=float(cfg.control_dt),
                              title=args.trajectory)
        print(f"animation written to {path}")
    return 0


def _cmd_mission(args) -> int:
    """Full mission (ground -> arm -> takeoff -> hover -> trajectory)."""
    import jax
    import jax.numpy as jnp

    from .control.mpc_linear import LinearMPC, LinearMPCConfig
    from .loop import FlightLoopConfig, mission_rollout
    from .trajectories import ramped_figure8_reference

    if args.disturbance_observer and not args.noisy:
        print("--disturbance-observer needs the noisy mission (--noisy): "
              "the observer fuses drawn sensor samples", file=sys.stderr)
        return 1
    cfg = FlightLoopConfig()
    mpc = LinearMPC(LinearMPCConfig())

    def ref(t):
        pos, yaw = ramped_figure8_reference(t, amplitude=args.amplitude)
        return pos + jnp.array([0.0, 0.0, cfg.takeoff_height]), yaw

    kw = {}
    if args.noisy:
        # the reference node's actual regime: every phase flies PX4-EKF2
        # output (mpc.py:1889-1907) — here the estimator is in-graph
        kw["key"] = jax.random.PRNGKey(args.seed)
        if args.disturbance_observer:
            kw["disturbance_observer"] = True
    if args.wind is not None:
        from .models import RigidBodyParams

        kw["body"] = RigidBodyParams(wind=tuple(args.wind))
    outs = jax.jit(
        lambda: mission_rollout(mpc, ref, duration=args.duration, cfg=cfg,
                                **kw)
    )()
    import numpy as np

    traj = np.asarray(outs["in_trajectory"])
    err = np.linalg.norm(
        np.asarray(outs["target"] - outs["state"][:, 0:3]), axis=1
    )
    result = {
        "phases_reached": int(np.asarray(outs["phase"]).max()) + 1,
        "takeoff_altitude_m": round(float(outs["state"][traj.argmax(), 2]), 3),
        "trajectory_rms_pos_m": round(float(np.sqrt((err[traj] ** 2).mean())), 4),
        "trajectory_max_pos_m": round(float(err[traj].max()), 4),
    }
    if args.noisy:
        est_err = np.linalg.norm(np.asarray(
            outs["state_est"][:, 0:3] - outs["state"][:, 0:3]), axis=1)
        result["estimate_rms_pos_m"] = round(
            float(np.sqrt((est_err**2).mean())), 4)
    if args.disturbance_observer:
        d = np.asarray(outs["disturbance_est"])
        result["disturbance_est_tail"] = [
            round(float(v), 3) for v in d[len(d) // 2:].mean(axis=0)
        ]
    print(json.dumps(result, indent=2))
    return 0


def _cmd_online(args) -> int:
    """Online-learning flight: collect data and retrain the GP in-flight."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from .control.mpc_linear import LinearMPC, LinearMPCConfig
    from .gp.residual_gp import ResidualGPConfig
    from .io import save_gp_checkpoint
    from .loop import OnlineGPMPCConfig, online_gp_mpc_rollout
    from .trajectories import ramped_figure8_reference

    cfg = OnlineGPMPCConfig(
        gp=ResidualGPConfig(max_data_points=args.gp_capacity),
        gp_refit_every=args.refit_every,
        preview=args.preview,
    )
    mpc = LinearMPC(LinearMPCConfig())
    num_steps = int(args.duration / cfg.flight.control_dt)

    def ref(t):
        pos, yaw = ramped_figure8_reference(t, amplitude=args.amplitude)
        return pos + jnp.array([0.0, 0.0, cfg.flight.takeoff_height]), yaw

    outs, dataset, posterior = jax.jit(
        lambda: online_gp_mpc_rollout(mpc, ref, num_steps, cfg=cfg)
    )()

    err = np.linalg.norm(
        np.asarray(outs["pos_ref"] - outs["state"][:, 0:3]), axis=1
    )
    result = {
        "gp_samples_collected": int(dataset.count),
        "gp_active_final": bool(outs["gp_active"][-1]),
        "rms_pos_m": round(float(np.sqrt((err**2).mean())), 4),
    }
    if args.save_model:
        n = int(dataset.count)
        save_gp_checkpoint(
            args.save_model, posterior,
            np.asarray(dataset.X)[:n], np.asarray(dataset.Y)[:n],
            jitter=cfg.gp.alpha,
        )
        result["model_saved"] = args.save_model
    print(json.dumps(result, indent=2))
    return 0


def _cmd_analyze(args) -> int:
    """Post-hoc flight-log analysis (the rosbag-analyzer role)."""
    from .io import analyze_flight_log, load_flight_log

    log = load_flight_log(args.log)
    metrics = analyze_flight_log(log)
    print(json.dumps(metrics, indent=2))
    if args.plot:
        from .metrics.plots import plot_flight_log

        out = args.plot if isinstance(args.plot, str) else args.log + ".png"
        plot_flight_log(log, out, title=os.path.basename(args.log))
        print(f"plot written to {out}")
    if getattr(args, "animate", None):
        from .metrics.animate import animate_flight

        # logs flown at a non-default control_dt carry it as metadata
        # (save_flight_log control_dt=...); default to the 50 Hz tick
        dt = float(log.get("meta_control_dt", 0.02))
        path = animate_flight(log, args.animate, dt=dt,
                              title=os.path.basename(args.log))
        print(f"animation written to {path}")
    return 0


def _cmd_compare(args) -> int:
    from .loop import run_full_comparison

    results = run_full_comparison(duration=args.duration)
    print(json.dumps(results, indent=2))
    return 0


def _cmd_sweep(args) -> int:
    import jax
    import jax.numpy as jnp

    from .control.mpc_linear import LinearMPC, LinearMPCConfig
    from .loop import FlightLoopConfig, mpc_flight_rollout
    from .parallel import make_mesh, sharded_flight_sweep
    from .trajectories import ramped_figure8_reference

    cfg = FlightLoopConfig()
    mpc = LinearMPC(LinearMPCConfig())

    def ref(t):
        pos, yaw = ramped_figure8_reference(t)
        return pos + jnp.array([0.0, 0.0, cfg.takeoff_height]), yaw

    num_steps = int(args.duration / cfg.control_dt)

    def one_flight(x0):
        return mpc_flight_rollout(mpc, ref, num_steps, cfg=cfg, initial_state=x0)

    B = args.flights
    starts = jnp.zeros((B, 12), jnp.float32).at[:, 2].set(cfg.takeoff_height)
    starts = starts.at[:, 0].set(jnp.linspace(-1.0, 1.0, B))
    mesh = make_mesh()
    result = sharded_flight_sweep(mesh, one_flight, starts)
    print(json.dumps({
        "devices": len(jax.devices()),
        "flights": B,
        "rms_mean_m": round(float(result["rms_mean"]), 4),
        "rms_max_m": round(float(result["rms_max"]), 4),
    }, indent=2))
    return 0


def _reference_fn(trajectory: str, amplitude: float, takeoff_height: float):
    import jax.numpy as jnp

    from .trajectories import ramped_circle_reference, ramped_figure8_reference

    if trajectory == "figure8":
        def ref(t):
            pos, yaw = ramped_figure8_reference(t, amplitude=amplitude)
            return pos + jnp.array([0.0, 0.0, takeoff_height]), yaw
    else:
        def ref(t):
            pos, _, yaw = ramped_circle_reference(
                t, amplitude=amplitude, height=takeoff_height
            )
            return pos, yaw
    return ref


def _cmd_tune(args) -> int:
    """Differentiable closed-loop tuning (no reference counterpart — the
    reference hand-tunes; cascade_pid_demo.py:194-210)."""
    import jax
    import numpy as np

    from .loop import FlightLoopConfig, mpc_flight_rollout, pid_flight_rollout
    from .tuning import TuneConfig, tune_cascade_gains, tune_mpc_weights

    cfg = FlightLoopConfig()
    num_steps = int(args.duration / cfg.control_dt)
    ref = _reference_fn(args.trajectory, args.amplitude, cfg.takeoff_height)
    tune_cfg = TuneConfig(
        iterations=args.iterations, learning_rate=args.learning_rate,
        settle_steps=min(250, num_steps // 4),
    )

    def rms(outs):
        err = np.linalg.norm(
            np.asarray(outs["state"][:, 0:3]) - np.asarray(outs["pos_ref"]),
            axis=1,
        )
        return float(np.sqrt((err**2).mean()))

    t0 = time.time()
    if args.controller == "pid":
        from .models import PID_CAMPAIGN_RATE_LOOP

        rate_loop = PID_CAMPAIGN_RATE_LOOP
        result = tune_cascade_gains(
            ref, num_steps, tune_cfg=tune_cfg, rate_loop=rate_loop,
            loop_cfg=cfg,
        )
        fly = lambda gains: jax.jit(
            lambda: pid_flight_rollout(
                ref, num_steps, gains=gains, rate_loop=rate_loop, cfg=cfg
            )
        )()
        rms_before, rms_after = rms(fly(None)), rms(fly(result.params))
        tuned = {
            layer: {
                k: [round(float(v), 4) for v in np.asarray(
                    getattr(getattr(result.params, layer), k)
                )]
                for k in ("kp", "ki", "kd")
            }
            for layer in ("position", "velocity", "attitude")
        }
    else:
        from .control.mpc_linear import LinearMPC, LinearMPCConfig

        result, tuned_config = tune_mpc_weights(
            ref, num_steps, tune_cfg=tune_cfg, loop_cfg=cfg,
        )
        fly = lambda c: jax.jit(
            lambda: mpc_flight_rollout(LinearMPC(c), ref, num_steps, cfg=cfg)
        )()
        rms_before = rms(fly(LinearMPCConfig()))
        rms_after = rms(fly(tuned_config))
        tuned = {
            "q_pos": [round(v, 3) for v in tuned_config.q_pos],
            "q_vel": [round(v, 3) for v in tuned_config.q_vel],
            "r_control": [round(v, 3) for v in tuned_config.r_control],
            "terminal_pos_weight": round(tuned_config.terminal_pos_weight, 3),
            "terminal_vel_weight": round(tuned_config.terminal_vel_weight, 3),
        }

    payload = {
        "controller": args.controller,
        "trajectory": args.trajectory,
        "loss_initial": round(float(result.initial_loss), 5),
        "loss_final": round(float(result.final_loss), 5),
        "rms_pos_m_before": round(rms_before, 4),
        "rms_pos_m_after": round(rms_after, 4),
        "tune_seconds": round(time.time() - t0, 1),
        "tuned": tuned,
    }
    print(json.dumps(payload, indent=2))
    if args.save:
        with open(args.save, "w") as f:
            json.dump(payload, f, indent=2)
        print(f"saved tuned parameters to {args.save}")
    return 0


def _load_gp_corpus(spec: str, max_samples):
    """``(X, Y, source)`` from ``spec``: a CSV glob in the reference's
    ``gp_datasets`` schema, or ``synthetic`` for the seeded excitation
    corpus at the reference corpus's size (``io.synthetic_corpus``).
    ``None`` when the glob is empty (caller prints the error)."""
    from .io import load_gp_datasets, synthetic_corpus

    if spec == SYNTHETIC:
        X, Y = synthetic_corpus(max_samples=max_samples)
        return X, Y, "the synthetic excitation corpus (seed 0)"
    paths = sorted(glob.glob(spec))
    if not paths:
        return None
    X, Y = load_gp_datasets(paths, max_samples=max_samples)
    return X, Y, f"{len(paths)} files"


def _fit_corpus_gp(gp_data: str):
    """Fit the flight GP on the corpus (shared by fly/montecarlo).

    Returns ``(posterior, gp_cfg, X)`` or ``None`` when the glob is empty
    (caller prints the error)."""
    import jax
    import jax.numpy as jnp

    from .gp import fit_residual_gp
    from .gp.residual_gp import ResidualGPConfig

    gp_cfg = ResidualGPConfig()
    corpus = _load_gp_corpus(gp_data, gp_cfg.max_data_points)
    if corpus is None:
        return None
    X, Y, _ = corpus
    post = jax.jit(lambda x, y: fit_residual_gp(x, y, gp_cfg))(
        jnp.asarray(X, jnp.float32), jnp.asarray(Y, jnp.float32)
    )
    return post, gp_cfg, X


def _cmd_montecarlo(args) -> int:
    """Monte-Carlo robustness study (no reference counterpart)."""
    import jax
    import numpy as np

    from .loop import FlightLoopConfig, MonteCarloConfig, monte_carlo_mpc, monte_carlo_pid

    cfg = FlightLoopConfig()
    num_steps = int(args.duration / cfg.control_dt)
    ref = _reference_fn(args.trajectory, args.amplitude, cfg.takeoff_height)
    mc = MonteCarloConfig(
        n_rollouts=args.rollouts, seed=args.seed, wind_std=args.wind_std,
        settle_steps=min(250, num_steps // 4),
    )
    if args.controller == "pid":
        from .models import PID_CAMPAIGN_RATE_LOOP

        stats = jax.jit(
            lambda: monte_carlo_pid(
                ref, num_steps, mc=mc, rate_loop=PID_CAMPAIGN_RATE_LOOP,
                loop_cfg=cfg,
            )
        )()
    else:
        from .control.mpc_linear import LinearMPC, LinearMPCConfig

        mpc = LinearMPC(LinearMPCConfig())
        residual_fn = None
        if args.controller == "gp-mpc":
            from .gp import build_horizon_residuals

            fitted = _fit_corpus_gp(args.gp_data)
            if fitted is None:
                print(f"no GP data matches {args.gp_data!r}", file=sys.stderr)
                return 1
            post, gp_cfg, _ = fitted
            residual_fn = lambda Xg, Ug: build_horizon_residuals(
                post, Xg, Ug, gp_cfg
            )
        stats = jax.jit(
            lambda: monte_carlo_mpc(
                mpc, ref, num_steps, mc=mc, loop_cfg=cfg,
                residual_fn=residual_fn,
            )
        )()

    import math

    # strict JSON: crashed populations yield NaN quantiles / inf worst-case
    # (nanmean over all-NaN); map non-finite to null rather than emitting
    # NaN/Infinity tokens that strict parsers reject
    num = lambda k: (
        round(float(stats[k]), 4) if math.isfinite(float(stats[k])) else None
    )
    print(json.dumps({
        "controller": args.controller,
        "trajectory": args.trajectory,
        "rollouts": args.rollouts,
        "wind_std_mps": args.wind_std,
        "success_rate": num("success_rate"),
        "rms_pos_m_mean": num("rms_mean"),
        "rms_pos_m_p50": num("rms_p50"),
        "rms_pos_m_p90": num("rms_p90"),
        "rms_pos_m_p99": num("rms_p99"),
        "worst_max_pos_m": num("worst_max_pos"),
    }, indent=2, allow_nan=False))
    if args.plot:
        from .metrics import plot_robustness

        out = args.plot if isinstance(args.plot, str) else "montecarlo.png"
        plot_robustness(
            {k: np.asarray(v) for k, v in stats.items()},
            out, title=f"{args.controller} {args.trajectory}",
        )
        print(f"dispersion figure written to {out}")
    return 0


SYNTHETIC = "synthetic"
_DATA_HELP = ("CSV glob in the gp_datasets schema, or 'synthetic' (default) "
              "for the seeded excitation corpus of io.synthetic_corpus")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="unmanned_aerial_vehicles_tpu",
        description="quadrotor GP-MPC framework",
    )
    sub = p.add_subparsers(dest="command", required=True)

    t = sub.add_parser("train-gp", help="offline GP training from flight CSVs")
    t.add_argument("--data", default=SYNTHETIC, help=_DATA_HELP)
    t.add_argument("--output", default="gp_model.npz")
    t.add_argument("--max-samples", type=int, default=10000)
    t.add_argument("--all-samples", action="store_true",
                   help="train on the FULL corpus, row-sharded over the "
                        "device mesh (no down-sampling)")
    t.add_argument("--cg-iterations", type=int, default=200)
    t.add_argument("--optimize", action="store_true", help="LML hyperparameter opt")
    t.add_argument("--opt-steps", type=int, default=100)
    t.set_defaults(fn=_cmd_train_gp)

    e = sub.add_parser("evaluate-gp", help="offline nominal-vs-GP evaluation")
    e.add_argument("--model", required=True,
                   help="GP checkpoint (.npz, or a reference sklearn .pkl; "
                        "unpickling runs arbitrary code — only load "
                        "pickles you trust)")
    e.add_argument("--data", required=True)
    e.add_argument("--output", default=None, help="metrics CSV prefix")
    e.add_argument("--full-analysis", action="store_true",
                   help="also run the GPModelEvaluator surface: physical "
                        "test regimes, uncertainty analysis, and the "
                        "distribution/uncertainty/correlation figures "
                        "(gp_evaluation.py:551-575)")
    e.set_defaults(fn=_cmd_evaluate_gp)

    f = sub.add_parser("fly", help="closed-loop flight experiment")
    f.add_argument("--controller",
                   choices=["pid", "mpc", "gp-mpc", "mpc12", "direct-rate12",
                            "ilqr12", "mppi12", "ltv12"],
                   default="gp-mpc")
    f.add_argument("--obstacle", action="append", default=None,
                   metavar="X,Y,Z,R",
                   help="spherical obstacle for --controller ltv12 "
                        "(repeatable): the LTV engine reserves linearised "
                        "half-space rows per obstacle "
                        "(mpc_controller.py:223-316 semantics)")
    f.add_argument("--trajectory", choices=["figure8", "circle"], default="figure8")
    f.add_argument("--duration", type=float, default=60.0)
    f.add_argument("--amplitude", type=float, default=6.0)
    f.add_argument("--gp-data", default=SYNTHETIC, help=_DATA_HELP)
    f.add_argument("--gp-model", default=None,
                   help="fly a saved GP checkpoint (train-gp output) "
                        "instead of refitting from --gp-data (the "
                        "reference's GP_USE_MODEL/GP_MODEL_PATH channel). "
                        ".pkl checkpoints are unpickled — arbitrary code "
                        "runs; only load pickles you trust")
    f.add_argument("--gp-mode", choices=["dynamics", "output"],
                   default="dynamics",
                   help="GP enters the prediction model ('dynamics', "
                        "mpc.py generation) or corrects the solved control "
                        "post-solve ('output', mpc_gp.py generation)")
    f.add_argument("--preview", action="store_true",
                   help="per-stage horizon references (removes tracking lag)")
    f.add_argument("--online", action="store_true",
                   help="ONLINE in-flight GP learning (--controller gp-mpc; "
                        "no pretrained model needed — ring-buffer capture "
                        "+ 5 s refits, the reference's retrain policy; "
                        "composes with --noisy: the GP then trains on EKF "
                        "estimates, the reference's EKF2-fed capture path)")
    f.add_argument("--save-log", default=None,
                   help="write the flight log (.npz snapshot, or .uavlog "
                        "for the streaming binary format)")
    f.add_argument("--animate", default=None, metavar="OUT.gif",
                   help="animated replay of the flight (the reference's "
                        "live-visualizer role, results_visualizer.py:17-30; "
                        ".gif always works headless, .mp4 needs ffmpeg)")
    f.add_argument("--noisy", action="store_true",
                   help="fly on EKF-estimated state from noisy sensors "
                        "(estimation/; every controller but pid — ltv12 "
                        "runs the multi-rate 100 Hz-EKF/10 Hz-solve split)")
    f.add_argument("--seed", type=int, default=0,
                   help="sensor-noise PRNG seed (--noisy)")
    f.add_argument("--wind", nargs=3, type=float, default=None,
                   metavar=("WX", "WY", "WZ"),
                   help="steady world-frame wind (m/s) on the TRUE plant "
                        "(mpc/gp-mpc family; drag acts on airspeed)")
    f.add_argument("--disturbance-observer", action="store_true",
                   help="augmented-EKF disturbance observer (--noisy): "
                        "estimates the accel disturbance "
                        "in flight and feeds it to the MPC — wind "
                        "rejection without learning "
                        "(estimation/disturbance.py)")
    f.add_argument("--push", nargs=3, type=float, default=None,
                   metavar=("AX", "AY", "AZ"),
                   help="constant unmodelled acceleration (m/s^2) on the "
                        "TRUE plant (direct-rate12 --noisy; pair with "
                        "--disturbance-observer for the torque family's "
                        "learning-free rejection)")
    f.add_argument("--gust", nargs=4, type=float, default=None,
                   metavar=("T", "WX", "WY", "WZ"),
                   help="wind step-change on the TRUE plant: at t=T (s) "
                        "the wind switches from --wind to (WX, WY, WZ) "
                        "(--noisy; pair with "
                        "--disturbance-observer to watch the estimate "
                        "re-converge)")
    f.add_argument("--push-step", nargs=4, type=float, default=None,
                   metavar=("T", "AX", "AY", "AZ"),
                   help="the torque family's --gust: at t=T (s) the "
                        "unmodelled force switches from --push to "
                        "(AX, AY, AZ) on the TRUE plant (direct-rate12 "
                        "--noisy; pair with --disturbance-observer)")
    f.set_defaults(fn=_cmd_fly)

    m = sub.add_parser("mission", help="full phase-machine mission")
    m.add_argument("--duration", type=float, default=60.0)
    m.add_argument("--amplitude", type=float, default=6.0)
    m.add_argument("--noisy", action="store_true",
                   help="fly the WHOLE mission on EKF estimates (the "
                        "reference node's regime: every phase consumes "
                        "PX4-EKF2 output, mpc.py:1889-1907)")
    m.add_argument("--wind", nargs=3, type=float, default=None,
                   metavar=("WX", "WY", "WZ"),
                   help="steady world-frame wind on the true plant")
    m.add_argument("--disturbance-observer", action="store_true",
                   help="augmented-EKF disturbance observer across the "
                        "mission (requires --noisy)")
    m.add_argument("--seed", type=int, default=0)
    m.set_defaults(fn=_cmd_mission)

    o = sub.add_parser("online", help="online-learning GP-MPC flight")
    o.add_argument("--duration", type=float, default=60.0)
    o.add_argument("--amplitude", type=float, default=6.0)
    o.add_argument("--gp-capacity", type=int, default=400)
    o.add_argument("--refit-every", type=int, default=250)
    o.add_argument("--save-model", default=None)
    o.add_argument("--preview", action="store_true")
    o.set_defaults(fn=_cmd_online)

    an = sub.add_parser("analyze", help="flight-log metrics (+ optional plot)")
    an.add_argument("--log", required=True, help="npz flight log")
    an.add_argument("--plot", nargs="?", const=True, default=False,
                    help="write analysis figure (optional path)")
    an.add_argument("--animate", default=None, metavar="OUT.gif",
                    help="animated replay of the saved flight "
                         "(metrics/animate; .gif headless, .mp4 with ffmpeg)")
    an.set_defaults(fn=_cmd_analyze)

    c = sub.add_parser("compare", help="standalone PID vs GP-MPC comparison")
    c.add_argument("--duration", type=float, default=30.0)
    c.set_defaults(fn=_cmd_compare)

    s = sub.add_parser("sweep", help="mesh-sharded batch flight sweep")
    s.add_argument("--flights", type=int, default=64)
    s.add_argument("--duration", type=float, default=20.0)
    s.set_defaults(fn=_cmd_sweep)

    tu = sub.add_parser(
        "tune", help="differentiable closed-loop controller tuning"
    )
    tu.add_argument("--controller", choices=["pid", "mpc"], default="pid")
    tu.add_argument("--trajectory", choices=["figure8", "circle"],
                    default="circle")
    tu.add_argument("--duration", type=float, default=30.0)
    tu.add_argument("--amplitude", type=float, default=6.0)
    tu.add_argument("--iterations", type=int, default=40)
    tu.add_argument("--learning-rate", type=float, default=0.06)
    tu.add_argument("--save", default=None, help="write tuned params JSON")
    tu.set_defaults(fn=_cmd_tune)

    mcp = sub.add_parser(
        "montecarlo", help="Monte-Carlo robustness study (randomized "
        "plants / winds / initial states)"
    )
    mcp.add_argument("--controller", choices=["pid", "mpc", "gp-mpc"],
                     default="mpc")
    mcp.add_argument("--gp-data", default=SYNTHETIC, help=_DATA_HELP)
    mcp.add_argument("--trajectory", choices=["figure8", "circle"],
                     default="circle")
    mcp.add_argument("--duration", type=float, default=30.0)
    mcp.add_argument("--amplitude", type=float, default=6.0)
    mcp.add_argument("--rollouts", type=int, default=256)
    mcp.add_argument("--wind-std", type=float, default=0.8)
    mcp.add_argument("--seed", type=int, default=0)
    mcp.add_argument("--plot", nargs="?", const=True, default=False,
                     help="write the dispersion figure (optional path)")
    mcp.set_defaults(fn=_cmd_montecarlo)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
