#!/usr/bin/env python3
"""Smoke run of the GP-MPC closed loop on the GPU, with parity checks.

    python3 chip_smoke.py               # one card: phases rt, batch, gp
    python3 chip_smoke.py --four-cards  # four cards: the sharded paths only

Phases (one card):

* ``rt``    one vehicle learning in flight: ``mpc_flight_rollout`` with
            ``OnlineFusedGPConfig(refit_every=250)``, an 800-point ring,
            N=20, 6,600 ticks of the figure-8 (the reference's 132 s
            campaign at 50 Hz); compared with the same entry point on the
            host CPU backend.
* ``batch`` 1,024 flights x 500 ticks through ``batched_mpc_flight_sweep``
            with a frozen 800-point posterior, the GP stage once through
            the Triton kernel and once through plain XLA; 128 flights
            compared with single-flight rollouts, and the kernel's
            residuals compared with ``vmap(build_horizon_residuals)`` at the
            full 20,480 x 800 x 6 shape.
* ``gp``    the 19,816 x 10 -> 6 synthetic corpus fitted by
            ``fit_residual_gp_sharded`` on a one-card mesh, compared on
            1,000 held-out inputs with an exact f64 Cholesky fit.

``--four-cards``: 4,096 flights sharded over four cards against the same
flights on one card, and the sharded CG corpus fit on a four-card mesh
against the one-card fit.

Every phase prints compile and run seconds (``block_until_ready``), the
peak device bytes in use, and each parity error beside its tolerance. Any
failure exits non-zero; without a GPU the script stops before any phase.
The last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import functools
import json
import math
import os
import subprocess
import sys
import time

FIG8_AMPLITUDE, FIG8_FREQUENCY, TAKEOFF = 6.0, 0.02, 3.0
HORIZON, GP_POINTS, REFIT_EVERY = 20, 800, 250


class SmokeFailure(Exception):
    pass


def log(msg: str) -> None:
    print(msg, flush=True)


def check(name: str, value: float, tol: float, why: str) -> None:
    ok = math.isfinite(value) and value <= tol
    log(f"  parity {name}: {value:.3e} (tolerance {tol:.1e}: {why}) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise SmokeFailure(f"{name} = {value!r} exceeds {tol!r}")


def timed(fn, *args):
    """(compiled, out, compile_s, run_s) for ``jax.jit(fn)(*args)``."""
    import jax

    t0 = time.perf_counter()
    compiled = jax.jit(fn).lower(*args).compile()
    t1 = time.perf_counter()
    out = jax.block_until_ready(compiled(*args))
    return compiled, out, t1 - t0, time.perf_counter() - t1


def rerun(compiled, *args):
    import jax

    t0 = time.perf_counter()
    out = jax.block_until_ready(compiled(*args))
    return out, time.perf_counter() - t0


def peak_bytes(device) -> int:
    stats = device.memory_stats() or {}
    return int(stats.get("peak_bytes_in_use", -1))


def fig8(t):
    import jax.numpy as jnp

    from unmanned_aerial_vehicles_tpu.trajectories import ramped_figure8_reference

    pos, yaw = ramped_figure8_reference(
        t, amplitude=FIG8_AMPLITUDE, frequency=FIG8_FREQUENCY
    )
    return pos + jnp.array([0.0, 0.0, TAKEOFF], pos.dtype), yaw


def rms_per_flight(states, pos_ref):
    """``states (T, [B,] 12)``, ``pos_ref (T, 3)`` -> RMS position error."""
    import jax.numpy as jnp

    ref = pos_ref if states.ndim == 2 else pos_ref[:, None, :]
    err = jnp.sum((states[..., 0:3] - ref) ** 2, axis=-1)
    return jnp.sqrt(jnp.mean(err, axis=0))


def starts_grid(B):
    import jax.numpy as jnp

    s = jnp.zeros((B, 12), jnp.float32).at[:, 2].set(TAKEOFF)
    s = s.at[:, 0].set(jnp.linspace(-1.0, 1.0, B, dtype=jnp.float32))
    return s.at[:, 1].set(jnp.linspace(0.5, -0.5, B, dtype=jnp.float32) ** 3)


def frozen_posterior(points=GP_POINTS):
    import jax
    import jax.numpy as jnp

    from unmanned_aerial_vehicles_tpu.gp import fit_residual_gp
    from unmanned_aerial_vehicles_tpu.io import synthetic_corpus

    X, Y = synthetic_corpus(max_samples=points)
    return jax.jit(fit_residual_gp)(
        jnp.asarray(X, jnp.float32), jnp.asarray(Y, jnp.float32)
    )


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def phase_rt(device, ticks=6600, capacity=GP_POINTS, compare_ticks=500):
    import jax
    import jax.numpy as jnp

    from unmanned_aerial_vehicles_tpu.control.mpc_linear import (
        LinearMPC,
        LinearMPCConfig,
    )
    from unmanned_aerial_vehicles_tpu.gp.residual_gp import ResidualGPConfig
    from unmanned_aerial_vehicles_tpu.loop import (
        OnlineFusedGPConfig,
        mpc_flight_rollout,
    )

    log(f"phase rt: one vehicle, online GP ({capacity}-point ring, refit "
        f"every {REFIT_EVERY}), N={HORIZON}, {ticks} ticks")
    mpc = LinearMPC(LinearMPCConfig(horizon=HORIZON))
    ogp = OnlineFusedGPConfig(
        gp=ResidualGPConfig(max_data_points=capacity), refit_every=REFIT_EVERY
    )

    def flight(x0):
        outs = mpc_flight_rollout(mpc, fig8, ticks, online_gp=ogp,
                                  initial_state=x0)
        return outs["state"], outs["pos_ref"], outs["gp_count"]

    x0 = jnp.zeros(12, jnp.float32).at[2].set(TAKEOFF)
    compiled, (st, ref, count), tc, tr = timed(flight, jax.device_put(x0, device))
    _, tr2 = rerun(compiled, jax.device_put(x0, device))
    log(f"  gpu: compile {tc:.2f} s, run {tr:.3f} s, rerun {tr2:.3f} s "
        f"({ticks / tr2:.0f} ticks/s), final ring count {int(count[-1])}")
    log(f"  peak device bytes in use: {peak_bytes(device)}")
    cpu = jax.devices("cpu")[0]
    with jax.default_device(cpu):
        _, (st_c, ref_c, count_c), tcc, trc = timed(flight, jax.device_put(x0, cpu))
    log(f"  host cpu: compile {tcc:.2f} s, run {trc:.3f} s")

    st, st_c = jax.device_get(st), jax.device_get(st_c)
    rms_g = float(rms_per_flight(jnp.asarray(st), jnp.asarray(jax.device_get(ref))))
    rms_c = float(rms_per_flight(jnp.asarray(st_c), jnp.asarray(jax.device_get(ref_c))))
    gap = float(jnp.max(jnp.abs(st[:compare_ticks, 0:3] - st_c[:compare_ticks, 0:3])))
    log(f"  whole-flight RMS: gpu {rms_g:.6f} m, cpu {rms_c:.6f} m")
    check(f"max position gap gpu vs cpu, first {compare_ticks} ticks [m]", gap,
          1e-3, "f32 on both; sums reorder on the card and the closed loop "
          "carries last-bit differences through two refits")
    check("|RMS gpu - RMS cpu| whole flight [m]", abs(rms_g - rms_c), 5e-3,
          "6,600 closed-loop ticks amplify last-bit differences; the "
          "campaign RMS figures move by mm, not cm")
    if not bool(jnp.all(jnp.isfinite(st))):
        raise SmokeFailure("rt: non-finite states")


def phase_batch(device, B=1024, T=500, n_check=128, points=GP_POINTS):
    import jax
    import jax.numpy as jnp

    from unmanned_aerial_vehicles_tpu.control.mpc_linear import (
        LinearMPC,
        LinearMPCConfig,
    )
    from unmanned_aerial_vehicles_tpu.gp import build_horizon_residuals
    from unmanned_aerial_vehicles_tpu.gp.residual_gp import (
        ResidualGPConfig,
        build_horizon_residuals_batched,
    )
    from unmanned_aerial_vehicles_tpu.io import synthetic_corpus
    from unmanned_aerial_vehicles_tpu.loop import mpc_flight_rollout
    from unmanned_aerial_vehicles_tpu.loop.closed_loop import (
        batched_mpc_flight_sweep,
    )

    log(f"phase batch: {B} flights x {T} ticks, N={HORIZON}, frozen "
        f"{points}-point posterior")
    gcfg = ResidualGPConfig()
    mpc = LinearMPC(LinearMPCConfig(horizon=HORIZON))
    with jax.default_device(device):
        post = frozen_posterior(points)
    starts = jax.device_put(starts_grid(B), device)

    def sweep_kernel(s):
        o = batched_mpc_flight_sweep(mpc, fig8, T, s, gp_posterior=post,
                                     gp_cfg=gcfg)
        return o["state"], o["pos_ref"]

    def sweep_xla(s):
        rf = functools.partial(build_horizon_residuals, post, config=gcfg)
        o = batched_mpc_flight_sweep(mpc, fig8, T, s, residual_fn=rf)
        return o["state"], o["pos_ref"]

    ck, (st_k, ref_k), tck, trk = timed(sweep_kernel, starts)
    cx, (st_x, ref_x), tcx, trx = timed(sweep_xla, starts)
    _, trx2 = rerun(cx, starts)
    _, trk2 = rerun(ck, starts)
    run_k, run_x = min(trk, trk2), min(trx, trx2)
    log(f"  GP stage through the Triton kernel: compile {tck:.2f} s, run "
        f"{run_k:.4f} s ({B * T / run_k:.3e} flight-ticks/s)")
    log(f"  GP stage through plain XLA:         compile {tcx:.2f} s, run "
        f"{run_x:.4f} s ({B * T / run_x:.3e} flight-ticks/s)")
    log(f"  end-to-end sweep time kernel/XLA: {run_k / run_x:.3f}")
    log(f"  peak device bytes in use: {peak_bytes(device)}")

    rms_k = rms_per_flight(st_k, ref_k)
    rms_x = rms_per_flight(st_x, ref_x)
    check("max per-flight RMS gap, kernel vs XLA sweep [m]",
          float(jnp.max(jnp.abs(rms_k - rms_x))), 1e-4,
          "the two GP stages differ in f32 summation order only")

    def single(x0):
        o = mpc_flight_rollout(mpc, fig8, T, initial_state=x0,
                               gp_posterior=post, gp_gain=gcfg.residual_gain,
                               gp_dt=gcfg.dt)
        return o["state"], o["pos_ref"]

    cs, _, tcs, _ = timed(single, starts[0])
    gaps = []
    for b in range(n_check):
        (st1, ref1), _ = rerun(cs, starts[b])
        gaps.append(abs(float(rms_per_flight(st1, ref1)) - float(rms_k[b])))
    log(f"  {n_check} single-flight rollouts (HIGHEST): compile {tcs:.2f} s")
    check(f"max per-flight RMS gap, sweep vs {n_check} single flights [m]",
          max(gaps), 1e-4,
          "batched vs unbatched GEMMs and the kernel's f32 sums reorder "
          "last bits; the closed loop keeps them small")

    # the kernel's residuals at the sweep's full shape
    X, _ = synthetic_corpus(num_rows=B * HORIZON, seed=1)
    X = jnp.asarray(X, jnp.float32).reshape(B, HORIZON, 10)
    Xg = jnp.concatenate([X[:, :, 0:6], X[:, -1:, 0:6]], axis=1)
    Ug = X[:, :, 6:10]
    Xg, Ug = jax.device_put(Xg, device), jax.device_put(Ug, device)
    _, got, tcg, trg = timed(
        lambda a, b: build_horizon_residuals_batched(post, a, b, gcfg), Xg, Ug
    )
    _, want, _, trw = timed(
        lambda a, b: jax.vmap(
            lambda x, u: build_horizon_residuals(post, x, u, gcfg)
        )(a, b),
        Xg, Ug,
    )
    scale = float(jnp.max(jnp.abs(want)))
    rel = float(jnp.max(jnp.abs(got - want))) / max(scale, 1e-30)
    log(f"  residuals {B * HORIZON} x {points} x 6: kernel run {trg * 1e3:.3f} "
        f"ms, vmapped XLA run {trw * 1e3:.3f} ms (one call each, compile "
        f"{tcg:.2f} s)")
    check("max |kernel - vmap(build_horizon_residuals)| / max|ref|", rel, 1e-3,
          "f32 sums of 800 terms in another order, and the XLA reference's "
          "squared-distance trick cancels ~1e-5 of |x|^2")
    if not bool(jnp.all(jnp.isfinite(st_k))):
        raise SmokeFailure("batch: non-finite states")


def _corpus_fit(mesh, X, Y, Xh, cg_iterations=200):
    """Sharded f32 CG fit (timed twice: compile + run, then run), its true
    relative residual ``max_j |(K + cI) a_j - y_j| / |y_j|`` over the
    normalised target columns, and the predictive mean at ``Xh``."""
    import jax.numpy as jnp
    import numpy as np

    from unmanned_aerial_vehicles_tpu.gp.residual_gp import ResidualGPConfig
    from unmanned_aerial_vehicles_tpu.parallel import (
        fit_residual_gp_sharded,
        predict_mean_sharded,
    )

    t0 = time.perf_counter()
    post = fit_residual_gp_sharded(X, Y, mesh=mesh, cg_iterations=cg_iterations,
                                   dtype=jnp.float32)
    float(post.cg_residual)
    t1 = time.perf_counter()
    post = fit_residual_gp_sharded(X, Y, mesh=mesh, cg_iterations=cg_iterations,
                                   dtype=jnp.float32)
    float(post.cg_residual)
    t2 = time.perf_counter()
    mean = predict_mean_sharded(post, jnp.asarray(Xh, jnp.float32), mesh=mesh)

    n = X.shape[0]
    f64 = lambda a: np.asarray(a, np.float64)
    y_mean, y_std = f64(post.y_mean), f64(post.y_std)
    K_alpha = (f64(predict_mean_sharded(post, jnp.asarray(X, jnp.float32),
                                        mesh=mesh)) - y_mean) / y_std
    alpha = f64(post.alpha)[:n]
    c = float(np.asarray(post.params.noise_variance)) + ResidualGPConfig().alpha
    y_n = (f64(Y) - y_mean) / y_std
    resid = np.linalg.norm(K_alpha + c * alpha - y_n, axis=0)
    rel = float(np.max(resid / np.linalg.norm(y_n, axis=0)))
    return post, rel, mean, t1 - t0, t2 - t1


def phase_gp(device, rows=None, held=1000):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from unmanned_aerial_vehicles_tpu.gp import fit_residual_gp, predict_mean
    from unmanned_aerial_vehicles_tpu.io import CORPUS_ROWS, synthetic_corpus
    from unmanned_aerial_vehicles_tpu.parallel import make_mesh

    rows = rows or CORPUS_ROWS
    log(f"phase gp: synthetic corpus {rows} x 10 -> 6, sharded CG on a "
        f"one-card mesh, {held} held-out inputs")
    X, Y = synthetic_corpus(num_rows=rows)
    Xh, _ = synthetic_corpus(num_rows=held, seed=1)
    mesh = make_mesh(1)
    _, res, mean, t_first, t_run = _corpus_fit(mesh, X, Y, Xh)
    log(f"  CG fit: first call (compile + run) {t_first:.2f} s, run "
        f"{t_run:.3f} s, true relative CG residual {res:.3e}")
    log(f"  peak device bytes in use: {peak_bytes(device)}")
    with jax.enable_x64(True), jax.default_device(device):
        t0 = time.perf_counter()
        exact = jax.jit(fit_residual_gp)(jnp.asarray(X, jnp.float64),
                                         jnp.asarray(Y, jnp.float64))
        want = jax.block_until_ready(predict_mean(exact, jnp.asarray(Xh, jnp.float64)))
        t_exact = time.perf_counter() - t0
        y_mean = np.asarray(exact.y_mean)
    want = np.asarray(want)
    log(f"  exact f64 Cholesky fit + predict (compile + run): {t_exact:.2f} s")
    log(f"  peak device bytes in use: {peak_bytes(device)}")
    scale = float(np.max(np.abs(want - y_mean)))
    gap = float(np.max(np.abs(np.asarray(mean, np.float64) - want)))
    check("true relative CG residual", res, 1e-3,
          "200 preconditioned CG iterations reach the f32 Gram "
          "matvec floor (1e-5 to 1e-4 in the CPU rehearsal)")
    check("max |CG mean - exact f64 mean| / max|exact - y_mean|",
          gap / max(scale, 1e-30), 1e-3,
          "f32 Gram entries and CG against an f64 Cholesky")


def phase_four_cards(devices, B=4096, T=500, rows=None, held=1000):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from unmanned_aerial_vehicles_tpu.control.mpc_linear import (
        LinearMPC,
        LinearMPCConfig,
    )
    from unmanned_aerial_vehicles_tpu.gp.residual_gp import ResidualGPConfig
    from unmanned_aerial_vehicles_tpu.io import CORPUS_ROWS, synthetic_corpus
    from unmanned_aerial_vehicles_tpu.loop.closed_loop import (
        batched_mpc_flight_sweep,
    )
    from unmanned_aerial_vehicles_tpu.parallel import make_mesh
    from unmanned_aerial_vehicles_tpu.parallel.sweep import (
        sharded_structured_flight_sweep,
    )

    if len(devices) < 4:
        raise SmokeFailure(f"--four-cards needs 4 GPUs, JAX sees {len(devices)}")
    mesh4 = make_mesh(4)
    log(f"phase sweep4: {B} flights x {T} ticks sharded over 4 cards")
    gcfg = ResidualGPConfig()
    mpc = LinearMPC(LinearMPCConfig(horizon=HORIZON))
    with jax.default_device(devices[0]):
        post = frozen_posterior()
    starts = starts_grid(B)
    t0 = time.perf_counter()
    out4 = sharded_structured_flight_sweep(
        mesh4, mpc, fig8, T, starts, gp_posterior=post, gp_cfg=gcfg
    )
    rms4 = jax.block_until_ready(out4["rms_per_flight"])
    t_first = time.perf_counter() - t0
    t0 = time.perf_counter()
    out4 = sharded_structured_flight_sweep(
        mesh4, mpc, fig8, T, starts, gp_posterior=post, gp_cfg=gcfg
    )
    rms4 = jax.block_until_ready(out4["rms_per_flight"])
    t4 = time.perf_counter() - t0
    for shard in rms4.addressable_shards:
        idx = shard.index[0]
        log(f"  shard flights {idx.start}:{idx.stop} on {shard.device}")
    if len({s.device for s in rms4.addressable_shards}) != 4:
        raise SmokeFailure("sweep4: shards do not sit on four cards")
    log(f"  4 cards: first call (compile + run) {t_first:.2f} s, run {t4:.3f} s "
        f"({B * T / t4:.3e} flight-ticks/s)")

    def one_card(s):
        o = batched_mpc_flight_sweep(mpc, fig8, T, s, gp_posterior=post,
                                     gp_cfg=gcfg)
        return rms_per_flight(o["state"], o["pos_ref"])

    _, rms1, tc1, tr1 = timed(one_card, jax.device_put(starts, devices[0]))
    log(f"  1 card: compile {tc1:.2f} s, run {tr1:.3f} s "
        f"({B * T / tr1:.3e} flight-ticks/s)")
    for d in devices[:4]:
        log(f"  peak device bytes in use on {d}: {peak_bytes(d)}")
    check("max per-flight RMS gap, 4 cards vs 1 card [m]",
          float(np.max(np.abs(np.asarray(rms4) - np.asarray(rms1)))), 1e-4,
          "each card runs the one-card program on its block of flights")

    rows = rows or CORPUS_ROWS
    log(f"phase gp4: sharded CG fit of {rows} rows, 4-card mesh vs 1 card")
    X, Y = synthetic_corpus(num_rows=rows)
    Xh, _ = synthetic_corpus(num_rows=held, seed=1)
    post4, res4, mean4, tf4, tr4 = _corpus_fit(mesh4, X, Y, Xh)
    rows_on = {s.device for s in post4.X_train.addressable_shards}
    log(f"  training rows sit on {len(rows_on)} cards: "
        f"{sorted(str(d) for d in rows_on)}")
    if len(rows_on) != 4:
        raise SmokeFailure("gp4: rows do not sit on four cards")
    post1, res1, mean1, tf1, tr1 = _corpus_fit(make_mesh(1), X, Y, Xh)
    log(f"  4 cards: first call {tf4:.2f} s, run {tr4:.3f} s, true relative "
        f"CG residual {res4:.3e}; 1 card: first call {tf1:.2f} s, run "
        f"{tr1:.3f} s, residual {res1:.3e}")
    check("true relative CG residual, 4 cards", res4, 1e-3,
          "200 preconditioned CG iterations reach the f32 Gram "
          "matvec floor (1e-5 to 1e-4 in the CPU rehearsal)")
    m4, m1 = np.asarray(mean4), np.asarray(mean1)
    scale = float(np.max(np.abs(m1 - np.asarray(post1.y_mean))))
    check("max |mean 4 cards - mean 1 card| / max|mean - y_mean|",
          float(np.max(np.abs(m4 - m1))) / max(scale, 1e-30), 1e-3,
          "psum over four cards reorders the f32 CG sums")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--four-cards", action="store_true",
                        help="run only the sharded paths, on four cards")
    args = parser.parse_args(argv)
    here = os.path.dirname(os.path.abspath(__file__))
    try:
        import jax

        from unmanned_aerial_vehicles_tpu.backend import (
            REPO_ROOT,
            require_gpu,
            setup_compile_cache,
        )
    except ImportError as e:
        print(f"chip_smoke: cannot import the package ({e}); run it from "
              "the root of a checkout", file=sys.stderr)
        return 2
    if os.path.realpath(REPO_ROOT) != os.path.realpath(here):
        print(f"chip_smoke: the package comes from {REPO_ROOT}, not from this "
              "checkout; run the script from the root of a checkout",
              file=sys.stderr)
        return 2
    try:
        devices = require_gpu()
    except RuntimeError as e:
        print(f"chip_smoke: {e}", file=sys.stderr)
        return 3
    setup_compile_cache()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    for line in card.splitlines():
        log(f"card: {line}")
    log(f"jax {jax.__version__}, {len(devices)} x {devices[0].device_kind}")
    t0 = time.perf_counter()
    try:
        if args.four_cards:
            phase_four_cards(devices)
        else:
            phase_rt(devices[0])
            phase_batch(devices[0])
            phase_gp(devices[0])
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    log(f"total {time.perf_counter() - t0:.1f} s")
    d = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(jax.devices()),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
