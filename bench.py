#!/usr/bin/env python3
"""Benchmark of the GP-MPC closed loop on the GPU: prints ONE JSON line.

    python3 bench.py

Three forms users run, each through its library entry point, timed with
``block_until_ready`` after a compile + warm-up call:

* ``rt``:    one vehicle learning in flight (``mpc_flight_rollout`` with an
             800-point ring refit every 250 ticks, N=20, figure-8 at 6 m /
             0.02 Hz) — ticks per second and microseconds per tick;
* ``batch``: 1,024 flights of the same loop with a frozen 800-point
             posterior (``batched_mpc_flight_sweep``) — flight-ticks per
             second;
* ``gp``:    the 19,816 x 10 -> 6 synthetic corpus fitted by the sharded CG
             trainer on one card — seconds per fit.

Correctness against the plain references is ``chip_smoke.py``'s job; this
script measures. It fails when JAX finds no GPU.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time


def _time(fn, *args, reps=3):
    import jax

    compiled = jax.jit(fn).lower(*args).compile()
    jax.block_until_ready(compiled(*args))            # warm
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(compiled(*args))
        best = min(best, time.perf_counter() - t0)
    return best


def main() -> int:
    import jax
    import jax.numpy as jnp

    from unmanned_aerial_vehicles_tpu.backend import require_gpu, setup_compile_cache

    try:
        devices = require_gpu()
    except RuntimeError as e:
        print(f"bench: {e}", file=sys.stderr)
        return 3
    setup_compile_cache()

    from chip_smoke import GP_POINTS, HORIZON, REFIT_EVERY, fig8, frozen_posterior, starts_grid
    from unmanned_aerial_vehicles_tpu.control.mpc_linear import LinearMPC, LinearMPCConfig
    from unmanned_aerial_vehicles_tpu.gp.residual_gp import ResidualGPConfig
    from unmanned_aerial_vehicles_tpu.io import synthetic_corpus
    from unmanned_aerial_vehicles_tpu.loop import OnlineFusedGPConfig, mpc_flight_rollout
    from unmanned_aerial_vehicles_tpu.loop.closed_loop import batched_mpc_flight_sweep
    from unmanned_aerial_vehicles_tpu.parallel import fit_residual_gp_sharded, make_mesh

    mpc = LinearMPC(LinearMPCConfig(horizon=HORIZON))
    ticks, B, T = 6600, 1024, 500

    ogp = OnlineFusedGPConfig(
        gp=ResidualGPConfig(max_data_points=GP_POINTS), refit_every=REFIT_EVERY
    )
    x0 = jnp.zeros(12, jnp.float32).at[2].set(3.0)
    t_rt = _time(lambda x: mpc_flight_rollout(
        mpc, fig8, ticks, online_gp=ogp, initial_state=x)["state"], x0)

    post = frozen_posterior()
    t_batch = _time(lambda s: batched_mpc_flight_sweep(
        mpc, fig8, T, s, gp_posterior=post)["state"], starts_grid(B))

    X, Y = synthetic_corpus()
    mesh = make_mesh(1)
    fit = lambda: fit_residual_gp_sharded(X, Y, mesh=mesh, dtype=jnp.float32)
    jax.block_until_ready(fit().alpha)
    t0 = time.perf_counter()
    jax.block_until_ready(fit().alpha)
    t_gp = time.perf_counter() - t0

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip()
    d = devices[0]
    print(json.dumps({
        "device": {"platform": d.platform, "kind": d.device_kind,
                   "count": len(devices), "nvidia_smi": card},
        "rt_ticks_per_s": ticks / t_rt,
        "rt_us_per_tick": t_rt / ticks * 1e6,
        "batch_flight_ticks_per_s": B * T / t_batch,
        "gp_corpus_fit_s": t_gp,
        "gp_corpus_rows": int(X.shape[0]),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
