"""Throughput mode and the fused GP posterior mean.

``batched_mpc_flight_sweep`` advances B flights in lockstep (one vmapped
tick), and with ``gp_posterior=`` its GP residual stage evaluates all B*N
horizon stages in one posterior-mean call: on a GPU the Triton kernel of
``ops.rbf_triton`` (the (B*N, n_train) cross-kernel never reaches device
memory), elsewhere ``gp.exact_gp.predict_mean``. Both are checked here
against an f64 ground truth on flight-like features, where the XLA path's
squared-distance trick (||z1||^2 + ||z2||^2 - 2 z1.z2) cancels at
||z||^2 ~ hundreds and the kernel's direct differences do not.
"""

import time

import jax
import jax.numpy as jnp
import numpy as np

from unmanned_aerial_vehicles_tpu.backend import gp_posterior_mean
from unmanned_aerial_vehicles_tpu.control.mpc_linear import LinearMPC, LinearMPCConfig
from unmanned_aerial_vehicles_tpu.gp import fit_residual_gp
from unmanned_aerial_vehicles_tpu.gp.exact_gp import predict_mean
from unmanned_aerial_vehicles_tpu.gp.residual_gp import ResidualGPConfig
from unmanned_aerial_vehicles_tpu.loop.closed_loop import (
    FlightLoopConfig,
    batched_mpc_flight_sweep,
)
from unmanned_aerial_vehicles_tpu.trajectories import ramped_figure8_reference
from unmanned_aerial_vehicles_tpu.utils import scaled

# ---- fit a flight-data-scale GP --------------------------------------------
gp_cfg = ResidualGPConfig()
rng = np.random.default_rng(0)
P = scaled(800, 120)
# realistic feature magnitudes (positions +-6 m, z ~ 3.4): the accuracy
# story below depends on ||z||^2 being large, as it is on real flight CSVs
X = jnp.asarray(
    rng.normal(size=(P, 10)) * np.array([6, 6, 0.3, 1, 1, 0.3, 1, 1, 0.5, 0.1])
    + np.array([0, 0, 3.4, 0, 0, 0, 0, 0, -2, 0]),
    jnp.float32,
)
Y = jnp.asarray(0.05 * rng.normal(size=(P, 6)), jnp.float32)
post = fit_residual_gp(X, Y, gp_cfg)

# ---- both posterior-mean paths vs f64 ground truth --------------------------
Xt = X[: scaled(512, 64)] + 0.01
Z64 = np.asarray(X, np.float64) / 0.5
Zt64 = np.asarray(Xt, np.float64) / 0.5
d2 = ((Zt64[:, None, :] - Z64[None, :, :]) ** 2).sum(-1)
tru = (
    np.exp(-0.5 * d2) @ np.asarray(post.alpha, np.float64)
    * np.asarray(post.y_std, np.float64)
    + np.asarray(post.y_mean, np.float64)
)
xla_err = np.abs(np.asarray(jax.jit(predict_mean)(post, Xt), np.float64) - tru).max()
kern_err = np.abs(np.asarray(
    gp_posterior_mean(post, Xt, interpret=jax.devices()[0].platform != "gpu"),
    np.float64) - tru).max()
print(f"XLA f32-HIGHEST posterior mean vs f64: max err {xla_err:.2e}")
print(f"Triton kernel posterior mean vs f64 : max err {kern_err:.2e}")

# ---- the 1024-flight sweep -------------------------------------------------
B, T = scaled(1024, 128), scaled(500, 40)
mpc = LinearMPC(LinearMPCConfig(horizon=scaled(20, 10), admm_iterations=10))
cfg = FlightLoopConfig()


def reference(t):
    pos, yaw = ramped_figure8_reference(t, amplitude=6.0, frequency=0.02)
    return pos + jnp.array([0.0, 0.0, cfg.takeoff_height]), yaw


starts = jnp.zeros((B, 12), jnp.float32).at[:, 2].set(cfg.takeoff_height)
starts = starts.at[:, 0].set(jnp.linspace(-1.0, 1.0, B))


@jax.jit
def sweep(ss):
    outs = batched_mpc_flight_sweep(
        mpc, reference, T, ss, cfg=cfg, gp_posterior=post, gp_cfg=gp_cfg,
    )
    err = outs["pos_ref"][:, None, :] - outs["state"][:, :, 0:3]
    return jnp.sqrt(jnp.mean(jnp.sum(err**2, axis=-1), axis=0))


jax.block_until_ready(sweep(starts))  # compile + warm
t0 = time.perf_counter()
rms = jax.block_until_ready(sweep(starts.at[:, 1].set(0.01)))
dt_run = time.perf_counter() - t0
print(f"\n{B} concurrent GP-MPC flights x {T} ticks on "
      f"{jax.devices()[0].device_kind}: {B * T / dt_run:.3e} flight-ticks/s")
print(f"mean RMS over flights: {float(jnp.mean(rms)):.3f} m")
