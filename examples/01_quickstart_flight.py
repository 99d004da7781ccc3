"""Quickstart: a GP-enhanced MPC figure-8 flight as ONE jitted program.

Run:  PYTHONPATH=.. python 01_quickstart_flight.py   (from examples/)
      or with the repo root on PYTHONPATH.
"""

import jax
import jax.numpy as jnp

from unmanned_aerial_vehicles_tpu.control.mpc_linear import LinearMPC, LinearMPCConfig
from unmanned_aerial_vehicles_tpu.gp import build_horizon_residuals, fit_residual_gp
from unmanned_aerial_vehicles_tpu.io import synthetic_corpus
from unmanned_aerial_vehicles_tpu.loop import FlightLoopConfig, mpc_flight_rollout
from unmanned_aerial_vehicles_tpu.metrics import tracking_metrics
from unmanned_aerial_vehicles_tpu.trajectories import ramped_figure8_reference
from unmanned_aerial_vehicles_tpu.utils import scaled

# 1. flight data -> residual GP training set (a seeded synthetic corpus in
#    the reference's gp_datasets schema; io.load_gp_datasets reads CSVs)
X, Y = synthetic_corpus(max_samples=scaled(800, 128))

# 2. the controller and the loop configuration
mpc = LinearMPC(LinearMPCConfig())          # N=25 condensed-QP GP-MPC
cfg = FlightLoopConfig()                    # 50 Hz control, 100 Hz plant


def reference(t):
    pos, yaw = ramped_figure8_reference(t, amplitude=6.0, frequency=0.02)
    return pos + jnp.array([0.0, 0.0, cfg.takeoff_height]), yaw


# 3. GP fit + 60 s closed loop as one XLA program
@jax.jit
def fly(Xd, Yd):
    post = fit_residual_gp(Xd, Yd)
    rf = lambda Xg, Ug: build_horizon_residuals(post, Xg, Ug)
    return mpc_flight_rollout(mpc, reference, scaled(3000, 200), cfg=cfg,
                              residual_fn=rf)


outs = fly(jnp.asarray(X, jnp.float32), jnp.asarray(Y, jnp.float32))
m = tracking_metrics(
    outs["pos_ref"], outs["state"][:, 0:3], thrust_normalized=outs["thrust"]
)
print({k: round(float(v), 4) for k, v in m.items()})
