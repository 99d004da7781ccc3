"""Mesh-sharded batch sweep: 64 closed-loop flights across all devices.

On CPU, set: JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8
"""

import jax
import jax.numpy as jnp

from unmanned_aerial_vehicles_tpu.control.mpc_linear import LinearMPC, LinearMPCConfig
from unmanned_aerial_vehicles_tpu.loop import FlightLoopConfig, mpc_flight_rollout
from unmanned_aerial_vehicles_tpu.parallel import make_mesh, sharded_flight_sweep
from unmanned_aerial_vehicles_tpu.trajectories import ramped_figure8_reference
from unmanned_aerial_vehicles_tpu.utils import scaled

cfg = FlightLoopConfig()
mpc = LinearMPC(LinearMPCConfig())


def reference(t):
    pos, yaw = ramped_figure8_reference(t)
    return pos + jnp.array([0.0, 0.0, cfg.takeoff_height]), yaw


def one_flight(x0):
    return mpc_flight_rollout(mpc, reference, scaled(1000, 128), cfg=cfg,
                              initial_state=x0)


B = scaled(64, 16)
starts = jnp.zeros((B, 12), jnp.float32).at[:, 2].set(cfg.takeoff_height)
starts = starts.at[:, 0].set(jnp.linspace(-2.0, 2.0, B))

mesh = make_mesh()
result = sharded_flight_sweep(mesh, one_flight, starts)
print(f"{B} flights on {len(jax.devices())} device(s): "
      f"rms mean {float(result['rms_mean']):.3f} m, "
      f"max {float(result['rms_max']):.3f} m")

# -- throughput mode: the batched sweep over the mesh ------------------------
# Every flight advances in lockstep as one vmapped tick per device; the GP
# residual stage evaluates all B*N horizon stages in one posterior-mean call
# (the Triton kernel on a GPU, plain XLA elsewhere).
from unmanned_aerial_vehicles_tpu.gp import fit_residual_gp
from unmanned_aerial_vehicles_tpu.gp.residual_gp import ResidualGPConfig
from unmanned_aerial_vehicles_tpu.io import synthetic_corpus
from unmanned_aerial_vehicles_tpu.parallel import sharded_structured_flight_sweep

gp_cfg = ResidualGPConfig()
X, Y = synthetic_corpus(max_samples=scaled(400, 64))
post = fit_residual_gp(jnp.asarray(X, jnp.float32), jnp.asarray(Y, jnp.float32),
                       gp_cfg)
result_k = sharded_structured_flight_sweep(
    mesh, mpc, reference, scaled(500, 64), starts,
    gp_posterior=post, gp_cfg=gp_cfg,
)
print(f"batched GP-MPC sweep: "
      f"rms mean {float(result_k['rms_mean']):.3f} m, "
      f"max {float(result_k['rms_max']):.3f} m")
