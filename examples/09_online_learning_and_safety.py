"""One vehicle with everything on: ONLINE in-flight GP learning,
uncertainty-aware constraint tightening from the posterior variance, the
divergence-triggered recovery fallback, and a dispersed-plant Monte-Carlo
study of the same loop.

The GP the MPC flies is refit from the ring buffer every 5 s of flight
time — the reference's retrain policy (gaussian_process.py:122) — while
plant parameters and wind are traced, so the whole study vmaps without
recompiling.
"""

import jax
import jax.numpy as jnp
import numpy as np

from unmanned_aerial_vehicles_tpu.control.mpc_linear import LinearMPC, LinearMPCConfig
from unmanned_aerial_vehicles_tpu.gp.residual_gp import ResidualGPConfig
from unmanned_aerial_vehicles_tpu.loop import (
    FlightLoopConfig,
    MonteCarloConfig,
    OnlineFusedGPConfig,
    monte_carlo_mpc,
    mpc_flight_rollout,
)
from unmanned_aerial_vehicles_tpu.models import RigidBodyParams
from unmanned_aerial_vehicles_tpu.trajectories import ramped_figure8_reference
from unmanned_aerial_vehicles_tpu.utils import scaled

mpc = LinearMPC(
    LinearMPCConfig(
        horizon=20,
        admm_iterations=10,
        tightening_factor=2.0,   # back the state boxes off by 2 sigma of
    )                            # the GP posterior std
)
cfg = FlightLoopConfig(
    fallback_error_m=1.5,        # divergence-triggered recovery
)


def reference(t):
    pos, yaw = ramped_figure8_reference(t, amplitude=6.0, frequency=0.02)
    return pos + jnp.array([0.0, 0.0, cfg.takeoff_height]), yaw


# --- 1. online learning under an unmodelled steady wind -------------------
windy = RigidBodyParams(wind=(1.5, 0.8, 0.0))
ogp = OnlineFusedGPConfig(
    gp=ResidualGPConfig(max_data_points=256, residual_gain=1.0),
    refit_every=scaled(250, 64),
)

plain = jax.jit(
    lambda: mpc_flight_rollout(mpc, reference, scaled(2000, 256), body=windy,
                               cfg=cfg, preview=True)
)()
online = jax.jit(
    lambda: mpc_flight_rollout(mpc, reference, scaled(2000, 256), body=windy,
                               cfg=cfg, preview=True, online_gp=ogp,
                               gp_gain=1.0)
)()


def rms_tail(outs):
    e = np.linalg.norm(np.asarray(outs["pos_ref"] - outs["state"][:, 0:3]),
                       axis=1)
    return float(np.sqrt((e[scaled(1000, 128):] ** 2).mean()))


print(f"windy fig-8, plain MPC:        {rms_tail(plain):.3f} m RMS")
print(f"windy fig-8, ONLINE GP-MPC:    {rms_tail(online):.3f} m RMS "
      f"({int(online['gp_count'][-1])} samples learned in flight)")

# --- 2. dispersed-plant Monte-Carlo of the same loop ------------------------
stats = jax.jit(
    lambda: monte_carlo_mpc(
        mpc, reference, scaled(1504, 256),
        mc=MonteCarloConfig(n_rollouts=scaled(64, 8), wind_std=0.8),
        loop_cfg=cfg,
    )
)()
print(
    f"64-flight dispersion study: "
    f"success {float(stats['success_rate']) * 100:.1f} %, "
    f"worst excursion {float(stats['worst_max_pos']):.2f} m, "
    f"median RMS {float(stats['rms_p50']):.3f} m"
)
