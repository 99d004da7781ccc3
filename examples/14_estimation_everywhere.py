"""Estimation everywhere: multi-rate LTV and learning from estimates.

(1) ``noisy_ltv_rollout``: the LTV tracking MPC (the cvxpy engine's role,
``quadrotor_gp_mpc/mpc_controller.py:123-368``) gets a MULTI-RATE
estimator loop — plant + rigid-body EKF at the 100 Hz sensor rate, the
solve every 10th plant tick flying the ESTIMATE. That is exactly the reference's
rate split (100 Hz plant under the 10 Hz cvxpy timer,
``main.py:814-826``) with the PX4-EKF2 role brought in-graph; obstacle
rows compose. (2) online + noisy on the 6-state loop: the in-flight
GP trains on EKF ESTIMATES — the reference's actual data path, since the
flight node's captured "state" is PX4-EKF2 output
(``src/px4/mpc.py:1889-1907,2016-2021``) — and still recovers the
wind-induced tracking penalty.
"""

import jax
import jax.numpy as jnp
import numpy as np

from unmanned_aerial_vehicles_tpu.control import LTVTrackingMPC
from unmanned_aerial_vehicles_tpu.control.mpc_linear import (
    LinearMPC,
    LinearMPCConfig,
)
from unmanned_aerial_vehicles_tpu.estimation import (
    EKFConfig,
    noisy_ltv_rollout,
    noisy_mpc_flight_rollout,
)
from unmanned_aerial_vehicles_tpu.gp.residual_gp import ResidualGPConfig
from unmanned_aerial_vehicles_tpu.loop import (
    FlightLoopConfig,
    OnlineFusedGPConfig,
)
from unmanned_aerial_vehicles_tpu.models import RigidBodyParams
from unmanned_aerial_vehicles_tpu.trajectories import (
    ramped_circle_reference,
    ramped_figure8_reference,
)
from unmanned_aerial_vehicles_tpu.utils import scaled

# --- 1. multi-rate estimation for the LTV engine ------------------------
LDT = 0.1
HEIGHT = 3.0
mpc_ltv = LTVTrackingMPC(num_obstacles=1, obstacle_margin=0.2)
N = mpc_ltv.mpc.config.horizon
obstacles = jnp.asarray([[0.0, 1.5, HEIGHT, 0.3]], jnp.float32)


def window_at(i):
    ts = (i + jnp.arange(N + 1)).astype(jnp.float32) * LDT

    def ref12(t):
        pos, _, _ = ramped_circle_reference(t, amplitude=1.5, height=HEIGHT)
        return jnp.concatenate(
            [jnp.asarray(pos, jnp.float32), jnp.zeros(9, jnp.float32)]
        )

    return jax.vmap(ref12)(ts)


STEPS10 = scaled(100, 12)
outs = jax.jit(lambda: noisy_ltv_rollout(
    mpc_ltv, window_at, STEPS10, jax.random.PRNGKey(0),
    ekf_cfg=EKFConfig(), obstacles=obstacles,
))()
st = np.asarray(outs["state"])
est = np.asarray(outs["state_est"])
ref_pos = np.asarray(outs["pos_ref"])
rms = float(np.sqrt(np.mean(np.sum((st[:, 0:3] - ref_pos) ** 2, -1))))
est_err = float(np.sqrt(np.mean(np.sum(
    (est[2:, 0:3] - st[2:, 0:3]) ** 2, -1))))
d = st[:, None, 0:3] - np.asarray(obstacles)[None, :, 0:3]
clear = float(np.min(np.sqrt(np.sum(d ** 2, -1))
                     - np.asarray(obstacles)[None, :, 3]))
print(
    f"ltv12 multi-rate noisy tier ({STEPS10} solves @ 10 Hz, 10 EKF "
    f"subticks @ 100 Hz each): tracking RMS {rms:.4f} m, estimate RMS "
    f"{est_err * 100:.1f} cm, obstacle clearance {clear:.3f} m"
)

# --- 2. online learning from EKF estimates (wind recovery) --------------
windy = RigidBodyParams(wind=(1.5, 0.8, 0.0))
STEPS = scaled(1600, 160)
TAIL = STEPS // 2


def ref(t):
    pos, yaw = ramped_figure8_reference(t, amplitude=6.0, frequency=0.02)
    return pos + jnp.array([0.0, 0.0, HEIGHT]), yaw


mpc = LinearMPC(LinearMPCConfig(horizon=20, admm_iterations=60))
cfg = FlightLoopConfig()
ekf_cfg = EKFConfig()

plain = jax.jit(lambda: noisy_mpc_flight_rollout(
    mpc, ref, STEPS, jax.random.PRNGKey(2), ekf_cfg=ekf_cfg,
    body=windy, cfg=cfg, preview=True))()
ogp = OnlineFusedGPConfig(
    gp=ResidualGPConfig(max_data_points=256, residual_gain=1.0),
    refit_every=scaled(200, 48),  # fast mode must fire a refit too
)
online = jax.jit(lambda: noisy_mpc_flight_rollout(
    mpc, ref, STEPS, jax.random.PRNGKey(2), ekf_cfg=ekf_cfg,
    body=windy, cfg=cfg, preview=True, online_gp=ogp, gp_gain=1.0))()


def tail_rms(o):
    e = np.linalg.norm(np.asarray(o["pos_ref"] - o["state"][:, 0:3]), axis=1)
    return float(np.sqrt((e[TAIL:] ** 2).mean()))


print(
    f"windy fig-8, learning FROM ESTIMATES ({STEPS} ticks): plain noisy "
    f"{tail_rms(plain):.3f} m -> online-noisy {tail_rms(online):.3f} m "
    f"(GP samples {int(np.asarray(online['gp_count'])[-1])}; capture, "
    f"refit, EKF and solve in one scan)"
)
