"""The 12-state torque family end to end: multitick loop + EKF.

Two capabilities for the reference's full 12-state formulation
(``src/px4/mpc_FULL.py:86-549``). (1) ``sqp_multitick_rollout``: the
torque-SQP engine relinearised once per K ticks, against the per-tick
engine's answer (the per-dispatch anchor costs little RMS). (2)
``noisy_rigid_mpc_rollout``: the estimator joins the 12-state loop — noisy
sensors -> rigid-body EKF (pluggable process model,
``ekf_step(step_fn=...)``) -> controller flying the ESTIMATE -> true plant.
The reference always flew PX4-EKF2's output; here the whole chain is one
``lax.scan`` and the estimator-induced tracking cost is measurable (~1e-3 m
on this task).
"""

import jax
import jax.numpy as jnp
import numpy as np

from unmanned_aerial_vehicles_tpu.control.mpc_rigid import RigidBodyMPC
from unmanned_aerial_vehicles_tpu.estimation import EKFConfig
from unmanned_aerial_vehicles_tpu.estimation.noisy_loop import (
    noisy_rigid_mpc_rollout,
)
from unmanned_aerial_vehicles_tpu.loop.rigid_loop import sqp_multitick_rollout
from unmanned_aerial_vehicles_tpu.models import X500_PARAMS, rigid_body_rk4_step
from unmanned_aerial_vehicles_tpu.trajectories import ramped_circle_reference
from unmanned_aerial_vehicles_tpu.utils import scaled

DT = 0.02
HEIGHT = 3.0


def reference(t):
    pos, _, yaw = ramped_circle_reference(t, amplitude=2.0, height=HEIGHT)
    return pos, yaw


eng = RigidBodyMPC()
N = eng.mpc.config.horizon


def reference_fn(ticks):
    ts = ticks.astype(jnp.float32) * DT
    pos, _, _ = jax.vmap(
        lambda t: ramped_circle_reference(t, amplitude=2.0, height=HEIGHT)
    )(ts)
    stage = jnp.concatenate([pos, jnp.zeros((ts.shape[0], 9))], axis=1)
    return jnp.tile(stage[:, None, :], (1, N, 1))


def rms_vs_ref(states):
    ts = np.arange(states.shape[0]) * DT
    refs = np.stack([
        np.asarray(ramped_circle_reference(t, amplitude=2.0,
                                           height=HEIGHT)[0]) for t in ts
    ])
    return float(np.sqrt(np.mean(np.sum(
        (np.asarray(states[:, 0:3]) - refs) ** 2, -1))))


# --- 1. multitick loop at two dispatch lengths ---------------------------
STEPS = scaled(480, 40)
ITERS = 10
x0 = jnp.zeros(12, jnp.float32).at[2].set(HEIGHT)
plant = lambda x, u: rigid_body_rk4_step(x, u, X500_PARAMS, DT)


def multitick(K):
    return jax.jit(lambda: sqp_multitick_rollout(
        eng.mpc, eng.cost, reference_fn, plant, x0, STEPS,
        ticks_per_dispatch=K, admm_iterations=ITERS, u_init=eng.u_hover,
    ))()


k_short, k_long = 2, scaled(20, 4)
print(
    f"torque-SQP multitick ({ITERS} ADMM iters, {STEPS} ticks): "
    f"RMS {rms_vs_ref(multitick(k_short)['state']):.4f} m at K={k_short}, "
    f"{rms_vs_ref(multitick(k_long)['state']):.4f} m at K={k_long}"
)

# --- 2. the estimator joins the 12-state loop ---------------------------
NOISY_STEPS = scaled(480, 40)
outs = jax.jit(lambda: noisy_rigid_mpc_rollout(
    eng, reference, NOISY_STEPS, jax.random.PRNGKey(0),
    ekf_cfg=EKFConfig(), dt=DT, takeoff_height=HEIGHT))()
st = np.asarray(outs["state"])
est = np.asarray(outs["state_est"])
meas = np.asarray(outs["meas_pos"])
skip = scaled(40, 8)
est_err = float(np.sqrt(np.mean(np.sum(
    (est[skip:, 0:3] - st[skip:, 0:3]) ** 2, -1))))
meas_err = float(np.sqrt(np.mean(np.sum(
    (meas[skip:] - st[skip:, 0:3]) ** 2, -1))))
print(
    f"noisy 12-state loop ({NOISY_STEPS} ticks): tracking RMS "
    f"{rms_vs_ref(outs['state']):.4f} m; EKF position estimate "
    f"{est_err * 100:.1f} cm vs raw sensor {meas_err * 100:.1f} cm "
    f"(unmeasured velocity reconstructed by the filter)"
)
