"""12-state Monte-Carlo dispersion study + the noisy 6-state loop.

(1) ``loop.monte_carlo_mpc12``: the torque-input 12-state family (the
reference's ``mpc_FULL.py:86-549`` formulation) flown as a POPULATION — one
``vmap`` of the multitick SQP rollout over jittered true plants while the
controller keeps its nominal model. The study surfaces a real robustness
cliff: members whose hover demand reaches the engine's 1.2x-nominal thrust
bound (~+17 % mass) saturate and tip, lighter members only sag — a
single-plant evaluation (all the reference has) cannot see this. (2) the
sensors -> EKF -> MPC -> plant loop: what the EKF costs in tracking against
the same flight on the true state.
"""

import jax
import numpy as np

from unmanned_aerial_vehicles_tpu.control.mpc_linear import (
    LinearMPC,
    LinearMPCConfig,
)
from unmanned_aerial_vehicles_tpu.control.mpc_rigid import RigidBodyMPC
from unmanned_aerial_vehicles_tpu.estimation import (
    EKFConfig,
    noisy_mpc_flight_rollout,
)
from unmanned_aerial_vehicles_tpu.loop import (
    MonteCarloConfig,
    monte_carlo_mpc12,
    mpc_flight_rollout,
)
from unmanned_aerial_vehicles_tpu.trajectories import ramped_circle_reference
from unmanned_aerial_vehicles_tpu.utils import scaled


def reference(t):
    pos, _, yaw = ramped_circle_reference(t, amplitude=2.0, height=3.0)
    return pos, yaw


# --- 1. 12-state population robustness ---------------------------------
N_MEMBERS = scaled(64, 4)
STEPS = scaled(480, 64)

eng = RigidBodyMPC()
mc = MonteCarloConfig(n_rollouts=N_MEMBERS, settle_steps=scaled(100, 16))
stats = jax.jit(lambda: monte_carlo_mpc12(eng, reference, STEPS, mc=mc))()
print(
    f"12-state MC ({N_MEMBERS} members, {STEPS} ticks): "
    f"success {float(stats['success_rate']) * 100:.1f}%, "
    f"RMS p50 {float(stats['rms_p50']):.2f} m, "
    f"p99 {float(stats['rms_p99']):.2f} m"
)
rms = np.asarray(stats["rms_pos"])
ok = np.asarray(stats["success"])
if not ok.all():
    print(
        "  crashed members are the HEAVY tail (hover demand at the 1.2x-"
        "nominal thrust bound); light members only sag — the asymmetric "
        "cliff a single-plant run cannot measure"
    )

# --- 2. the noisy loop vs the true-state loop ---------------------------
EKF_STEPS = scaled(960, 64)
mpc6 = LinearMPC(LinearMPCConfig(horizon=20, admm_iterations=10))


def rms_of(outs):
    err = np.linalg.norm(
        np.asarray(outs["state"][:, 0:3]) - np.asarray(outs["pos_ref"]),
        axis=1,
    )
    skip = scaled(100, 16)
    return float(np.sqrt((err[skip:] ** 2).mean()))


rms_noisy = rms_of(jax.jit(lambda: noisy_mpc_flight_rollout(
    mpc6, reference, EKF_STEPS, jax.random.PRNGKey(0), ekf_cfg=EKFConfig(),
))())
rms_truth = rms_of(jax.jit(lambda: mpc_flight_rollout(
    mpc6, reference, EKF_STEPS))())
print(
    f"6-state loop RMS: on the true state {rms_truth:.4f} m, "
    f"on the EKF estimate {rms_noisy:.4f} m"
)
