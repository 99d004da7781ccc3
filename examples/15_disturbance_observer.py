"""Learning-free wind rejection: the augmented-EKF disturbance observer.

The reference's only answer to unmodelled forces is the GP residual model
— learned offline from logged flights or retrained on a 5 s timer
(``/root/reference/src/px4/simple_gp.py:147-154``,
``gaussian_process.py:122``). This example demonstrates the classical
alternative the reference never ships (``estimation/disturbance.py``):
extend the EKF state with a random-walk acceleration disturbance, let the
filter attribute the innovation the nominal model cannot explain to it,
and feed the estimate to the MPC as the same stage-wise residual rows the
GP path uses. Three flights on the noisy windy figure-8:

1. plain noisy MPC — eats the full wind penalty;
2. + disturbance observer — recovers most of it, with NO dataset, NO
   refits, and convergence within a few filter time constants;
3. observer + offline GP residuals — the two compose additively
   (``noisy_mpc_flight_rollout`` sums the rows), so the GP corrects what
   the observer's constant-accel model cannot;
4. a mid-flight GUST (``wind_fn=`` — the wind steps to a direction never
   seen): the scenario no frozen learned model survives — the observer
   re-converges within ~2 s (campaign rows ``*_gusty_figure8`` show a
   PERFECT model of the pre-gust wind flying WORSE than nothing).
"""

import jax
import jax.numpy as jnp
import numpy as np

from unmanned_aerial_vehicles_tpu.control import LinearMPC, LinearMPCConfig
from unmanned_aerial_vehicles_tpu.estimation import (
    DisturbanceEKFConfig,
    noisy_mpc_flight_rollout,
)
from unmanned_aerial_vehicles_tpu.loop import FlightLoopConfig
from unmanned_aerial_vehicles_tpu.models import RigidBodyParams
from unmanned_aerial_vehicles_tpu.trajectories import ramped_figure8_reference
from unmanned_aerial_vehicles_tpu.utils import scaled
from unmanned_aerial_vehicles_tpu.utils.examples import fast_examples

cfg = FlightLoopConfig()


def fig8(t):
    pos, yaw = ramped_figure8_reference(t, amplitude=scaled(6.0, 2.0))
    return pos + jnp.array([0.0, 0.0, cfg.takeoff_height]), yaw


WIND = (1.5, 0.8, 0.0)
windy = RigidBodyParams(wind=WIND)
mpc = LinearMPC(LinearMPCConfig())
num_steps = scaled(2400, 300)  # 48 s vs 6 s smoke
key = jax.random.PRNGKey(0)


def fly(**kw):
    outs = jax.jit(
        lambda: noisy_mpc_flight_rollout(
            mpc, fig8, num_steps, key, cfg=cfg, preview=True, body=windy,
            **kw,
        )
    )()
    outs = {k: np.asarray(v) for k, v in outs.items()}
    e = np.linalg.norm(outs["pos_ref"] - outs["state"][:, 0:3], axis=1)
    tail = float(np.sqrt((e[len(e) // 2:] ** 2).mean()))
    return outs, tail


# --- 1. plain noisy flight in wind ---------------------------------------
_, rms_plain = fly()
print(f"plain noisy windy fig8      : tail RMS {rms_plain:.3f} m")

# --- 2. + the disturbance observer ---------------------------------------
outs, rms_dob = fly(disturbance_observer=True)
d_tail = outs["disturbance_est"][num_steps // 2:].mean(axis=0)
print(f"+ disturbance observer      : tail RMS {rms_dob:.3f} m, "
      f"d_est = [{d_tail[0]:+.2f} {d_tail[1]:+.2f} {d_tail[2]:+.2f}] m/s^2")

# the q_dist knob trades convergence speed against noise rejection
fast_cfg = DisturbanceEKFConfig(q_dist=0.2)
_, rms_fast = fly(disturbance_observer=fast_cfg)
print(f"  (q_dist 0.05 -> 0.2       : tail RMS {rms_fast:.3f} m — faster "
      f"tracking, more sensor noise passed into the feedforward)")

# --- 3. observer + GP residuals compose ----------------------------------
# a tiny GP fit on the observer flight's own residual-looking data stands in
# for the offline corpus here (examples/02 shows the full pipeline); the
# point is the residual_fn + observer rows SUM inside the loop.
from unmanned_aerial_vehicles_tpu.gp.residual_gp import (
    ResidualGPConfig,
    build_horizon_residuals,
    fit_residual_gp,
)

gcfg = ResidualGPConfig(max_data_points=scaled(64, 16))
rng = np.random.default_rng(0)
Xd = rng.uniform(-1, 1, (gcfg.max_data_points, 10)).astype(np.float32)
Yd = 0.01 * rng.standard_normal((gcfg.max_data_points, 6)).astype(np.float32)
post = jax.jit(lambda x, y: fit_residual_gp(x, y, gcfg))(
    jnp.asarray(Xd), jnp.asarray(Yd)
)
residual_fn = lambda Xg, Ug: build_horizon_residuals(post, Xg, Ug, gcfg)
_, rms_both = fly(disturbance_observer=True, residual_fn=residual_fn)
print(f"+ observer + GP residuals   : tail RMS {rms_both:.3f} m "
      f"(near-zero GP: matches the observer row — the paths compose)")

assert rms_dob < rms_plain, (rms_dob, rms_plain)

# --- 4. gust: the wind steps mid-flight ----------------------------------
T_GUST = scaled(24.0, 3.0)
w_post = jnp.asarray([-1.0, 1.5, 0.0], jnp.float32)
w_pre = jnp.asarray(WIND, jnp.float32)
wind_fn = lambda t: jnp.where(t < T_GUST, w_pre, w_post)

outs_g, rms_g = fly(disturbance_observer=True, wind_fn=wind_fn)
_, rms_g_plain = fly(wind_fn=wind_fn)
d_post = outs_g["disturbance_est"][num_steps // 2:].mean(axis=0)
print(f"gust at t={T_GUST:.0f}s         : plain tail RMS "
      f"{rms_g_plain:.3f} m -> observer {rms_g:.3f} m; post-gust d_est = "
      f"[{d_post[0]:+.2f} {d_post[1]:+.2f} {d_post[2]:+.2f}] "
      f"(wind flipped to [-1.0, +1.5, 0])")

# the estimate's x-component flips with the wind in any workload; the
# tracking win needs a settled post-gust window (the full 48 s flight —
# the 6 s smoke run's tail is entirely the ~2 s re-convergence transient)
assert d_post[0] < 0.0, d_post
if not fast_examples():
    assert rms_g < rms_g_plain, (rms_g, rms_g_plain)
print("OK: the observer recovers the wind penalty without learning, "
      "and adapts to wind no frozen model has seen")
