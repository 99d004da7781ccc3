"""Full-corpus GP training on the device mesh — no 10k down-sampling.

The reference's offline trainer caps itself at 10,000 samples
(``train_gp_offline.py:155-163``). Here a whole corpus of the reference's
size (19,816 samples; the seeded synthetic stand-in, or your own CSVs via
``io.load_gp_datasets``) fits AND hyperparameter-trains via the
row-sharded preconditioned-CG machinery (``parallel.distributed_gp``).

On CPU, set: JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8
"""

import jax
import jax.numpy as jnp

from unmanned_aerial_vehicles_tpu.gp.residual_gp import ResidualGPConfig, default_params
from unmanned_aerial_vehicles_tpu.io import synthetic_corpus
from unmanned_aerial_vehicles_tpu.utils import scaled
from unmanned_aerial_vehicles_tpu.parallel import (
    fit_residual_gp_sharded,
    make_mesh,
    optimize_hyperparameters_sharded,
    predict_mean_sharded,
)

cfg = ResidualGPConfig()
X, Y = synthetic_corpus(max_samples=scaled(None, 512))  # FULL corpus
print(f"corpus: {X.shape[0]} samples")

mesh = make_mesh()  # every visible device

# stochastic-trace LML ascent (Hutchinson probes through the sharded CG)
params = optimize_hyperparameters_sharded(
    default_params(cfg), X, Y, mesh=mesh, config=cfg,
    steps=scaled(10, 2), num_probes=scaled(16, 4),
    cg_iterations=scaled(100, 30),
)
print(f"optimised: ls={float(params.length_scale):.4f} "
      f"sf2={float(params.signal_variance):.4f} "
      f"sn2={float(params.noise_variance):.4f}")

# row-sharded Gram + Nystrom-preconditioned CG fit
post = fit_residual_gp_sharded(X, Y, mesh=mesh, config=cfg, params=params)
print(f"fit CG residual: {float(post.cg_residual):.2e}")

mean = predict_mean_sharded(post, jnp.asarray(X[:8]), mesh=mesh)
print("posterior means:", jax.numpy.round(mean[:2], 4))

# host-side view plugs straight into the control loop
view = post.to_gp_posterior()
print("control-loop-ready posterior on", view.X_train.shape[0], "points")
