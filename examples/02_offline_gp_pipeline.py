"""Offline GP pipeline: train on flight CSVs, optimise hyperparameters with
restarts, evaluate nominal-vs-GP, write the reference metrics CSV layout."""

import os
import tempfile

import jax
import jax.numpy as jnp
import numpy as np

from unmanned_aerial_vehicles_tpu.gp import (
    evaluate_gp,
    fit_gp,
    optimize_hyperparameters_restarts,
    predict_mean,
)
from unmanned_aerial_vehicles_tpu.gp.residual_gp import ResidualGPConfig, default_params
from unmanned_aerial_vehicles_tpu.io import save_gp_checkpoint, synthetic_corpus
from unmanned_aerial_vehicles_tpu.utils import scaled

# a seeded synthetic corpus in the gp_datasets schema (io.load_gp_datasets
# reads flight CSVs)
X, Y = synthetic_corpus(max_samples=scaled(600, 128))
Xj, Yj = jnp.asarray(X, jnp.float32), jnp.asarray(Y, jnp.float32)
cfg = ResidualGPConfig()

params, nll = optimize_hyperparameters_restarts(
    default_params(cfg), Xj, Yj, jax.random.PRNGKey(0),
    restarts=scaled(3, 2), jitter=cfg.alpha, normalize_y=True,
    steps=scaled(40, 8),
)
print(f"optimised nll: {float(nll):.1f}, "
      f"length_scale: {float(jnp.exp(params.log_length_scale)):.3f}")

post = fit_gp(params, Xj, Yj, jitter=cfg.alpha, normalize_y=True)
out = os.path.join(tempfile.mkdtemp(), "gp_tuned")
save_gp_checkpoint(out + ".npz", post, X, Y, jitter=cfg.alpha)

results = evaluate_gp(
    lambda x: np.asarray(predict_mean(post, jnp.asarray(x, jnp.float32))),
    X, Y, save_prefix=out,
)
print("global improvement: "
      f"{results['global']['improvement_%']:.1f}% (metrics at {out}_metrics.csv)")
