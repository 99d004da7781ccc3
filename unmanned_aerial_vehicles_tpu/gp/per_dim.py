"""Per-output-dimension ARD GPs with input/output standardisation.

Rebuild of the reference's per-dimension trainer and runtime:

* ``GPTrainer.train_gp_models`` (``/root/reference/src/px4/gp_trainer.py:121-229``):
  six independent sklearn GPs, kernel ``Const(1.0, fixed) * RBF(ARD) +
  White``, ``alpha=1e-6``, StandardScaler on inputs and each output,
  per-dimension RMSE/R^2/LML report;
* ``PreTrainedGP.predict_residual`` (``src/px4/pretrained_gp.py:13-111``):
  per-dimension prediction with std unscaling.

The six sequential sklearn fits become ONE ``vmap`` over the
output axis of the shared-input GP — six Cholesky factorisations batched
into a single kernel launch, and the per-dimension ARD hyperparameter
optimisation is a vmapped fixed-step LML ascent (the reference restarts
SciPy three times per dimension).
"""

from __future__ import annotations

from typing import Tuple

from .. import struct
import jax
import jax.numpy as jnp

from .exact_gp import (
    GPParams,
    GPPosterior,
    fit_gp,
    log_marginal_likelihood,
    optimize_hyperparameters,
    predict,
)


@struct.dataclass
class Standardizer:
    mean: jnp.ndarray
    std: jnp.ndarray

    @classmethod
    def fit(cls, data: jnp.ndarray) -> "Standardizer":
        std = jnp.std(data, axis=0)
        return cls(mean=jnp.mean(data, axis=0), std=jnp.where(std == 0, 1.0, std))

    def transform(self, data):
        return (data - self.mean) / self.std

    def inverse_transform(self, data):
        return data * self.std + self.mean


@struct.dataclass
class PerDimGP:
    """Six single-output GPs over standardized inputs, batched on axis 0."""

    posteriors: GPPosterior       # leaves with leading axis = out_dim
    scaler_X: Standardizer
    scaler_Y: Standardizer


def default_per_dim_params(input_dim: int, out_dim: int = 6) -> GPParams:
    """ARD RBF(ls=1 per input) + White(0.01), per output (gp_trainer.py:163-167)."""
    one = jnp.ones((out_dim, input_dim))
    return GPParams(
        log_length_scale=jnp.log(one),
        log_signal_variance=jnp.zeros(out_dim),   # ConstantKernel(1.0, fixed)
        log_noise_variance=jnp.full(out_dim, jnp.log(0.01)),
    )


def fit_per_dim_gp(
    X: jnp.ndarray,
    Y: jnp.ndarray,
    params: GPParams | None = None,
    jitter: float = 1e-6,
    optimize: bool = False,
    opt_steps: int = 60,
) -> PerDimGP:
    """Standardise, then vmap a single-output fit over the output axis.
    ``optimize=True`` runs the vmapped LML hyperparameter ascent first."""
    out_dim = Y.shape[1]
    if params is None:
        params = default_per_dim_params(X.shape[1], out_dim)

    sx = Standardizer.fit(X)
    sy = Standardizer.fit(Y)
    Xs = sx.transform(X)
    Ys = sy.transform(Y)

    if optimize:
        def opt_one(p, y):
            best, _ = optimize_hyperparameters(
                p, Xs, y[:, None], jitter=jitter, steps=opt_steps
            )
            return best

        params = jax.vmap(opt_one, in_axes=(0, 1))(params, Ys)

    def fit_one(p, y):
        return fit_gp(p, Xs, y[:, None], jitter=jitter, normalize_y=False)

    posteriors = jax.vmap(fit_one, in_axes=(0, 1))(params, Ys)
    return PerDimGP(posteriors=posteriors, scaler_X=sx, scaler_Y=sy)


def predict_per_dim(model: PerDimGP, X_test: jnp.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """(mean (m, out), var (m, out)) with scaler inversion
    (``pretrained_gp.py:60-100``: mean unscaled via inverse_transform, std
    scaled by the output scaler's std)."""
    Xs = model.scaler_X.transform(X_test)

    def pred_one(post):
        mean, var = predict(post, Xs, include_noise_in_variance=True)
        return mean[:, 0], var[:, 0]

    means, variances = jax.vmap(pred_one)(model.posteriors)   # (out, m)
    mean = model.scaler_Y.inverse_transform(means.T)
    var = variances.T * model.scaler_Y.std[None, :] ** 2
    return mean, var


def build_horizon_residuals_per_dim(
    model: PerDimGP,
    X_guess: jnp.ndarray,
    U_guess: jnp.ndarray,
    dt: float = 0.02,
    residual_gain: float = 0.1,
) -> jnp.ndarray:
    """Per-dimension-GP variant of the MPC horizon-residual builder —
    the ``GPEnhancedMPC.predict_gp_residuals`` role
    (``/root/reference/src/px4/gp_enhanced_mpc.py:35-692``: per-dim models +
    scalers feeding the MPC). Same state->dynamics conversion as the
    single-GP path. ``X_guess (N+1, >=6)``, ``U_guess (N, >=4)`` -> (N, 6).
    """
    N = U_guess.shape[0]
    inputs = jnp.concatenate([X_guess[:N, :6], U_guess[:, :4]], axis=1)
    mean, _ = predict_per_dim(model, inputs)     # (N, 6) state residuals
    dyn = mean / dt
    D = jnp.zeros((N, 6), mean.dtype)
    return D.at[:, 3:6].set(residual_gain * dyn[:, 3:6])


def per_dim_training_report(
    model: PerDimGP,
    X_test: jnp.ndarray,
    Y_test: jnp.ndarray,
    X_train: jnp.ndarray,
    Y_train: jnp.ndarray,
    jitter: float = 1e-6,
) -> dict:
    """Per-dimension RMSE / R^2 / LML like ``gp_trainer.py:180-200``."""
    mean, _ = predict_per_dim(model, X_test)
    out = {}
    names = ["x_residual", "y_residual", "z_residual",
             "vx_residual", "vy_residual", "vz_residual"]
    Xs = model.scaler_X.transform(X_train)
    Ys = model.scaler_Y.transform(Y_train)
    for i, name in enumerate(names[: Y_test.shape[1]]):
        err = mean[:, i] - Y_test[:, i]
        mse = float(jnp.mean(err**2))
        ss_tot = float(jnp.sum((Y_test[:, i] - jnp.mean(Y_test[:, i])) ** 2))
        params_i = jax.tree_util.tree_map(lambda a: a[i], model.posteriors.params)
        lml = float(
            log_marginal_likelihood(params_i, Xs, Ys[:, i : i + 1], jitter)
        )
        out[name] = {
            "mse": mse,
            "rmse": mse**0.5,
            "r2": 1.0 - float(jnp.sum(err**2)) / max(ss_tot, 1e-300),
            "log_marginal_likelihood": lml,
        }
    return out
