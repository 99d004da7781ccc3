"""Posterior compression: the fitted GP mean as a small anchor expansion.

The in-loop cost of the exact posterior mean is one ``exp`` per
(query, training-point) pair — at the flight configuration (N=20 horizon
stages, P=800 training points) that is 16M transcendentals per 1024-flight
step of the batched sweep.

``compress_posterior`` projects the fitted mean function

    g(x) = sum_i alpha_i k(x, x_i)

onto an m-anchor expansion ``g~(x) = sum_j w_j k(x, z_j)`` by kernel
interpolation at the anchors: ``w = (K_zz + eps I)^{-1} K_zx alpha`` — i.e.
``g~`` matches ``g`` EXACTLY at the anchor locations and interpolates in
between with the same RBF smoothness (this is the subset-of-regressors
projection of sparse-GP literature applied POST-fit, so the fit itself
stays exact — unlike training-time Nystrom approximations there is no
change to the learning; only the runtime evaluation is compressed).

The result is an ordinary ``GPPosterior`` with m rows: it plugs unchanged
into ``build_horizon_residuals`` and the batched throughput sweep (a
smaller P shrinks the posterior-mean work ~P/m-fold). The predictive VARIANCE of the compressed
posterior is the anchor-expansion variance (it underestimates the true
posterior variance away from the anchors — keep the exact posterior for
uncertainty-critical paths like constraint tightening, or validate the gap
with ``compression_error``).

No reference counterpart: the reference evaluates its sklearn posterior
exactly and pays for it in its 25-sequential-predict hot loop
(``src/px4/mpc.py:1490-1506``).

APPLICABILITY CAVEAT (measured): compression needs the kernel's length
scale to be comparable to the data's spread. The flight configuration
(``RBF(0.5)`` over UNSCALED 10-D inputs spanning +-6 m,
``simple_gp.py:160``) makes the mean a sum of 800 nearly-disjoint local
bumps — no 96-anchor expansion can represent it (measured error ~100% of
the mean scale, flat in m). ``compression_error`` exists precisely to
catch this before use; compression IS effective for standardised-input
GPs (the per-dim trainer configuration, ARD over scaled inputs). For the
flight GP, use the throughput sweep's GP rate divider
(``batched_mpc_flight_sweep(gp_every=...)``) instead.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .exact_gp import GPPosterior, predict_mean
from .kernels import rbf_kernel


def select_anchors(X: jnp.ndarray, m: int) -> jnp.ndarray:
    """Strided anchor subset (the corpus trainer's policy,
    ``parallel.distributed_gp``): flight data arrives in trajectory order,
    so striding spreads anchors along the flown path."""
    n = X.shape[0]
    idx = jnp.linspace(0, n - 1, m).astype(jnp.int32)
    return X[idx]


def compress_posterior(
    posterior: GPPosterior,
    m: int = 96,
    anchors: jnp.ndarray | None = None,
    jitter: float = 1e-8,
) -> GPPosterior:
    """Compress a fitted posterior's mean to an ``m``-anchor expansion.

    Returns a ``GPPosterior`` whose ``X_train`` has ``m`` rows and whose
    ``alpha`` reproduces the exact mean at the anchors (kernel
    interpolation in between). ``chol`` holds the anchor-kernel Cholesky so
    ``predict`` still runs (variance = anchor-expansion variance — see
    module docstring).
    """
    p = posterior.params
    X = posterior.X_train
    Z = anchors if anchors is not None else select_anchors(X, m)
    dtype = X.dtype

    Kzz = rbf_kernel(Z, Z, p.length_scale, p.signal_variance)
    # scale-aware interpolation jitter (Kzz is PSD but can be nearly
    # singular when anchors cluster)
    eps = jitter * jnp.trace(Kzz) / Z.shape[0]
    Kzz = Kzz + eps * jnp.eye(Z.shape[0], dtype=dtype)
    Kzx = rbf_kernel(Z, X, p.length_scale, p.signal_variance)

    # g(z) in NORMALISED target space (alpha was computed against Y_norm)
    g_z = Kzx @ posterior.alpha                       # (m, out)
    L = jnp.linalg.cholesky(Kzz)
    w = jax.scipy.linalg.cho_solve((L, True), g_z)    # (m, out)

    # chol for the variance path: anchor kernel + noise (sklearn-style)
    Kn = Kzz + jnp.asarray(p.noise_variance, dtype) * jnp.eye(
        Z.shape[0], dtype=dtype
    )
    Ln = jnp.linalg.cholesky(Kn)
    return GPPosterior(
        params=p,
        X_train=Z,   # anchors live in the same (possibly shifted) frame
        chol=Ln,
        alpha=w,
        y_mean=posterior.y_mean,
        y_std=posterior.y_std,
        y_train_norm=g_z,
        x_shift=posterior.x_shift,
    )


def compression_error(
    posterior: GPPosterior,
    compressed: GPPosterior,
    X_eval: jnp.ndarray,
) -> jnp.ndarray:
    """Max |exact mean - compressed mean| over evaluation points, per
    output — the quantity to check before trusting a compression level."""
    exact = predict_mean(posterior, X_eval)
    approx = predict_mean(compressed, X_eval)
    return jnp.max(jnp.abs(exact - approx), axis=0)
