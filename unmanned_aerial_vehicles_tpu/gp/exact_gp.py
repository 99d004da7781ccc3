"""Exact multi-output Gaussian-process regression, from scratch in JAX.

Rebuild of the reference's two GP stacks on one engine:

* the from-scratch NumPy/SciPy GP
  (``/root/reference/quadrotor_gp_mpc/quadrotor_gp_mpc/gaussian_process.py:63-394``):
  RBF kernel matrix -> Cholesky -> per-output ``cho_solve`` alpha ->
  posterior mean/variance -> log marginal likelihood -> L-BFGS
  hyperparameter optimisation in log space;
* the sklearn pipeline (``/root/reference/src/px4/simple_gp.py:156-184``):
  ``RBF(0.5) + WhiteKernel(0.1)``, ``alpha=1e-4``, ``normalize_y=True`` —
  reproduced here exactly (including sklearn's target normalisation and its
  "White kernel contributes to predictive variance" semantics) so posterior
  parity to 1e-6 against the flight-data models holds (SURVEY.md section 7
  stage 3).

Design: fitting is Cholesky + triangular solves on padded
matrices, prediction is a single fused ``K_* @ alpha`` GEMM (batched over
test points AND output dimensions — the reference evaluates 25 sequential
sklearn predictions per control tick, SURVEY.md section 3.1 hot loop #1);
the LML is jitted and differentiable, so hyperparameter optimisation is
``optax`` gradient steps with a **fixed** iteration count instead of SciPy
L-BFGS-B host round-trips.
"""

from __future__ import annotations

from typing import Tuple

from .. import struct
import jax
import jax.numpy as jnp
import optax

from .kernels import rbf_kernel, rbf_kernel_diag


@struct.dataclass
class GPParams:
    """Log-space hyperparameters (``gaussian_process.py:298-303`` layout)."""

    log_length_scale: jnp.ndarray   # scalar or (d,) for ARD
    log_signal_variance: jnp.ndarray
    log_noise_variance: jnp.ndarray

    @classmethod
    def create(cls, length_scale=1.0, signal_variance=1.0, noise_variance=0.01):
        log = lambda v: jnp.log(jnp.asarray(v, dtype=jnp.result_type(float)))
        return cls(log(length_scale), log(signal_variance), log(noise_variance))

    @property
    def length_scale(self):
        return jnp.exp(self.log_length_scale)

    @property
    def signal_variance(self):
        return jnp.exp(self.log_signal_variance)

    @property
    def noise_variance(self):
        return jnp.exp(self.log_noise_variance)


@struct.dataclass
class GPPosterior:
    """Cached factorisation for fast posteriors (``gaussian_process.py:84-89``)."""

    params: GPParams
    X_train: jnp.ndarray      # (n, d)
    chol: jnp.ndarray         # (n, n) lower Cholesky of K + (noise+jitter) I
    alpha: jnp.ndarray        # (n, out) = K^{-1} Y_normalized
    y_mean: jnp.ndarray       # (out,) target normalisation (sklearn normalize_y)
    y_std: jnp.ndarray        # (out,)
    y_train_norm: jnp.ndarray  # (n, out) normalised targets (for the LML)
    # input centering: when set, X_train is stored SHIFTED (X - x_shift) and
    # queries are shifted before kernel evaluation. RBF distances are
    # shift-invariant, so predictions are mathematically unchanged — this
    # exists purely to keep the f32 squared-distance trick well-conditioned
    # for standardized-input (ARD) fits, where uncentered features like
    # z ~ 3 m / std ~ 5 mm otherwise cancel catastrophically in f32
    x_shift: jnp.ndarray | None = None   # (d,)


def _mm(a, b):
    # K_* @ alpha sums n_train products per output; at the GPU's default f32
    # matmul precision (TF32, ~3 decimal digits) that sum loses the
    # residual's small terms, so it runs at full f32
    return jnp.matmul(a, b, precision=jax.lax.Precision.HIGHEST)


def _train_kernel(params: GPParams, X: jnp.ndarray, jitter: float) -> jnp.ndarray:
    n = X.shape[0]
    K = rbf_kernel(X, X, params.length_scale, params.signal_variance)
    return K + (params.noise_variance + jitter) * jnp.eye(n, dtype=X.dtype)


def fit_gp(
    params: GPParams,
    X: jnp.ndarray,
    Y: jnp.ndarray,
    jitter: float = 0.0,
    normalize_y: bool = False,
) -> GPPosterior:
    """Cholesky fit (``gaussian_process.py:173-201``; sklearn ``.fit`` when
    ``normalize_y=True`` and ``jitter=alpha``)."""
    Y = Y if Y.ndim == 2 else Y[:, None]
    if normalize_y:
        y_mean = jnp.mean(Y, axis=0)
        y_std = jnp.std(Y, axis=0)
        y_std = jnp.where(y_std == 0.0, 1.0, y_std)  # sklearn guard
    else:
        y_mean = jnp.zeros(Y.shape[1], Y.dtype)
        y_std = jnp.ones(Y.shape[1], Y.dtype)
    Yn = (Y - y_mean) / y_std

    K = _train_kernel(params, X, jitter)
    L = jnp.linalg.cholesky(K)
    alpha = jax.scipy.linalg.cho_solve((L, True), Yn)
    return GPPosterior(
        params=params, X_train=X, chol=L, alpha=alpha,
        y_mean=y_mean, y_std=y_std, y_train_norm=Yn,
    )


def predict(
    posterior: GPPosterior,
    X_test: jnp.ndarray,
    include_noise_in_variance: bool = True,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Posterior mean and variance at a batch of test points.

    Returns ``(mean (m, out), var (m, out))``. The latent variance is shared
    across output dims (shared kernel, ``gaussian_process.py:229-233``) and
    scaled per output by ``y_std**2`` exactly as sklearn's ``normalize_y``
    predict does. With ``include_noise_in_variance`` the White-kernel noise
    appears in the predictive variance, matching sklearn's
    ``RBF + WhiteKernel`` predict.
    """
    p = posterior.params
    if posterior.x_shift is not None:
        X_test = X_test - posterior.x_shift
    K_star = rbf_kernel(X_test, posterior.X_train, p.length_scale, p.signal_variance)
    mean = _mm(K_star, posterior.alpha) * posterior.y_std + posterior.y_mean

    v = jax.scipy.linalg.solve_triangular(posterior.chol, K_star.T, lower=True)
    prior_var = rbf_kernel_diag(X_test, p.signal_variance)
    if include_noise_in_variance:
        prior_var = prior_var + p.noise_variance
    var_latent = jnp.maximum(prior_var - jnp.sum(v**2, axis=0), 1e-10)
    var = var_latent[:, None] * posterior.y_std[None, :] ** 2
    return mean, var


def predict_mean(posterior: GPPosterior, X_test: jnp.ndarray) -> jnp.ndarray:
    """Posterior mean only — ONE fused GEMM, no triangular solve.

    This is the in-control-loop path (the MPC needs residual means only,
    ``src/px4/mpc.py:1496-1506``); skipping the variance solve keeps the
    per-tick cost at a single ``(N, n_train) @ (n_train, out)`` matmul.
    """
    p = posterior.params
    if posterior.x_shift is not None:
        X_test = X_test - posterior.x_shift
    K_star = rbf_kernel(X_test, posterior.X_train, p.length_scale, p.signal_variance)
    return _mm(K_star, posterior.alpha) * posterior.y_std + posterior.y_mean


def log_marginal_likelihood(
    params: GPParams,
    X: jnp.ndarray,
    Y: jnp.ndarray,
    jitter: float = 0.0,
    normalize_y: bool = False,
) -> jnp.ndarray:
    """Multi-output LML (``gaussian_process.py:243-265``), differentiable."""
    Y = Y if Y.ndim == 2 else Y[:, None]
    if normalize_y:
        y_mean = jnp.mean(Y, axis=0)
        y_std = jnp.std(Y, axis=0)
        y_std = jnp.where(y_std == 0.0, 1.0, y_std)
        Y = (Y - y_mean) / y_std
    n, out = Y.shape

    K = _train_kernel(params, X, jitter)
    L = jnp.linalg.cholesky(K)
    alpha = jax.scipy.linalg.cho_solve((L, True), Y)

    log_det = 2.0 * jnp.sum(jnp.log(jnp.diagonal(L)))
    quad = jnp.sum(Y * alpha)
    const = n * out * jnp.log(2.0 * jnp.pi)
    return -0.5 * (out * log_det + quad + const)


def optimize_hyperparameters(
    params: GPParams,
    X: jnp.ndarray,
    Y: jnp.ndarray,
    jitter: float = 0.0,
    normalize_y: bool = False,
    steps: int = 100,
    learning_rate: float = 0.05,
) -> Tuple[GPParams, jnp.ndarray]:
    """Maximise the LML over log-hyperparameters with a fixed-step optimiser.

    Replaces the reference's SciPy ``L-BFGS-B maxiter=50`` host loop
    (``gaussian_process.py:267-324``) with in-graph ``optax.lbfgs`` (same
    quasi-Newton family, fixed iteration count, fully jittable); returns the
    best-seen parameters and the final negative LML.
    """

    def nll(p: GPParams) -> jnp.ndarray:
        return -log_marginal_likelihood(p, X, Y, jitter, normalize_y)

    opt = optax.lbfgs(learning_rate=None, memory_size=10)
    value_and_grad = optax.value_and_grad_from_state(nll)

    def step(carry, _):
        p, opt_state, best_p, best_v = carry
        value, grads = value_and_grad(p, state=opt_state)
        updates, opt_state = opt.update(
            grads, opt_state, p, value=value, grad=grads, value_fn=nll
        )
        p_new = optax.apply_updates(p, updates)
        better = value < best_v
        best_p = jax.tree_util.tree_map(
            lambda b, c: jnp.where(better, c, b), best_p, p
        )
        best_v = jnp.where(better, value, best_v)
        return (p_new, opt_state, best_p, best_v), value

    init = (params, opt.init(params), params, jnp.asarray(jnp.inf, jnp.result_type(float)))
    (p_fin, _, best_p, best_v), _ = jax.lax.scan(step, init, None, length=steps)

    final_v = nll(p_fin)
    better = final_v < best_v
    best_p = jax.tree_util.tree_map(lambda b, c: jnp.where(better, c, b), best_p, p_fin)
    best_v = jnp.minimum(best_v, final_v)
    return best_p, best_v


def optimize_hyperparameters_restarts(
    params: GPParams,
    X: jnp.ndarray,
    Y: jnp.ndarray,
    key: jax.Array,
    restarts: int = 3,
    perturbation: float = 1.0,
    jitter: float = 0.0,
    normalize_y: bool = False,
    steps: int = 100,
) -> Tuple[GPParams, jnp.ndarray]:
    """Multi-start LML maximisation (sklearn's ``n_restarts_optimizer``;
    the reference trainer uses 3 restarts, ``gp_trainer.py:169``).

    The restarts are a ``vmap`` over perturbed log-space inits —
    all optimisations run as one batched program — followed by an argmin.
    """
    noise = jax.random.normal(
        key, (restarts,) + jnp.shape(jnp.asarray(params.log_length_scale))
    )
    starts = GPParams(
        log_length_scale=params.log_length_scale + perturbation * noise,
        log_signal_variance=jnp.broadcast_to(
            params.log_signal_variance, (restarts,)
        ),
        log_noise_variance=jnp.broadcast_to(
            params.log_noise_variance, (restarts,)
        ),
    )
    # include the unperturbed start as restart 0
    starts = jax.tree_util.tree_map(
        lambda s, p: s.at[0].set(p), starts,
        jax.tree_util.tree_map(lambda a: jnp.asarray(a), params),
    )

    def run_one(p):
        return optimize_hyperparameters(
            p, X, Y, jitter=jitter, normalize_y=normalize_y, steps=steps
        )

    best_ps, nlls = jax.vmap(run_one)(starts)
    idx = jnp.nanargmin(nlls)
    best = jax.tree_util.tree_map(lambda a: a[idx], best_ps)
    return best, nlls[idx]
