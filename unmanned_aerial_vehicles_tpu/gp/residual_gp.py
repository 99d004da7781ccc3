"""Residual-dynamics GP: learning what the double integrator misses.

Functional rebuild of ``SimpleQuadrotorGP``
(``/root/reference/src/px4/simple_gp.py:24-223``): 10-D input
``[x,y,z,vx,vy,vz,ax,ay,az,yaw_rate]`` -> 6-D state residual
``state_next - nominal(state, control, dt)``, with the reference's data
quality filters and its sklearn kernel configuration
(``RBF(0.5) + WhiteKernel(0.1)``, ``alpha=1e-4``, ``normalize_y=True``).

Design:

* ``ResidualDataset`` is a fixed-capacity ring buffer pytree — data
  collection is a masked in-graph update (jit/scan-safe), replacing the
  Python ``deque`` (``simple_gp.py:31-33``);
* ``build_horizon_residuals`` evaluates the GP posterior for the whole MPC
  horizon as ONE batched GEMM — the reference loops 25 sequential sklearn
  ``predict`` calls per control tick (``src/px4/mpc.py:1490-1506``,
  SURVEY.md hot loop #1) — and applies the reference's
  state-residual -> dynamics-residual conversion (``/dt`` then
  ``gp_residual_gain``) exactly.
"""

from __future__ import annotations

from typing import Tuple

from .. import struct
import jax
import jax.numpy as jnp

from ..models.double_integrator import double_integrator_step
from .exact_gp import GPParams, GPPosterior, fit_gp, predict, predict_mean

INPUT_DIM = 10
OUTPUT_DIM = 6


@struct.dataclass
class ResidualGPConfig:
    """Defaults = ``simple_gp.py`` constants."""

    max_data_points: int = 800         # mpc.py:1319
    dt: float = 0.02
    max_velocity_norm: float = 5.0     # simple_gp.py:128 quality filter
    max_control_norm: float = 3.0      # simple_gp.py:128 (accel commands)
    max_residual_norm: float = 2.0     # simple_gp.py:136
    length_scale: float = 0.5          # RBF(length_scale=0.5)
    noise_variance: float = 0.1        # WhiteKernel(noise_level=0.1)
    alpha: float = 1e-4                # GaussianProcessRegressor(alpha=1e-4)
    residual_gain: float = 0.1         # mpc.py:1333


@struct.dataclass
class ResidualDataset:
    """Fixed-capacity ring buffer of (input, residual) pairs."""

    X: jnp.ndarray        # (capacity, 10)
    Y: jnp.ndarray        # (capacity, 6)
    head: jnp.ndarray     # next write slot
    count: jnp.ndarray    # number of valid rows (<= capacity)


def empty_dataset(capacity: int = 800, dtype=jnp.float32) -> ResidualDataset:
    return ResidualDataset(
        X=jnp.zeros((capacity, INPUT_DIM), dtype),
        Y=jnp.zeros((capacity, OUTPUT_DIM), dtype),
        head=jnp.zeros((), jnp.int32),
        count=jnp.zeros((), jnp.int32),
    )


def add_training_sample(
    dataset: ResidualDataset,
    state: jnp.ndarray,
    control: jnp.ndarray,
    state_next: jnp.ndarray,
    config: ResidualGPConfig = ResidualGPConfig(),
) -> ResidualDataset:
    """Masked ring-buffer insert with the reference's quality filters
    (``simple_gp.py:118-141``); a rejected sample is a no-op, in-graph."""
    state6 = state[:6]
    next6 = state_next[:6]
    control4 = control[:4]

    velocity_norm = jnp.linalg.norm(state6[3:6])
    control_norm = jnp.linalg.norm(control4[:3])
    nominal_next = double_integrator_step(state6, control4, config.dt)
    residual = next6 - nominal_next
    residual_norm = jnp.linalg.norm(residual)

    accept = (
        (velocity_norm <= config.max_velocity_norm)
        & (control_norm <= config.max_control_norm)
        & (residual_norm <= config.max_residual_norm)
    )

    x_row = jnp.concatenate([state6, control4])
    capacity = dataset.X.shape[0]
    slot = dataset.head % capacity

    X = dataset.X.at[slot].set(
        jnp.where(accept, x_row.astype(dataset.X.dtype), dataset.X[slot])
    )
    Y = dataset.Y.at[slot].set(
        jnp.where(accept, residual.astype(dataset.Y.dtype), dataset.Y[slot])
    )
    head = dataset.head + accept.astype(jnp.int32)
    count = jnp.minimum(dataset.count + accept.astype(jnp.int32), capacity)
    return ResidualDataset(X=X, Y=Y, head=head, count=count)


def default_params(config: ResidualGPConfig = ResidualGPConfig()) -> GPParams:
    return GPParams.create(
        length_scale=config.length_scale,
        signal_variance=1.0,
        noise_variance=config.noise_variance,
    )


def standardized_params(
    dataset: ResidualDataset,
    config: ResidualGPConfig = ResidualGPConfig(),
    std: jnp.ndarray | None = None,
) -> GPParams:
    """ARD hyperparameters equivalent to standardizing the GP inputs.

    The reference's ONLINE GP feeds raw 10-D features into an isotropic
    RBF(0.5) (``simple_gp.py:160``) — kernel distance is dominated by the
    +-6 m position lanes, making learning local along the trajectory
    (VERDICT round-3 weak #6). Its own OFFLINE trainer standardizes inputs
    with a ``StandardScaler`` first (``gp_trainer.py:121-135``); this helper
    brings that practice to the online path: an RBF over ``(x - mu)/sigma``
    equals ARD with per-dim length scales ``l * sigma_d`` (the mean shift
    cancels in pairwise distances), so the existing kernel operands express
    it exactly, opt-in via ``OnlineFusedGPConfig.standardize_inputs``
    (default stays bit-faithful to the reference).

    ``sigma_d`` is the masked per-dim std over valid ring-buffer rows;
    zero/degenerate dims fall back to 1 (plain RBF distance on that lane).
    Fully in-graph — safe inside the cond-gated refit. Callers that already
    ran ``masked_input_stats`` (for the ``x_shift``) pass its ``std`` to
    avoid a second full pass over the ring buffer.
    """
    if std is None:
        _, std = masked_input_stats(dataset)
    return GPParams.create(
        length_scale=config.length_scale * std,
        signal_variance=1.0,
        noise_variance=config.noise_variance,
    )


def masked_input_stats(dataset: ResidualDataset):
    """Per-dim (mean, std) of the VALID ring-buffer inputs, in-graph.

    The mean doubles as the fit's ``x_shift`` (see ``GPPosterior.x_shift``):
    standardized-equivalent ARD fits must center their features or the f32
    squared-distance trick cancels catastrophically for small-std/large-
    offset dims (z ~ 3 m with mm-scale std). Degenerate dims get std 1."""
    capacity = dataset.X.shape[0]
    valid = (jnp.arange(capacity) < dataset.count)[:, None]
    count = jnp.maximum(dataset.count, 1).astype(dataset.X.dtype)
    Xv = jnp.where(valid, dataset.X, 0.0)
    mean = jnp.sum(Xv, axis=0) / count
    var = jnp.sum(jnp.where(valid, (dataset.X - mean) ** 2, 0.0), axis=0) / count
    std = jnp.sqrt(var)
    std = jnp.where(std > 1e-8, std, 1.0)
    return mean, std


def fit_residual_gp(
    X: jnp.ndarray,
    Y: jnp.ndarray,
    config: ResidualGPConfig = ResidualGPConfig(),
    params: GPParams | None = None,
) -> GPPosterior:
    """Fit on (n,10)/(n,6) arrays — sklearn ``fit`` equivalent
    (``simple_gp.py:156-177``: fixed hyperparameters, alpha regularisation,
    normalized targets)."""
    if params is None:
        params = default_params(config)
    return fit_gp(params, X, Y, jitter=config.alpha, normalize_y=True)


def fit_residual_gp_masked(
    dataset: ResidualDataset,
    config: ResidualGPConfig = ResidualGPConfig(),
    params: GPParams | None = None,
    x_shift: jnp.ndarray | None = None,
) -> GPPosterior:
    """Fit on a partially-filled ring buffer, fully in-graph (static shapes).

    This is what makes **online** GP learning jit/scan-safe: the reference
    retrains on a Python list snapshot (``simple_gp.py:156-177``, timer at
    ``gaussian_process.py:122``); here invalid buffer rows are masked out of
    the kernel matrix algebraically — masked rows get k(i, :) = 0 off-diag,
    k(i, i) = 1, y_i = 0, so their alpha is exactly 0 and they contribute
    nothing to posteriors; target normalisation uses masked statistics.

    ``x_shift`` (the standardized-input path, ``masked_input_stats``):
    inputs are centered before the kernel matrix and the posterior stores
    centered ``X_train`` plus the shift, so every consumer (staged predict,
    kernel GP rows) evaluates well-conditioned f32 distances.
    """
    if params is None:
        params = default_params(config)

    capacity = dataset.X.shape[0]
    idx = jnp.arange(capacity)
    valid = (idx < dataset.count)[:, None]  # ring buffer fills in order
    count = jnp.maximum(dataset.count, 1).astype(dataset.X.dtype)
    X_in = dataset.X if x_shift is None else dataset.X - x_shift

    # masked normalize_y (sklearn semantics over valid rows only)
    Yv = jnp.where(valid, dataset.Y, 0.0)
    y_mean = jnp.sum(Yv, axis=0) / count
    y_var = jnp.sum(jnp.where(valid, (dataset.Y - y_mean) ** 2, 0.0), axis=0) / count
    y_std = jnp.sqrt(y_var)
    y_std = jnp.where(y_std == 0.0, 1.0, y_std)
    Yn = jnp.where(valid, (dataset.Y - y_mean) / y_std, 0.0)

    from .kernels import rbf_kernel

    K = rbf_kernel(X_in, X_in, jnp.exp(params.log_length_scale),
                   jnp.exp(params.log_signal_variance))
    mask2d = valid & valid.T
    K = jnp.where(mask2d, K, 0.0)
    diag = jnp.where(
        valid[:, 0],
        jnp.diagonal(K) + jnp.exp(params.log_noise_variance) + config.alpha,
        1.0,
    )
    K = K.at[jnp.diag_indices(capacity)].set(diag)

    L = jnp.linalg.cholesky(K)
    alpha = jax.scipy.linalg.cho_solve((L, True), Yn)
    return GPPosterior(
        params=params,
        # large finite sentinel (inf would give inf-inf=NaN in the
        # squared-distance trick): k(x*, masked row) = exp(-~1e12) = 0
        X_train=jnp.where(valid, X_in, 1e6),
        chol=L,
        alpha=alpha,
        y_mean=y_mean,
        y_std=y_std,
        y_train_norm=Yn,
        x_shift=x_shift,
    )


def predict_residual(
    posterior: GPPosterior,
    state: jnp.ndarray,
    control: jnp.ndarray,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """(mean residual (6,), variance (6,)) for one (state, control) pair
    (``simple_gp.py:187-197``)."""
    x = jnp.concatenate([state[:6], control[:4]])[None, :]
    mean, var = predict(posterior, x)
    return mean[0], var[0]


def build_horizon_residuals(
    posterior: GPPosterior,
    X_guess: jnp.ndarray,
    U_guess: jnp.ndarray,
    config: ResidualGPConfig = ResidualGPConfig(),
) -> jnp.ndarray:
    """Stage-wise MPC dynamics residuals from the warm-start trajectory.

    One batched posterior over the horizon, then the reference's conversion
    (``mpc.py:1490-1506``): dynamics residual = state residual / dt, applied
    to the acceleration rows only, scaled by ``gp_residual_gain``.

    ``X_guess (N+1, 6)``, ``U_guess (N, 4)`` -> ``(N, 6)``.
    """
    N = U_guess.shape[0]
    inputs = jnp.concatenate([X_guess[:N, :6], U_guess[:, :4]], axis=1)
    mean = predict_mean(posterior, inputs)        # (N, 6) state residuals
    dyn = mean / config.dt
    D = jnp.zeros((N, OUTPUT_DIM), mean.dtype)
    return D.at[:, 3:6].set(config.residual_gain * dyn[:, 3:6])


def build_horizon_residuals_batched(
    posterior: GPPosterior,
    X_guess: jnp.ndarray,
    U_guess: jnp.ndarray,
    config: ResidualGPConfig = ResidualGPConfig(),
    interpret: bool = False,
) -> jnp.ndarray:
    """Flight-batched ``build_horizon_residuals``: one posterior-mean call
    over all ``B*N`` stage inputs, through ``backend.gp_posterior_mean``
    (the Triton kernel on CUDA, ``predict_mean`` elsewhere). Same feature
    assembly and the same ``/dt`` + ``residual_gain`` conversion
    (``src/px4/mpc.py:1490-1506``).

    ``X_guess (B, N+1, 6)``, ``U_guess (B, N, 4)`` -> ``(B, N, 6)``.
    """
    from ..backend import gp_posterior_mean

    B, N = U_guess.shape[0], U_guess.shape[1]
    inputs = jnp.concatenate(
        [X_guess[:, :N, :6], U_guess[:, :, :4]], axis=2
    ).reshape(B * N, INPUT_DIM)
    mean = gp_posterior_mean(posterior, inputs, interpret=interpret)
    dyn = mean.reshape(B, N, OUTPUT_DIM) / config.dt
    D = jnp.zeros((B, N, OUTPUT_DIM), mean.dtype)
    return D.at[:, :, 3:6].set(config.residual_gain * dyn[:, :, 3:6])


# ---------------------------------------------------------------------------
# Online (in-flight) learning: capture every tick, refit on a timer
# ---------------------------------------------------------------------------


def fit_online_gp(
    dataset: ResidualDataset,
    config: ResidualGPConfig = ResidualGPConfig(),
    standardize_inputs: bool = False,
) -> GPPosterior:
    """The in-flight refit: the reference's fixed isotropic unscaled RBF
    (``simple_gp.py:160``), or with ``standardize_inputs`` the
    standardize-equivalent ARD length scales plus the masked-mean input
    centering (``standardized_params``, ``GPPosterior.x_shift``)."""
    if not standardize_inputs:
        return fit_residual_gp_masked(dataset, config)
    shift, std = masked_input_stats(dataset)
    return fit_residual_gp_masked(
        dataset, config,
        params=standardized_params(dataset, config, std=std),
        x_shift=shift,
    )


def online_gp_update(
    dataset: ResidualDataset,
    posterior: GPPosterior,
    state_prev: jnp.ndarray,
    control_prev: jnp.ndarray,
    state: jnp.ndarray,
    tick: jnp.ndarray,
    config: ResidualGPConfig,
    refit_every: int,
    min_samples: int,
    standardize_inputs: bool = False,
):
    """One tick of in-flight learning: push the transition
    ``(state_prev, control_prev) -> state`` through the quality filters
    into the ring buffer (``src/px4/mpc.py:2016-2021``), then refit under a
    ``lax.cond`` on the last tick of every ``refit_every`` window once
    ``min_samples`` are held (the 5 s retrain timer,
    ``gaussian_process.py:122``). Returns ``(dataset, posterior, trained)``
    where ``trained`` gates the residual feedforward."""
    dataset = add_training_sample(
        dataset, state_prev[0:6], control_prev, state[0:6], config
    )
    trained = dataset.count >= min_samples
    refit = (tick % refit_every == refit_every - 1) & trained
    posterior = jax.lax.cond(
        refit,
        lambda ds: fit_online_gp(ds, config, standardize_inputs),
        lambda ds: posterior,
        dataset,
    )
    return dataset, posterior, trained


# ---------------------------------------------------------------------------
# Output-correction generation (the reference's EARLIER GP-MPC architecture)
# ---------------------------------------------------------------------------


@struct.dataclass
class OutputCorrectionConfig:
    """Constants of ``/root/reference/src/px4/mpc_gp.py:341-372`` (the file is
    byte-identical to ``mpc_original.py``): the obsolete first GP-MPC
    generation corrects the solved control POST-solve instead of entering the
    prediction model. Kept as a distinct capability for parity; the
    in-dynamics mode (``build_horizon_residuals``) superseded it."""

    correction_gain: float = 0.01       # mpc_gp.py:362
    correction_clip: float = 0.1        # mpc_gp.py:368
    confidence_threshold: float = 0.1   # mpc_gp.py:134 (uncertainty gate)
    min_train_samples: int = 500        # mpc_gp.py:346
    max_velocity_norm: float = 2.0      # mpc_gp.py:352 "system is stable"
    max_position_error: float = 5.0     # mpc_gp.py:352


def output_correction(
    posterior: GPPosterior,
    state6: jnp.ndarray,
    u_opt: jnp.ndarray,
    target_pos: jnp.ndarray,
    n_train: jnp.ndarray | int,
    config: OutputCorrectionConfig = OutputCorrectionConfig(),
) -> jnp.ndarray:
    """Post-solve GP control correction, all gates in-graph.

    The reference applies ``clip(0.01 * residual_mean[3:6], -0.1, 0.1)`` to
    the solved accelerations, but only when the GP has >= 500 samples, the
    state is "stable" (velocity < 2 m/s, position error < 5 m) and the mean
    posterior std over outputs is below the confidence threshold
    (``simple_gp.py:203-208``). The reference evaluates those gates in
    Python branches per tick; here they collapse to one ``jnp.where`` so the
    corrected controller still fuses into a single XLA program.
    """
    x = jnp.concatenate([state6[:6], u_opt[:4]])[None, :]
    mean, var = predict(posterior, x)
    uncertainty = jnp.mean(jnp.sqrt(var[0]))

    correction = jnp.clip(
        config.correction_gain * mean[0, 3:6],
        -config.correction_clip,
        config.correction_clip,
    )
    stable = (
        (jnp.linalg.norm(state6[3:6]) < config.max_velocity_norm)
        & (jnp.linalg.norm(state6[0:3] - target_pos) < config.max_position_error)
    )
    apply = (
        (jnp.asarray(n_train) >= config.min_train_samples)
        & stable
        & (uncertainty < config.confidence_threshold)
    )
    # cast: the posterior may be f64 (parity fits) while the loop is f32 —
    # an uncast scatter-add is a FutureWarning now, an error in future JAX
    return u_opt.at[0:3].add(
        jnp.where(apply, correction, 0.0).astype(u_opt.dtype)
    )


def make_output_correction_fn(
    posterior: GPPosterior,
    n_train: int,
    config: OutputCorrectionConfig = OutputCorrectionConfig(),
):
    """Bind a posterior into the rollout hook signature
    ``(state6, u_opt, target_pos) -> u_corrected``."""

    def fn(state6, u_opt, target_pos):
        return output_correction(posterior, state6, u_opt, target_pos,
                                 n_train, config)

    return fn


def build_horizon_uncertainty(
    posterior: GPPosterior,
    X_guess: jnp.ndarray,
    U_guess: jnp.ndarray,
    config: ResidualGPConfig = ResidualGPConfig(),
) -> jnp.ndarray:
    """Stage-wise GP predictive std of the DYNAMICS residual, ``(N, 6)``.

    The reference computes posterior variance but only ever logs or gates
    with it (``simple_gp.py:203-208``); this surfaces it for control use —
    uncertainty-aware constraint tightening (see
    ``LinearMPC.solve(bound_tightening=...)``, the back-off of zero-order
    GP-MPC, arXiv:2211.15522 — PAPERS.md). Same ``/dt`` and gain
    conversion as the residual means, applied to the acceleration rows.
    """
    N = U_guess.shape[0]
    inputs = jnp.concatenate([X_guess[:N, :6], U_guess[:, :4]], axis=1)
    _, var = predict(posterior, inputs)            # (N, 6) state-residual var
    std_dyn = jnp.sqrt(var) / config.dt
    S = jnp.zeros((N, OUTPUT_DIM), var.dtype)
    return S.at[:, 3:6].set(config.residual_gain * std_dyn[:, 3:6])
