"""Full-corpus multi-chip GP training: row-sharded Gram matrix + distributed CG.

The reference's offline trainer caps itself at 10,000 of the corpus's 19,816
samples (``/root/reference/src/px4/train_gp_offline.py:155-163``) because a
single-node sklearn Cholesky is O(n^3)/O(n^2) in time/memory. This module
removes the cap on a device mesh (SURVEY.md section 2 rows P1/P3):

* the n training rows are **sharded over a 1-D device mesh** — each device
  owns ``n/D`` rows of the corpus and builds its ``(n/D, n)`` Gram block once
  (one large GEMM per device, no replication of the n x n matrix);
* the linear system ``(K + (noise + alpha) I) alpha = Y_norm`` is solved by
  **preconditioned conjugate gradients** whose per-iteration matvec is the
  sharded GEMM; the per-iteration inner products are ``jax.lax.psum``
  collectives and the iterate exchange is a tiled ``all_gather`` — both ride
  NVLink on a multi-GPU host;
* CG is preconditioned with a **Nystrom/Woodbury** approximation built from
  ``m`` anchor rows: ``P^{-1} r = (r - C S^{-1} C' r) / c`` with
  ``S = c W + C'C`` (``C = K(X, X_m)``, ``W = K(X_m, X_m)``, ``c`` the noise
  diagonal) — the standard scalable-GP trick for RBF kernels, cutting CG
  iteration counts by ~an order of magnitude.

Everything runs under ``jax.shard_map`` with explicit collectives, so the
communication pattern is visible and testable on the virtual 8-device CPU
mesh (``tests/test_distributed_gp.py``) and identical on real cards.

sklearn semantics (``simple_gp.py:156-184``: target normalisation, White
noise + alpha regularisation) are preserved exactly: on a subset the CG
solution matches the dense Cholesky fit to <= 1e-6 in f64.
"""

from __future__ import annotations

import functools
from typing import Tuple

from .. import struct
import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..gp.exact_gp import GPParams, GPPosterior
from ..gp.kernels import rbf_kernel, rbf_kernel_diag
from ..gp.residual_gp import ResidualGPConfig, default_params
from .sharding import make_mesh

_HIGH = jax.lax.Precision.HIGHEST


@struct.dataclass
class ShardedGPPosterior:
    """Row-sharded CG posterior (mean-exact; variance via CG solves)."""

    params: GPParams
    X_train: jnp.ndarray    # (n_pad, d)   rows sharded over the mesh
    mask: jnp.ndarray       # (n_pad,)     1 = real sample, 0 = padding
    alpha: jnp.ndarray      # (n_pad, out) K^{-1} Y_norm, rows sharded
    y_mean: jnp.ndarray     # (out,)
    y_std: jnp.ndarray      # (out,)
    cg_residual: jnp.ndarray  # () final max CG residual (diagnostic)

    def to_gp_posterior(self) -> GPPosterior:
        """Host-side mean-only ``GPPosterior`` view (``predict_mean`` /
        ``build_horizon_residuals`` compatible; ``chol`` is empty — variance
        queries must go through ``predict_sharded``)."""
        valid = np.asarray(self.mask) > 0.5
        return GPPosterior(
            params=self.params,
            X_train=jnp.asarray(np.asarray(self.X_train)[valid]),
            chol=jnp.zeros((0, 0), self.X_train.dtype),
            alpha=jnp.asarray(np.asarray(self.alpha)[valid]),
            y_mean=self.y_mean,
            y_std=self.y_std,
            y_train_norm=jnp.zeros((0, 0), self.X_train.dtype),
        )


def _pad_rows(a: np.ndarray, n_pad: int) -> np.ndarray:
    out = np.zeros((n_pad,) + a.shape[1:], a.dtype)
    out[: a.shape[0]] = a
    return out


def _cg(matvec, precond, b, iterations: int):
    """Matrix-RHS conjugate gradients with per-column scalars.

    ``b (n_loc, out)``; all reductions go through ``precond``/``matvec``'s
    psums, so this body is written once and runs sharded.
    """

    def dot(a, c):
        return jax.lax.psum(jnp.sum(a * c, axis=0), "batch")

    x0 = jnp.zeros_like(b)
    r0 = b
    z0 = precond(r0)
    rz0 = dot(r0, z0)

    def body(_, carry):
        x, r, z, p, rz = carry
        Ap = matvec(p)
        denom = dot(p, Ap)
        a = rz / jnp.where(denom == 0.0, 1.0, denom)
        x = x + a * p
        r = r - a * Ap
        z = precond(r)
        rz_new = dot(r, z)
        beta = rz_new / jnp.where(rz == 0.0, 1.0, rz)
        p = z + beta * p
        return x, r, z, p, rz_new

    x, r, *_ = jax.lax.fori_loop(0, iterations, body, (x0, r0, z0, z0, rz0))
    res = jnp.sqrt(jax.lax.psum(jnp.sum(r**2, axis=0), "batch"))
    return x, jnp.max(res)


@functools.lru_cache(maxsize=16)
def _fit_solver(mesh: Mesh, cg_iterations: int):
    """Cached jitted sharded-CG fit program.

    Building a fresh closure + ``jax.jit`` per fit call re-traces and
    re-lowers the whole shard_map program every time. Hyperparameters ride as traced arguments, so one
    compiled program serves every fit at a given (mesh, shape, iterations).
    """

    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P("batch"), P("batch"), P("batch"), P(), P(), P(), P()),
        out_specs=(P("batch"), P()),
    )
    def solve(X_loc, Yn_loc, mask_loc, X_anchor, ls, sv, c):
        # one (n/D, n) Gram block per device, built once
        X_full = jax.lax.all_gather(X_loc, "batch", tiled=True)
        mask_full = jax.lax.all_gather(mask_loc, "batch", tiled=True)
        K_loc = rbf_kernel(X_loc, X_full, ls, sv)
        K_loc = K_loc * mask_loc[:, None] * mask_full[None, :]

        def matvec(v_loc):
            v_full = jax.lax.all_gather(v_loc, "batch", tiled=True)
            return (
                jnp.matmul(K_loc, v_full, precision=_HIGH) + c * v_loc
            )

        # Nystrom/Woodbury preconditioner: S = c W + C'C (m x m, replicated)
        W = rbf_kernel(X_anchor, X_anchor, ls, sv)
        C_loc = rbf_kernel(X_loc, X_anchor, ls, sv) * mask_loc[:, None]
        CtC = jax.lax.psum(
            jnp.matmul(C_loc.T, C_loc, precision=_HIGH), "batch"
        )
        S = c * W + CtC
        # scale-aware jitter: with small noise and many anchors S is nearly
        # singular (cond ~ 1e9 measured on the flight corpus) — f32 Cholesky
        # would produce an indefinite preconditioner and CG diverges/NaNs.
        eps = 1e-10 if S.dtype == jnp.float64 else 1e-5
        S = S + (eps * jnp.trace(S) / S.shape[0]) * jnp.eye(
            S.shape[0], dtype=S.dtype
        )
        S_chol = jnp.linalg.cholesky(S)

        def precond(r_loc):
            Ctr = jax.lax.psum(
                jnp.matmul(C_loc.T, r_loc, precision=_HIGH), "batch"
            )
            u = jax.scipy.linalg.cho_solve((S_chol, True), Ctr)
            return (r_loc - jnp.matmul(C_loc, u, precision=_HIGH)) / c

        return _cg(matvec, precond, Yn_loc, cg_iterations)

    return jax.jit(solve)


def fit_residual_gp_sharded(
    X,
    Y,
    mesh: Mesh | None = None,
    config: ResidualGPConfig = ResidualGPConfig(),
    params: GPParams | None = None,
    cg_iterations: int = 200,
    precond_size: int = 256,
    dtype=None,
) -> ShardedGPPosterior:
    """Fit the residual GP on the FULL corpus, rows sharded over the mesh.

    Drop-in for ``gp.residual_gp.fit_residual_gp`` at corpus scale: same
    kernel, same alpha regularisation, same sklearn target normalisation —
    but O(n^2 / D) memory per device and a CG solve instead of Cholesky.
    """
    if mesh is None:
        mesh = make_mesh()
    if params is None:
        params = default_params(config)
    D = mesh.devices.size

    X = np.asarray(X)
    Y = np.asarray(Y)
    if dtype is None:
        dtype = jnp.zeros(0).dtype  # respects jax_enable_x64
    n, d = X.shape
    out = Y.shape[1]
    n_pad = int(-(-n // D) * D)

    Xp = jnp.asarray(_pad_rows(X, n_pad), dtype)
    Yp = jnp.asarray(_pad_rows(Y, n_pad), dtype)
    maskp = jnp.asarray(_pad_rows(np.ones((n, 1), np.float64), n_pad)[:, 0], dtype)

    # anchor rows for the Nystrom preconditioner (strided across the corpus)
    m = int(min(precond_size, n))
    anchors = np.linspace(0, n - 1, m).astype(int)
    X_m = jnp.asarray(X[anchors], dtype)

    # diagonal regulariser: the PARAMS' noise (which hyperparameter
    # optimisation moves) + the sklearn alpha jitter
    c = float(np.asarray(params.noise_variance)) + config.alpha

    # masked sklearn normalize_y statistics (global, replicated)
    count = jnp.asarray(float(n), dtype)
    y_mean = jnp.sum(Yp * maskp[:, None], axis=0) / count
    y_var = jnp.sum(((Yp - y_mean) ** 2) * maskp[:, None], axis=0) / count
    y_std = jnp.sqrt(y_var)
    y_std = jnp.where(y_std == 0.0, 1.0, y_std)
    Yn = ((Yp - y_mean) / y_std) * maskp[:, None]

    ls = jnp.asarray(params.length_scale, dtype)
    sv = jnp.asarray(params.signal_variance, dtype)

    shard = NamedSharding(mesh, P("batch"))
    Xs = jax.device_put(Xp, shard)
    Ys = jax.device_put(Yn, shard)
    ms = jax.device_put(maskp, shard)

    solve = _fit_solver(mesh, int(cg_iterations))
    alpha, residual = solve(Xs, Ys, ms, X_m, ls, sv, jnp.asarray(c, dtype))
    return ShardedGPPosterior(
        params=params, X_train=Xs, mask=ms, alpha=alpha,
        y_mean=y_mean, y_std=y_std, cg_residual=residual,
    )


@functools.lru_cache(maxsize=16)
def _predict_mean_gemm(mesh: Mesh):
    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P("batch"), P("batch"), P("batch"), P(), P(), P()),
        out_specs=P(),
    )
    def gemm(X_loc, a_loc, mask_loc, Xq_, ls, sv):
        Kq = rbf_kernel(Xq_, X_loc, ls, sv) * mask_loc[None, :]
        return jax.lax.psum(jnp.matmul(Kq, a_loc, precision=_HIGH), "batch")

    return jax.jit(gemm)


def predict_mean_sharded(
    posterior: ShardedGPPosterior, X_test, mesh: Mesh | None = None
) -> jnp.ndarray:
    """Posterior mean at ``X_test (q, d)``: per-device partial GEMM + psum.
    The jitted program is cached per mesh (hyperparameters are traced)."""
    if mesh is None:
        mesh = make_mesh()
    p = posterior.params
    dtype = posterior.X_train.dtype
    Xq = jnp.asarray(X_test, dtype)
    mean_n = _predict_mean_gemm(mesh)(
        posterior.X_train, posterior.alpha, posterior.mask, Xq,
        jnp.asarray(p.length_scale, dtype),
        jnp.asarray(p.signal_variance, dtype),
    )
    return mean_n * posterior.y_std + posterior.y_mean


@functools.lru_cache(maxsize=16)
def _predict_var_solver(mesh: Mesh, cg_iterations: int):
    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P("batch"), P("batch"), P("batch"), P(), P(), P(), P()),
        out_specs=(P(), P()),
    )
    def solve(X_loc, a_loc, mask_loc, Xq_, ls, sv, c):
        X_full = jax.lax.all_gather(X_loc, "batch", tiled=True)
        mask_full = jax.lax.all_gather(mask_loc, "batch", tiled=True)
        K_loc = rbf_kernel(X_loc, X_full, ls, sv)
        K_loc = K_loc * mask_loc[:, None] * mask_full[None, :]

        def matvec(v_loc):
            v_full = jax.lax.all_gather(v_loc, "batch", tiled=True)
            return jnp.matmul(K_loc, v_full, precision=_HIGH) + c * v_loc

        Kq_loc = (rbf_kernel(Xq_, X_loc, ls, sv) * mask_loc[None, :]).T  # (n/D, q)
        v_loc, _ = _cg(matvec, lambda r: r / c, Kq_loc, cg_iterations)
        quad = jax.lax.psum(jnp.sum(Kq_loc * v_loc, axis=0), "batch")  # (q,)
        mean_n = jax.lax.psum(
            jnp.matmul(Kq_loc.T, a_loc, precision=_HIGH), "batch"
        )
        return mean_n, quad

    return jax.jit(solve)


def predict_sharded(
    posterior: ShardedGPPosterior,
    X_test,
    mesh: Mesh | None = None,
    config: ResidualGPConfig = ResidualGPConfig(),
    cg_iterations: int = 200,
    include_noise_in_variance: bool = True,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Mean AND variance at ``X_test`` — variance via one sharded CG solve
    with the q query columns as simultaneous right-hand sides
    (``var = k** - k*' (K + cI)^{-1} k*``, sklearn White-in-variance
    semantics as ``exact_gp.predict``)."""
    if mesh is None:
        mesh = make_mesh()
    p = posterior.params
    dtype = posterior.X_train.dtype
    ls, sv = p.length_scale, p.signal_variance
    c = float(np.asarray(p.noise_variance)) + config.alpha
    Xq = jnp.asarray(X_test, dtype)

    mean_n, quad = _predict_var_solver(mesh, int(cg_iterations))(
        posterior.X_train, posterior.alpha, posterior.mask, Xq,
        jnp.asarray(ls, dtype), jnp.asarray(sv, dtype),
        jnp.asarray(c, dtype),
    )
    prior = rbf_kernel_diag(Xq, sv)
    if include_noise_in_variance:
        prior = prior + p.noise_variance
    var_latent = jnp.maximum(prior - quad, 1e-10)
    mean = mean_n * posterior.y_std + posterior.y_mean
    var = var_latent[:, None] * posterior.y_std[None, :] ** 2
    return mean, var


# ---------------------------------------------------------------------------
# Full-corpus hyperparameter optimisation (stochastic-trace LML gradients)
# ---------------------------------------------------------------------------
#
# Exact LML gradients need tr(Khat^-1 dK/dtheta) — an O(n^3) logdet
# derivative the reference's sklearn/GPflow optimisers get from a Cholesky
# factor, which is exactly what the full corpus cannot afford. The scalable
# recipe (GPyTorch / Gardner et al., "GPU-accelerated exact GPs"): estimate
# the trace with Hutchinson probes,
#
#     tr(Khat^-1 dK) ~= 1/P sum_p  (Khat^-1 z_p)' (dK z_p),   z_p ~ Rademacher
#
# where every solve is the SAME row-sharded preconditioned CG as the fit
# (probes and targets batch into one multi-RHS solve), and every dK matvec
# reuses the already-materialised Gram block:
#
#     dKhat/dlog sf2 = K                   -> K z
#     dKhat/dlog l   = K o (D2 / l2)       -> via 3 GEMMs on K_loc and X
#     dKhat/dlog sn2 = sn2 I               -> sn2 z
#
# ((K o D2) z expands through D2_ij = |xi|2 + |xj|2 - 2 xi.xj into
#  |xi|2 (Kz) + K(|x|2 o z) - 2 rowdot(X, K @ (X o z)) — no second matrix.)


def _lml_grad_terms(K_loc, X_loc, X_full, mask_loc, noise_var, ls_vec,
                    ard, alpha_loc, Z_loc, V_loc, out_dim, trace_scale):
    """Per-device gradient contributions. ``alpha (n/D, out)``,
    ``Z (n/D, P)`` probes, ``V = Khat^-1 Z``, ``trace_scale`` = 1/P for
    Rademacher probes or 1 for exact identity probes. ``ls_vec`` is the
    ``(d,)`` length-scale vector (broadcast from a scalar when not ARD);
    ``ard`` selects per-dimension vs summed (isotropic) length-scale
    gradients. Returns d(LML)/d(log ls, log sf2, log sn2), psum-reduced.

    Per-dimension chain rule: dK/dlog l_j = K o (Dj^2 / l_j^2) with
    Dj^2 = (x_ij - x_lj)^2, and (K o Dj^2) M expands into two extra K
    matvecs per dimension (reusing K M):
        xj^2 o (K M) + K (xj^2 o M) - 2 xj o (K (xj o M)).
    """
    mm = lambda a, b: jnp.matmul(a, b, precision=_HIGH)
    psum = lambda v: jax.lax.psum(v, "batch")
    d = X_loc.shape[1]

    M_loc = jnp.concatenate([alpha_loc, Z_loc], axis=1)   # (n/D, out + P)
    M_full = jax.lax.all_gather(M_loc, "batch", tiled=True)
    KM = mm(K_loc, M_full)
    Ka, KZ = KM[:, :out_dim], KM[:, out_dim:]

    quad_sf = psum(jnp.sum(alpha_loc * Ka))
    tr_sf = psum(jnp.sum(V_loc * KZ)) * trace_scale
    quad_sn = noise_var * psum(jnp.sum(alpha_loc * alpha_loc))
    tr_sn = noise_var * psum(jnp.sum(V_loc * Z_loc)) * trace_scale

    g_ls_dims = []
    for j in range(d):
        xj_loc = X_loc[:, j][:, None]
        xj_full = X_full[:, j][:, None]
        Aj = (
            xj_loc**2 * KM
            + mm(K_loc, xj_full**2 * M_full)
            - 2.0 * xj_loc * mm(K_loc, xj_full * M_full)
        )
        quad_j = psum(jnp.sum(alpha_loc * Aj[:, :out_dim]))
        tr_j = psum(jnp.sum(V_loc * Aj[:, out_dim:])) * trace_scale
        g_ls_dims.append(
            (0.5 * quad_j - 0.5 * out_dim * tr_j) / ls_vec[j] ** 2
        )
    g_ls_vec = jnp.stack(g_ls_dims)
    g_ls = g_ls_vec if ard else jnp.sum(g_ls_vec)

    g_sf = 0.5 * quad_sf - 0.5 * out_dim * tr_sf
    g_sn = 0.5 * quad_sn - 0.5 * out_dim * tr_sn
    return g_ls, g_sf, g_sn


def lml_grad_sharded(
    params: GPParams,
    X,
    Y,
    mesh: Mesh | None = None,
    config: ResidualGPConfig = ResidualGPConfig(),
    key=None,
    num_probes: int = 16,
    cg_iterations: int = 150,
    precond_size: int = 256,
    exact_trace: bool = False,
    dtype=None,
):
    """d(LML)/d(log length_scale, log signal_var, log noise_var) on the
    full corpus, rows sharded over the mesh. ``exact_trace=True`` replaces
    the Rademacher probes with the full identity (P = n) — exact but O(n)
    right-hand sides; for parity tests on small corpora.

    Supports scalar (isotropic, the flight GP's ``simple_gp.py:162``
    configuration) AND ``(d,)`` ARD length-scales (the per-dimension /
    GPflow trainers' configuration, ``gp_trainer.py:150-156``) — ARD
    returns a ``(d,)`` length-scale gradient. sklearn ``normalize_y``
    semantics.
    """
    if mesh is None:
        mesh = make_mesh()
    if key is None:
        key = jax.random.PRNGKey(0)
    D = mesh.devices.size
    X = np.asarray(X)
    Y = np.asarray(Y)
    if dtype is None:
        dtype = jnp.zeros(0).dtype
    n, d = X.shape
    out_dim = Y.shape[1]
    n_pad = int(-(-n // D) * D)

    Xp = jnp.asarray(_pad_rows(X, n_pad), dtype)
    Yp = jnp.asarray(_pad_rows(Y, n_pad), dtype)
    maskp = jnp.asarray(_pad_rows(np.ones((n, 1), np.float64), n_pad)[:, 0], dtype)

    m = int(min(precond_size, n))
    anchors = np.linspace(0, n - 1, m).astype(int)
    X_m = jnp.asarray(X[anchors], dtype)

    noise_var = float(np.asarray(params.noise_variance))
    c = noise_var + config.alpha
    ls_arr = np.asarray(params.length_scale)
    ard = ls_arr.ndim > 0
    ls = jnp.asarray(ls_arr, dtype)            # scalar or (d,), for kernels
    ls_vec = jnp.broadcast_to(ls, (d,)).astype(dtype)
    sv = float(np.asarray(params.signal_variance))

    count = jnp.asarray(float(n), dtype)
    y_mean = jnp.sum(Yp * maskp[:, None], axis=0) / count
    y_var = jnp.sum(((Yp - y_mean) ** 2) * maskp[:, None], axis=0) / count
    y_std = jnp.where(y_var == 0.0, 1.0, jnp.sqrt(y_var))
    Yn = ((Yp - y_mean) / y_std) * maskp[:, None]

    if exact_trace:
        Z = jnp.eye(n_pad, dtype=dtype) * maskp[:, None]
        trace_scale = 1.0  # identity probes sum to the exact trace
    else:
        Z = jax.random.rademacher(
            key, (n_pad, num_probes), dtype=dtype
        ) * maskp[:, None]
        trace_scale = 1.0 / num_probes

    shard = NamedSharding(mesh, P("batch"))
    g_ls, g_sf, g_sn = _lml_grad_solver(
        mesh, int(cg_iterations), bool(ard), int(out_dim)
    )(
        jax.device_put(Xp, shard), jax.device_put(Yn, shard),
        jax.device_put(Z, shard), jax.device_put(maskp, shard), X_m,
        ls, ls_vec, jnp.asarray(sv, dtype), jnp.asarray(c, dtype),
        jnp.asarray(noise_var, dtype), jnp.asarray(trace_scale, dtype),
    )
    return GPParams(
        log_length_scale=g_ls,
        log_signal_variance=g_sf,
        log_noise_variance=g_sn,
    )


@functools.lru_cache(maxsize=16)
def _lml_grad_solver(mesh: Mesh, cg_iterations: int, ard: bool,
                     out_dim: int):
    """Cached jitted sharded LML-gradient program (hyperparameters traced).

    ``optimize_hyperparameters_sharded`` calls this once per adam step —
    without the cache every step re-traced and re-lowered the shard_map
    program."""

    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P("batch"), P("batch"), P("batch"), P("batch"),
                  P(), P(), P(), P(), P(), P(), P()),
        out_specs=(P() if not ard else P(None), P(), P()),
    )
    def grads(X_loc, Yn_loc, Z_loc, mask_loc, X_anchor,
              ls, ls_vec, sv, c, noise_var, trace_scale):
        X_full = jax.lax.all_gather(X_loc, "batch", tiled=True)
        mask_full = jax.lax.all_gather(mask_loc, "batch", tiled=True)
        K_loc = rbf_kernel(X_loc, X_full, ls, sv)
        K_loc = K_loc * mask_loc[:, None] * mask_full[None, :]

        def matvec(v_loc):
            v_full = jax.lax.all_gather(v_loc, "batch", tiled=True)
            return jnp.matmul(K_loc, v_full, precision=_HIGH) + c * v_loc

        W = rbf_kernel(X_anchor, X_anchor, ls, sv)
        C_loc = rbf_kernel(X_loc, X_anchor, ls, sv) * mask_loc[:, None]
        CtC = jax.lax.psum(
            jnp.matmul(C_loc.T, C_loc, precision=_HIGH), "batch"
        )
        S = c * W + CtC
        # scale-aware jitter: with small noise and many anchors S is nearly
        # singular (cond ~ 1e9 measured on the flight corpus) — f32 Cholesky
        # would produce an indefinite preconditioner and CG diverges/NaNs.
        eps = 1e-10 if S.dtype == jnp.float64 else 1e-5
        S = S + (eps * jnp.trace(S) / S.shape[0]) * jnp.eye(
            S.shape[0], dtype=S.dtype
        )
        S_chol = jnp.linalg.cholesky(S)

        def precond(r_loc):
            Ctr = jax.lax.psum(
                jnp.matmul(C_loc.T, r_loc, precision=_HIGH), "batch"
            )
            u = jax.scipy.linalg.cho_solve((S_chol, True), Ctr)
            return (r_loc - jnp.matmul(C_loc, u, precision=_HIGH)) / c

        rhs = jnp.concatenate([Yn_loc, Z_loc], axis=1)
        sol, _ = _cg(matvec, precond, rhs, cg_iterations)
        alpha_loc = sol[:, :out_dim]
        V_loc = sol[:, out_dim:]
        g_ls, g_sf, g_sn = _lml_grad_terms(
            K_loc, X_loc, X_full, mask_loc, noise_var, ls_vec, ard,
            alpha_loc, Z_loc, V_loc, out_dim, trace_scale,
        )
        return g_ls, g_sf, g_sn

    return jax.jit(grads)


def optimize_hyperparameters_sharded(
    params: GPParams,
    X,
    Y,
    mesh: Mesh | None = None,
    config: ResidualGPConfig = ResidualGPConfig(),
    steps: int = 30,
    learning_rate: float = 0.05,
    num_probes: int = 16,
    cg_iterations: int = 100,
    key=None,
):
    """Full-corpus LML ascent with stochastic-trace gradients (adam).

    The mesh-scale counterpart of ``gp.exact_gp.optimize_hyperparameters``:
    no Cholesky, no logdet — every step is one multi-RHS sharded CG + a
    handful of Gram-block GEMMs, so the 19.8k-sample corpus trains without
    the reference's 10k cap. Fresh probes each step keep the gradient
    noise unbiased (SGD-style).
    """
    import optax

    if mesh is None:
        mesh = make_mesh()
    if key is None:
        key = jax.random.PRNGKey(0)
    opt = optax.adam(learning_rate)
    p = jax.tree_util.tree_map(jnp.asarray, params)
    state = opt.init(p)
    for step in range(steps):
        key, sub = jax.random.split(key)
        g = lml_grad_sharded(
            p, X, Y, mesh=mesh, config=config, key=sub,
            num_probes=num_probes, cg_iterations=cg_iterations,
        )
        # ascent on LML = descent on -LML
        neg = jax.tree_util.tree_map(lambda a: -a, g)
        updates, state = opt.update(neg, state, p)
        p = optax.apply_updates(p, updates)
    return p


# ---------------------------------------------------------------------------
# Per-output-dimension GPs at corpus scale (SeparateIndependent semantics)
# ---------------------------------------------------------------------------


@struct.dataclass
class PerDimShardedGP:
    """Six independent single-output sharded posteriors + the input scaler
    (the ``gp_trainer.py`` per-dimension pipeline without its 10k ceiling).
    Output scaling lives inside each posterior's normalize_y stats — the
    sklearn StandardScaler-on-y is algebraically identical."""

    posteriors: tuple               # out_dim x ShardedGPPosterior
    x_mean: jnp.ndarray             # (d,)
    x_std: jnp.ndarray              # (d,)


def fit_per_dim_gp_sharded(
    X,
    Y,
    mesh: Mesh | None = None,
    params: GPParams | None = None,
    jitter: float = 1e-6,
    optimize: bool = False,
    opt_steps: int = 20,
    cg_iterations: int = 200,
    precond_size: int = 256,
    key=None,
) -> PerDimShardedGP:
    """Per-dimension ARD GPs on the FULL corpus: one row-sharded CG fit per
    output with its own (optionally LML-optimised) hyperparameters —
    ``GPTrainer.train_gp_models`` (``gp_trainer.py:121-229``) at mesh scale.

    ``params`` leaves carry a leading ``out_dim`` axis
    (``gp.per_dim.default_per_dim_params`` layout).

    Precision note: the per-dim pipeline's tiny diagonal (White 0.01 +
    1e-6 jitter) makes the system condition ~1e5-1e6; f32 on-chip CG
    converges to ~1e-3 relative (the f32 floor), f64 (x64 runtime, the
    offline-parity configuration) to 1e-10.
    """
    from ..gp.per_dim import default_per_dim_params

    if mesh is None:
        mesh = make_mesh()
    if key is None:
        key = jax.random.PRNGKey(0)
    X = np.asarray(X)
    Y = np.asarray(Y)
    out_dim = Y.shape[1]
    if params is None:
        params = default_per_dim_params(X.shape[1], out_dim)

    x_mean = X.mean(axis=0)
    x_std = X.std(axis=0)
    x_std = np.where(x_std == 0.0, 1.0, x_std)
    Xs = (X - x_mean) / x_std

    cfg = ResidualGPConfig(alpha=jitter)
    posts = []
    for i in range(out_dim):
        p_i = jax.tree_util.tree_map(lambda a: jnp.asarray(a)[i], params)
        if optimize:
            key, sub = jax.random.split(key)
            p_i = optimize_hyperparameters_sharded(
                p_i, Xs, Y[:, i : i + 1], mesh=mesh, config=cfg,
                steps=opt_steps, cg_iterations=cg_iterations, key=sub,
            )
        posts.append(
            fit_residual_gp_sharded(
                Xs, Y[:, i : i + 1], mesh=mesh, config=cfg, params=p_i,
                cg_iterations=cg_iterations, precond_size=precond_size,
            )
        )
    return PerDimShardedGP(
        posteriors=tuple(posts),
        x_mean=jnp.asarray(x_mean), x_std=jnp.asarray(x_std),
    )


def predict_per_dim_sharded(
    model: PerDimShardedGP,
    X_test,
    mesh: Mesh | None = None,
    jitter: float = 1e-6,
    cg_iterations: int = 200,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """(mean (m, out), var (m, out)) — per-dimension posteriors with the
    input scaler applied (``pretrained_gp.py:60-100`` semantics)."""
    if mesh is None:
        mesh = make_mesh()
    Xq = (jnp.asarray(X_test) - model.x_mean) / model.x_std
    means, variances = [], []
    for post in model.posteriors:
        cfg = ResidualGPConfig(alpha=jitter)
        m, v = predict_sharded(post, Xq, mesh=mesh, config=cfg,
                               cg_iterations=cg_iterations)
        means.append(m[:, 0])
        variances.append(v[:, 0])
    return jnp.stack(means, axis=1), jnp.stack(variances, axis=1)
