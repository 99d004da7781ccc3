"""Multi-chip full-corpus GP training (parallel.distributed_gp).

Validates the row-sharded Gram + preconditioned-CG trainer on the virtual
8-device CPU mesh against the dense single-chip Cholesky fit — the parity
contract that lets ``train-gp --all-samples`` replace the reference's 10k
down-sampling cap (``/root/reference/src/px4/train_gp_offline.py:155-163``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from unmanned_aerial_vehicles_tpu.gp import fit_residual_gp
from unmanned_aerial_vehicles_tpu.gp.exact_gp import predict, predict_mean
from unmanned_aerial_vehicles_tpu.gp.residual_gp import ResidualGPConfig
from unmanned_aerial_vehicles_tpu.io import load_gp_datasets
from unmanned_aerial_vehicles_tpu.parallel import (
    fit_residual_gp_sharded,
    make_mesh,
    predict_mean_sharded,
    predict_sharded,
)
from unmanned_aerial_vehicles_tpu.parallel.distributed_gp import _cg

@pytest.fixture(scope="module")
def corpus(flight_csvs):
    X, Y = load_gp_datasets(flight_csvs, max_samples=300)
    return np.asarray(X), np.asarray(Y)


@pytest.fixture(scope="module")
def mesh():
    return make_mesh(8)


def test_sharded_fit_matches_dense_cholesky(corpus, mesh):
    """CG alpha/posterior mean parity <= 1e-6 vs the dense fit, on a
    flight-CSV subset whose row count (300) does NOT divide the mesh —
    exercising the padding/mask path."""
    X, Y = corpus
    cfg = ResidualGPConfig()
    post_s = fit_residual_gp_sharded(X, Y, mesh=mesh, config=cfg,
                                     cg_iterations=150)
    assert float(post_s.cg_residual) < 1e-10

    post_d = fit_residual_gp(jnp.asarray(X), jnp.asarray(Y), cfg)
    Xq = jnp.asarray(X[::17])
    np.testing.assert_allclose(
        np.asarray(predict_mean_sharded(post_s, Xq, mesh=mesh)),
        np.asarray(predict_mean(post_d, Xq)),
        atol=1e-6,
    )


def test_sharded_variance_matches_dense(corpus, mesh):
    X, Y = corpus
    cfg = ResidualGPConfig()
    post_s = fit_residual_gp_sharded(X, Y, mesh=mesh, config=cfg,
                                     cg_iterations=150)
    Xq = jnp.asarray(X[::41])
    mean_s, var_s = predict_sharded(post_s, Xq, mesh=mesh, config=cfg,
                                    cg_iterations=150)
    mean_d, var_d = predict(fit_residual_gp(jnp.asarray(X), jnp.asarray(Y), cfg), Xq)
    np.testing.assert_allclose(np.asarray(mean_s), np.asarray(mean_d), atol=1e-6)
    np.testing.assert_allclose(np.asarray(var_s), np.asarray(var_d), atol=1e-6)


def test_host_view_feeds_the_control_loop(corpus, mesh):
    """to_gp_posterior() plugs into build_horizon_residuals unchanged."""
    from unmanned_aerial_vehicles_tpu.gp import build_horizon_residuals

    X, Y = corpus
    cfg = ResidualGPConfig()
    post_s = fit_residual_gp_sharded(X, Y, mesh=mesh, config=cfg,
                                     cg_iterations=150)
    view = post_s.to_gp_posterior()
    Xg = jnp.zeros((21, 6)).at[:, 2].set(3.0)
    Ug = jnp.zeros((20, 4))
    D = build_horizon_residuals(view, Xg, Ug, cfg)
    assert D.shape == (20, 6)
    assert np.isfinite(np.asarray(D)).all()


def test_nystrom_preconditioner_accelerates_cg(corpus, mesh):
    """At a fixed (small) iteration budget the Nystrom-preconditioned solve
    must reach a much smaller residual than plain CG."""
    X, Y = corpus
    cfg = ResidualGPConfig()
    iters = 12
    post_pre = fit_residual_gp_sharded(X, Y, mesh=mesh, config=cfg,
                                       cg_iterations=iters, precond_size=128)
    post_plain = fit_residual_gp_sharded(X, Y, mesh=mesh, config=cfg,
                                         cg_iterations=iters, precond_size=1)
    r_pre = float(post_pre.cg_residual)
    r_plain = float(post_plain.cg_residual)
    assert r_pre < r_plain / 10.0, (r_pre, r_plain)


def test_cg_solves_a_known_system(mesh):
    """_cg against a dense solve on a synthetic SPD system, sharded."""
    import functools

    from jax.sharding import NamedSharding, PartitionSpec as P

    rng = np.random.default_rng(0)
    n, out = 64, 3
    A_half = rng.normal(size=(n, n))
    A = A_half @ A_half.T + n * np.eye(n)
    b = rng.normal(size=(n, out))
    x_ref = np.linalg.solve(A, b)

    Aj = jnp.asarray(A)

    @functools.partial(
        jax.shard_map, mesh=mesh,
        in_specs=(P("batch"), P("batch")), out_specs=(P("batch"), P()),
    )
    def run(A_loc, b_loc):
        def matvec(v_loc):
            v_full = jax.lax.all_gather(v_loc, "batch", tiled=True)
            return jnp.matmul(A_loc, v_full,
                              precision=jax.lax.Precision.HIGHEST)
        return _cg(matvec, lambda r: r, b_loc, 200)

    x, res = jax.jit(run)(Aj, jnp.asarray(b))
    np.testing.assert_allclose(np.asarray(x), x_ref, atol=1e-8)
    assert float(res) < 1e-8


def test_lml_grad_exact_trace_matches_jax_grad(corpus, mesh):
    """With identity probes the sharded CG gradient equals jax.grad of the
    dense LML to near machine precision — validating the quadratic/trace
    decomposition and the (K o D2) matvec expansion."""
    from unmanned_aerial_vehicles_tpu.gp import GPParams, log_marginal_likelihood
    from unmanned_aerial_vehicles_tpu.parallel import lml_grad_sharded

    X, Y = corpus
    cfg = ResidualGPConfig()
    params = GPParams.create(0.7, 1.3, 0.15)
    g_ref = jax.grad(
        lambda p: log_marginal_likelihood(
            p, jnp.asarray(X), jnp.asarray(Y), jitter=cfg.alpha, normalize_y=True
        )
    )(params)
    g_sh = lml_grad_sharded(params, X, Y, mesh=mesh, config=cfg,
                            exact_trace=True, cg_iterations=300)
    for field in ("log_length_scale", "log_signal_variance",
                  "log_noise_variance"):
        np.testing.assert_allclose(
            float(getattr(g_sh, field)), float(getattr(g_ref, field)),
            rtol=1e-7, err_msg=field,
        )


def test_lml_grad_stochastic_points_uphill(corpus, mesh):
    """Rademacher-probe gradients are noisy but must correlate strongly
    with the exact gradient (the SGD ascent contract)."""
    from unmanned_aerial_vehicles_tpu.gp import GPParams, log_marginal_likelihood
    from unmanned_aerial_vehicles_tpu.parallel import lml_grad_sharded

    X, Y = corpus
    cfg = ResidualGPConfig()
    params = GPParams.create(0.7, 1.3, 0.15)
    g_ref = jax.grad(
        lambda p: log_marginal_likelihood(
            p, jnp.asarray(X), jnp.asarray(Y), jitter=cfg.alpha, normalize_y=True
        )
    )(params)
    g_st = lml_grad_sharded(params, X, Y, mesh=mesh, config=cfg,
                            num_probes=64, cg_iterations=300,
                            key=jax.random.PRNGKey(3))
    a = np.asarray([float(getattr(g_st, f)) for f in (
        "log_length_scale", "log_signal_variance", "log_noise_variance")])
    b = np.asarray([float(getattr(g_ref, f)) for f in (
        "log_length_scale", "log_signal_variance", "log_noise_variance")])
    cos = float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))
    assert cos > 0.98, f"stochastic gradient misaligned (cos {cos:.3f})"


def test_sharded_hyperopt_improves_lml(corpus, mesh):
    """A few adam steps of the sharded stochastic-LML ascent must improve
    the EXACT dense LML from a deliberately bad start."""
    from unmanned_aerial_vehicles_tpu.gp import GPParams, log_marginal_likelihood
    from unmanned_aerial_vehicles_tpu.parallel import (
        optimize_hyperparameters_sharded,
    )

    X, Y = corpus
    cfg = ResidualGPConfig()
    lml = lambda p: float(log_marginal_likelihood(
        p, jnp.asarray(X), jnp.asarray(Y), jitter=cfg.alpha, normalize_y=True
    ))
    start = GPParams.create(3.0, 0.2, 0.5)   # far from anything sensible
    p_opt = optimize_hyperparameters_sharded(
        start, X, Y, mesh=mesh, config=cfg, steps=15, learning_rate=0.1,
        num_probes=16, cg_iterations=200, key=jax.random.PRNGKey(0),
    )
    assert lml(p_opt) > lml(start) + 10.0, (lml(start), lml(p_opt))


def test_lml_grad_ard_matches_jax_grad(corpus, mesh):
    """Per-dimension (ARD) length-scale gradients — the per-dim/GPflow
    trainers' configuration at corpus scale — match jax.grad elementwise."""
    from unmanned_aerial_vehicles_tpu.gp import GPParams, log_marginal_likelihood
    from unmanned_aerial_vehicles_tpu.parallel import lml_grad_sharded

    X, Y = corpus
    cfg = ResidualGPConfig()
    params = GPParams.create(np.linspace(0.4, 1.5, X.shape[1]), 1.3, 0.15)
    g_ref = jax.grad(
        lambda p: log_marginal_likelihood(
            p, jnp.asarray(X), jnp.asarray(Y), jitter=cfg.alpha, normalize_y=True
        )
    )(params)
    g_sh = lml_grad_sharded(params, X, Y, mesh=mesh, config=cfg,
                            exact_trace=True, cg_iterations=300)
    assert np.asarray(g_sh.log_length_scale).shape == (X.shape[1],)
    np.testing.assert_allclose(
        np.asarray(g_sh.log_length_scale),
        np.asarray(g_ref.log_length_scale), rtol=1e-6,
    )


def test_sharded_fit_with_ard_params(corpus, mesh):
    """The sharded fit/predict accept ARD length-scale vectors and match
    the dense ARD fit."""
    from unmanned_aerial_vehicles_tpu.gp import GPParams

    X, Y = corpus
    cfg = ResidualGPConfig()
    params = GPParams.create(np.linspace(0.4, 1.5, X.shape[1]), 1.0, 0.1)
    post_s = fit_residual_gp_sharded(X, Y, mesh=mesh, config=cfg,
                                     params=params, cg_iterations=200)
    post_d = fit_residual_gp(jnp.asarray(X), jnp.asarray(Y), cfg, params=params)
    Xq = jnp.asarray(X[::31])
    np.testing.assert_allclose(
        np.asarray(predict_mean_sharded(post_s, Xq, mesh=mesh)),
        np.asarray(predict_mean(post_d, Xq)),
        atol=1e-6,
    )


def test_per_dim_sharded_matches_dense_per_dim(corpus, mesh):
    """The corpus-scale per-dimension pipeline matches gp.per_dim's dense
    vmapped fits (same ARD params, same scalers) to 1e-6."""
    from unmanned_aerial_vehicles_tpu.gp.per_dim import (
        default_per_dim_params,
        fit_per_dim_gp,
        predict_per_dim,
    )
    from unmanned_aerial_vehicles_tpu.parallel import (
        fit_per_dim_gp_sharded,
        predict_per_dim_sharded,
    )

    X, Y = corpus
    params = default_per_dim_params(X.shape[1], Y.shape[1])
    # distinct per-dim hyperparameters to make the test non-trivial
    params = params.replace(
        log_length_scale=params.log_length_scale
        + jnp.linspace(-0.3, 0.3, Y.shape[1])[:, None],
        log_noise_variance=params.log_noise_variance
        + jnp.linspace(0.0, 0.5, Y.shape[1]),
    )
    dense = fit_per_dim_gp(jnp.asarray(X), jnp.asarray(Y), params=params)
    shard = fit_per_dim_gp_sharded(X, Y, mesh=mesh, params=params,
                                   cg_iterations=250)
    Xq = jnp.asarray(X[::23])
    m_d, v_d = predict_per_dim(dense, Xq)
    m_s, v_s = predict_per_dim_sharded(shard, Xq, mesh=mesh,
                                       cg_iterations=250)
    np.testing.assert_allclose(np.asarray(m_s), np.asarray(m_d), atol=1e-6)
    np.testing.assert_allclose(np.asarray(v_s), np.asarray(v_d), atol=1e-6)
