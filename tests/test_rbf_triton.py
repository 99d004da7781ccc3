"""The Triton posterior-mean kernel (``ops.rbf_triton``) against the plain
``predict_mean``: in the Pallas interpreter here, compiled on the card
under the ``gpu`` marker."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from unmanned_aerial_vehicles_tpu.gp.exact_gp import GPParams, fit_gp, predict_mean
from unmanned_aerial_vehicles_tpu.gp.residual_gp import (
    ResidualDataset,
    ResidualGPConfig,
    fit_residual_gp,
    fit_residual_gp_masked,
    masked_input_stats,
    standardized_params,
)
from unmanned_aerial_vehicles_tpu.ops.rbf_triton import rbf_posterior_mean_triton


def _posterior(rng, n, d=10, o=6, ard=False):
    X = jnp.asarray(rng.normal(size=(n, d)), jnp.float32)
    Y = jnp.asarray(0.1 * rng.normal(size=(n, o)), jnp.float32)
    ls = jnp.asarray(rng.uniform(0.4, 2.0, size=d)) if ard else 0.5
    params = GPParams.create(length_scale=ls, signal_variance=1.3,
                             noise_variance=0.1)
    return fit_gp(params, X, Y, jitter=1e-4, normalize_y=True)


# shapes chosen to hit: fewer query rows than one block, rows and training
# points that are not block multiples, several training chunks, exact
# multiples, and a non-default block size
@pytest.mark.parametrize(
    "m,n,block_q,block_p",
    [(5, 7, 32, 64), (100, 300, 32, 64), (128, 256, 64, 128),
     (77, 150, 16, 32), (200, 800, 32, 64)],
)
def test_kernel_matches_predict_mean(rng, m, n, block_q, block_p):
    post = _posterior(rng, n)
    Xq = jnp.asarray(rng.normal(size=(m, 10)), jnp.float32)
    got = rbf_posterior_mean_triton(post, Xq, block_q=block_q,
                                    block_p=block_p, interpret=True)
    ref = predict_mean(post, Xq)
    assert got.shape == (m, 6)
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("d,o", [(3, 1), (10, 6), (17, 9)])
def test_kernel_input_output_widths(rng, d, o):
    """Input and output dims pad to 16 (32 past that)."""
    post = _posterior(rng, 40, d=d, o=o)
    Xq = jnp.asarray(rng.normal(size=(9, d)), jnp.float32)
    got = rbf_posterior_mean_triton(post, Xq, interpret=True)
    np.testing.assert_allclose(np.asarray(got), np.asarray(predict_mean(post, Xq)),
                               rtol=1e-5, atol=1e-6)


def test_kernel_ard_length_scales(rng):
    post = _posterior(rng, 120, ard=True)
    assert np.asarray(post.params.length_scale).shape == (10,)
    Xq = jnp.asarray(rng.normal(size=(33, 10)), jnp.float32)
    got = rbf_posterior_mean_triton(post, Xq, interpret=True)
    np.testing.assert_allclose(np.asarray(got), np.asarray(predict_mean(post, Xq)),
                               rtol=1e-5, atol=1e-6)


def test_kernel_x_shift_and_masked_ring(rng):
    """A centered (``x_shift``), standardized-ARD fit of a half-full ring
    buffer: the masked rows carry the 1e6 sentinel and zero weight."""
    scales = np.r_[6.0, 6.0, 3.0, 1.5, 1.5, 0.8, 1.0, 0.5, 0.5, 0.3]
    X = np.asarray(rng.normal(size=(64, 10)) * scales + 3.0, np.float32)
    Y = np.asarray(0.05 * rng.normal(size=(64, 6)), np.float32)
    ds = ResidualDataset(
        X=jnp.asarray(X), Y=jnp.asarray(Y),
        head=jnp.asarray(40, jnp.int32), count=jnp.asarray(40, jnp.int32),
    )
    cfg = ResidualGPConfig()
    post = fit_residual_gp_masked(
        ds, cfg, params=standardized_params(ds, cfg),
        x_shift=masked_input_stats(ds)[0],
    )
    Xq = jnp.asarray(X[::3] + 0.1, jnp.float32)
    got = rbf_posterior_mean_triton(post, Xq, interpret=True)
    np.testing.assert_allclose(np.asarray(got), np.asarray(predict_mean(post, Xq)),
                               rtol=1e-5, atol=1e-6)


def test_kernel_far_queries_revert_to_prior_mean(rng):
    post = _posterior(rng, 50)
    far = jnp.full((3, 10), 1e3, jnp.float32)
    got = rbf_posterior_mean_triton(post, far, interpret=True)
    np.testing.assert_allclose(
        np.asarray(got), np.broadcast_to(np.asarray(post.y_mean), (3, 6)),
        atol=1e-6,
    )


def test_kernel_lowers_for_cuda(rng):
    """The kernel lowers to a Triton module for CUDA (no card needed to
    lower; the card's compiler is exercised by chip_smoke.py)."""
    post = fit_residual_gp(
        jnp.asarray(rng.normal(size=(800, 10)), jnp.float32),
        jnp.asarray(0.1 * rng.normal(size=(800, 6)), jnp.float32),
    )
    Xq = jax.ShapeDtypeStruct((20480, 10), jnp.float32)
    lowered = jax.jit(rbf_posterior_mean_triton).trace(post, Xq).lower(
        lowering_platforms=("cuda",)
    )
    assert "rbf_posterior_mean" in lowered.as_text()


@pytest.mark.gpu
def test_kernel_on_card_matches_xla(rng, gpu_devices):
    post = fit_residual_gp(
        jnp.asarray(rng.normal(size=(800, 10)), jnp.float32),
        jnp.asarray(0.1 * rng.normal(size=(800, 6)), jnp.float32),
    )
    Xq = jnp.asarray(rng.normal(size=(20480, 10)), jnp.float32)
    got = jax.jit(rbf_posterior_mean_triton)(post, Xq)
    ref = jax.jit(predict_mean)(post, Xq)
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref),
                               rtol=1e-4, atol=1e-5)
