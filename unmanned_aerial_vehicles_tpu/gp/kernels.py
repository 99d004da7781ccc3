"""RBF kernel computations (the GP hot kernel).

The squared-distance "GEMM trick" of the reference's from-scratch GP
(``/root/reference/quadrotor_gp_mpc/quadrotor_gp_mpc/gaussian_process.py:26-41``):
the dominant cost of a kernel matrix is one ``X1 @ X2.T`` matmul. We keep
that structure and add ARD support (per-dimension length scales, covering
the reference's sklearn/GPflow variants at ``src/px4/gp_trainer.py:139-146``
and ``src/px4/gp.py:120-135``). The batched posterior mean has its own
fused kernel (``ops.rbf_triton``, chosen by ``backend.gp_posterior_mean``).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

# The squared-distance trick cancels large ||x||^2 terms against the cross
# matmul. At a reduced matmul precision (TF32 on the GPU's tensor cores,
# ~3 decimal digits) that cancellation destroys the Gram matrix's
# positive-definiteness and the downstream Cholesky NaNs out, so the cross
# product runs at full f32.
_PRECISION = jax.lax.Precision.HIGHEST


def rbf_kernel(
    X1: jnp.ndarray,
    X2: jnp.ndarray,
    length_scale: jnp.ndarray,
    signal_variance: jnp.ndarray = 1.0,
) -> jnp.ndarray:
    """``sigma^2 exp(-0.5 ||(x1 - x2)/l||^2)`` for row batches.

    ``length_scale`` is a scalar (isotropic, reference default) or a
    ``(d,)`` vector (ARD). Matches ``gaussian_process.py:26-41`` for the
    scalar case and sklearn's ``RBF`` semantics for both.
    """
    ls = jnp.asarray(length_scale)
    Z1 = X1 / ls
    Z2 = X2 / ls
    sq1 = jnp.sum(Z1**2, axis=-1)[:, None]
    sq2 = jnp.sum(Z2**2, axis=-1)[None, :]
    cross = jnp.matmul(Z1, Z2.T, precision=_PRECISION)
    dists = jnp.maximum(sq1 + sq2 - 2.0 * cross, 0.0)
    return signal_variance * jnp.exp(-0.5 * dists)


def rbf_kernel_diag(X: jnp.ndarray, signal_variance: jnp.ndarray = 1.0) -> jnp.ndarray:
    """diag(k(X, X)) without forming the matrix."""
    return jnp.full(X.shape[:-1], signal_variance, dtype=X.dtype)
