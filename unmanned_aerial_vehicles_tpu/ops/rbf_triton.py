"""Fused RBF posterior mean for Hopper, through Pallas on the Triton route.

``mean = sigma^2 exp(-0.5 ||(x* - x_i) / l||^2) @ alpha * y_std + y_mean``
for a batch of query rows. The plain XLA form (``gp.exact_gp.predict_mean``)
writes the ``(m, n_train)`` cross-kernel to device memory and reads it back
for the ``K_* @ alpha`` product. At the batch sweep's shape (1024 flights x
20 stages x 800 points) that matrix is 65.5 MB per tick. Here it never
leaves the chip: one program takes ``block_q`` query rows, walks the
training set in chunks of ``block_p`` points, and accumulates the
``(block_q, out)`` result with one ``dot`` per chunk.

The squared distance is summed directly over the d input dims in f32 (no
GEMM trick, so no cancellation), then exponentiated; the chunk's product
with alpha runs as an IEEE f32 dot (``DotAlgorithmPreset.F32_F32_F32``:
no TF32 anywhere). Query and training inputs are stored transposed so a
program loads one contiguous row per input dim.

Padding: query rows up to a multiple of ``block_q`` (sliced off), training
points up to a multiple of ``block_p`` with zero weights, input and output
dims to powers of two of at least 16 (Triton's block and dot shapes).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton


def _pow2(n: int, least: int) -> int:
    return max(least, 1 << (int(n) - 1).bit_length())


def _kernel(zq_ref, zt_ref, a_ref, out_ref, *, d, n_chunks, block_p):
    q = [zq_ref[j, :] for j in range(d)]                    # d x (block_q,)

    def chunk(c, acc):
        cols = pl.ds(c * block_p, block_p)
        d2 = None
        for j in range(d):
            diff = q[j][:, None] - zt_ref[j, cols][None, :]
            d2 = diff * diff if d2 is None else d2 + diff * diff
        k = jnp.exp(-0.5 * d2)                              # (block_q, block_p)
        return acc + jax.lax.dot(
            k, a_ref[cols, :], precision=jax.lax.DotAlgorithmPreset.F32_F32_F32,
            preferred_element_type=jnp.float32,
        )

    out_ref[...] = jax.lax.fori_loop(
        0, n_chunks, chunk, jnp.zeros(out_ref.shape, jnp.float32)
    )


@functools.partial(
    jax.jit,
    static_argnames=("block_q", "block_p", "num_warps", "interpret"),
)
def rbf_posterior_mean_triton(
    posterior,
    X_test: jnp.ndarray,
    *,
    block_q: int = 32,
    block_p: int = 64,
    num_warps: int = 4,
    interpret: bool = False,
) -> jnp.ndarray:
    """``gp.exact_gp.predict_mean`` as one Triton kernel, f32.

    ``posterior`` is a ``gp.exact_gp.GPPosterior`` (isotropic or ARD length
    scales, optional ``x_shift``); ``X_test (m, d)`` -> ``(m, out)``.
    ``interpret=True`` runs the kernel through the Pallas interpreter (CPU
    tests); the backend module decides when the compiled kernel runs.
    """
    dtype = jnp.float32
    p = posterior.params
    m, d = X_test.shape
    n, o = posterior.alpha.shape
    ls = jnp.broadcast_to(jnp.exp(p.log_length_scale).astype(dtype), (d,))
    X = X_test.astype(dtype)
    if posterior.x_shift is not None:
        X = X - posterior.x_shift.astype(dtype)
    d_pad, o_pad = _pow2(d, 16), _pow2(o, 16)
    m_pad = -(-m // block_q) * block_q
    n_pad = -(-n // block_p) * block_p
    zq = jnp.zeros((d_pad, m_pad), dtype).at[:d, :m].set((X / ls).T)
    zt = jnp.zeros((d_pad, n_pad), dtype).at[:d, :n].set(
        (posterior.X_train.astype(dtype) / ls).T
    )
    scale = jnp.exp(p.log_signal_variance).astype(dtype) * posterior.y_std.astype(dtype)
    a = jnp.zeros((n_pad, o_pad), dtype).at[:n, :o].set(
        posterior.alpha.astype(dtype) * scale
    )
    kernel = functools.partial(
        _kernel, d=d, n_chunks=n_pad // block_p, block_p=block_p
    )
    out = pl.pallas_call(
        kernel,
        out_shape=jax.ShapeDtypeStruct((m_pad, o_pad), dtype),
        grid=(m_pad // block_q,),
        in_specs=[
            pl.BlockSpec((d_pad, block_q), lambda i: (0, i)),
            pl.BlockSpec((d_pad, n_pad), lambda i: (0, 0)),
            pl.BlockSpec((n_pad, o_pad), lambda i: (0, 0)),
        ],
        out_specs=pl.BlockSpec((block_q, o_pad), lambda i: (i, 0)),
        compiler_params=pltriton.CompilerParams(num_warps=num_warps, num_stages=1),
        backend="triton",
        interpret=interpret,
        name="rbf_posterior_mean",
    )(zq, zt, a)
    return out[:m, :o] + posterior.y_mean.astype(dtype)
