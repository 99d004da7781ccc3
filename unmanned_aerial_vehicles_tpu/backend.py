"""Which backend runs which path, and where compiled programs are cached.

Every platform decision of the package is made here:

* ``gp_posterior_mean`` runs the Triton posterior-mean kernel
  (``ops.rbf_triton``) when the computation is lowered for a CUDA device
  and the plain XLA ``predict_mean`` everywhere else. The CPU runs the
  plain path because the kernel is not built for it. The choice is made
  per lowering (``lax.platform_dependent``), so a function pinned to the
  host CPU inside a GPU process takes the XLA path too.
* Interpret mode runs only when a caller (a test) passes
  ``interpret=True``; nothing chooses it on its own.
* ``require_gpu`` is the guard of every measurement entry point: it raises
  when JAX finds no GPU, so no timing is ever taken on the CPU by accident.
* ``setup_compile_cache`` points JAX's persistent compile cache at
  ``$JAX_COMPILATION_CACHE_DIR`` when that is set, and otherwise at
  ``.jax_cache/`` in the checkout.
"""

from __future__ import annotations

import os

import jax

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE_ENV = "JAX_COMPILATION_CACHE_DIR"


def compile_cache_dir() -> str:
    """The cache directory: the environment's, or ``<checkout>/.jax_cache``."""
    return os.environ.get(CACHE_ENV) or os.path.join(REPO_ROOT, ".jax_cache")


def setup_compile_cache(min_compile_secs: float = 0.5) -> str:
    """Enable the persistent compile cache; returns its directory."""
    path = compile_cache_dir()
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", min_compile_secs)
    return path


def require_gpu():
    """Return the GPU devices, or raise when JAX has none."""
    devices = jax.devices()
    if devices[0].platform != "gpu":
        raise RuntimeError(
            f"no GPU: JAX runs on {devices[0].platform!r} "
            f"({len(devices)} device(s)); this entry point measures the card"
        )
    return devices


def gp_posterior_mean(posterior, X_test, interpret: bool = False):
    """GP posterior mean at ``X_test (m, d)`` -> ``(m, out)``: the Triton
    kernel on CUDA, ``gp.exact_gp.predict_mean`` elsewhere (or the kernel
    in the Pallas interpreter when ``interpret=True``)."""
    from .gp.exact_gp import predict_mean
    from .ops.rbf_triton import rbf_posterior_mean_triton

    # the kernel computes in f32; both branches return predict_mean's dtype
    dtype = jax.eval_shape(predict_mean, posterior, X_test).dtype
    kernel = lambda p, x: rbf_posterior_mean_triton(
        p, x, interpret=interpret
    ).astype(dtype)
    if interpret:
        return kernel(posterior, X_test)
    return jax.lax.platform_dependent(
        posterior, X_test, cuda=kernel, default=predict_mean
    )
