"""The backend module: per-platform choice of the posterior-mean path,
explicit interpret mode, the GPU guard and the compile-cache directory."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from unmanned_aerial_vehicles_tpu import backend
from unmanned_aerial_vehicles_tpu.gp.exact_gp import predict_mean
from unmanned_aerial_vehicles_tpu.gp.residual_gp import fit_residual_gp


@pytest.fixture
def posterior(rng):
    return fit_residual_gp(
        jnp.asarray(rng.normal(size=(60, 10)), jnp.float32),
        jnp.asarray(0.1 * rng.normal(size=(60, 6)), jnp.float32),
    )


def test_require_gpu_raises_on_cpu():
    with pytest.raises(RuntimeError, match="no GPU"):
        backend.require_gpu()


def test_cpu_runs_the_plain_path(posterior, rng):
    """On the CPU the posterior mean IS ``predict_mean`` (bit for bit) and
    its lowering holds no Triton call."""
    Xq = jnp.asarray(rng.normal(size=(17, 10)), jnp.float32)
    got = jax.jit(backend.gp_posterior_mean)(posterior, Xq)
    np.testing.assert_array_equal(np.asarray(got),
                                  np.asarray(jax.jit(predict_mean)(posterior, Xq)))
    text = jax.jit(backend.gp_posterior_mean).lower(posterior, Xq).as_text()
    assert "triton" not in text.lower()


def test_cuda_lowering_selects_the_kernel(posterior, rng):
    """Lowered for CUDA, the same call becomes the Triton kernel."""
    Xq = jnp.asarray(rng.normal(size=(17, 10)), jnp.float32)
    text = jax.jit(backend.gp_posterior_mean).trace(posterior, Xq).lower(
        lowering_platforms=("cuda",)
    ).as_text()
    assert "rbf_posterior_mean" in text


def test_interpret_only_when_asked(posterior, rng):
    """``interpret=True`` runs the kernel in the Pallas interpreter (so the
    result is the kernel's, not ``predict_mean``'s, and agrees with it)."""
    Xq = jnp.asarray(rng.normal(size=(17, 10)), jnp.float32)
    got = backend.gp_posterior_mean(posterior, Xq, interpret=True)
    ref = predict_mean(posterior, Xq)
    assert got.dtype == ref.dtype
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref),
                               rtol=1e-5, atol=1e-6)


def test_cache_dir_honours_environment(monkeypatch, tmp_path):
    monkeypatch.setenv(backend.CACHE_ENV, str(tmp_path / "cache"))
    assert backend.compile_cache_dir() == str(tmp_path / "cache")
    monkeypatch.delenv(backend.CACHE_ENV)
    assert backend.compile_cache_dir() == os.path.join(
        backend.REPO_ROOT, ".jax_cache"
    )


def test_setup_compile_cache_sets_jax_config(monkeypatch, tmp_path):
    before = jax.config.jax_compilation_cache_dir
    try:
        monkeypatch.setenv(backend.CACHE_ENV, str(tmp_path))
        assert backend.setup_compile_cache() == str(tmp_path)
        assert jax.config.jax_compilation_cache_dir == str(tmp_path)
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_no_platform_test_outside_backend():
    """Every ``default_backend()`` decision lives in backend.py."""
    pkg = os.path.dirname(backend.__file__)
    offenders = []
    for root, _, files in os.walk(pkg):
        for f in files:
            path = os.path.join(root, f)
            if f.endswith(".py") and path != backend.__file__:
                with open(path) as fh:
                    if "default_backend()" in fh.read():
                        offenders.append(path)
    assert offenders == []


def test_chip_smoke_fails_without_gpu():
    """chip_smoke.py exits non-zero and prints no result line on the CPU."""
    script = os.path.join(backend.REPO_ROOT, "chip_smoke.py")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, script], capture_output=True,
                          text=True, env=env, timeout=300)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


def test_chip_smoke_fails_alone(tmp_path):
    """Copied away from the package, chip_smoke.py fails instead of
    running anything."""
    src = os.path.join(backend.REPO_ROOT, "chip_smoke.py")
    dst = tmp_path / "chip_smoke.py"
    dst.write_text(open(src).read())
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["JAX_PLATFORMS"] = "cpu"
    proc = subprocess.run([sys.executable, str(dst)], capture_output=True,
                          text=True, env=env, cwd=tmp_path, timeout=300)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
