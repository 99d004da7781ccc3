"""Test configuration.

Tests run on the CPU with a virtual 8-device mesh (the multi-device
sharding paths are validated without a second card) and with x64 enabled,
so parity checks against the reference's float64 NumPy/sklearn numerics can
hold to 1e-6 and tighter. The compile cache is the package's shared one
(``backend.setup_compile_cache``: ``$JAX_COMPILATION_CACHE_DIR`` when set).

Tests that need the card carry the ``gpu`` marker and take the
``gpu_devices`` fixture, which skips them here; ``chip_smoke.py`` runs the
same checks on the card.
"""

import os

# XLA flags are read at first backend initialisation, which has not happened
# yet even if jax is already imported.
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()
os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

from unmanned_aerial_vehicles_tpu.backend import setup_compile_cache  # noqa: E402

setup_compile_cache()

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture
def gpu_devices():
    """The GPU devices; skips the test when JAX has none (decided here, at
    run time, never at import or collection)."""
    devices = jax.devices()
    if devices[0].platform != "gpu":
        pytest.skip("needs a GPU (run on the card through chip_smoke.py)")
    return devices


@pytest.fixture(scope="session")
def flight_corpus():
    """Seeded synthetic flight data in the reference's gp_datasets schema
    (10 inputs -> 6 residuals), standing in for the reference CSVs."""
    from unmanned_aerial_vehicles_tpu.io import generate_excitation_data

    X, Y = generate_excitation_data(seed=0, num_steps=1200)
    return np.asarray(X, np.float64), np.asarray(Y, np.float64)


@pytest.fixture(scope="session")
def flight_csvs(tmp_path_factory, flight_corpus):
    """Two CSV files of the synthetic corpus in the gp_datasets layout."""
    from unmanned_aerial_vehicles_tpu.io import save_gp_dataset

    X, Y = flight_corpus
    d = tmp_path_factory.mktemp("gp_datasets")
    paths = []
    for i, sl in enumerate((slice(0, 600), slice(600, 1200))):
        p = str(d / f"gp_flight_data_{i}.csv")
        save_gp_dataset(p, X[sl], Y[sl])
        paths.append(p)
    return paths
