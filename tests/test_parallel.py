"""Mesh-sharded sweep tests on the virtual 8-device CPU mesh."""

import jax
import jax.numpy as jnp
import numpy as np

from unmanned_aerial_vehicles_tpu.control.mpc_linear import LinearMPC, LinearMPCConfig
from unmanned_aerial_vehicles_tpu.gp import GPParams
from unmanned_aerial_vehicles_tpu.loop import FlightLoopConfig, mpc_flight_rollout
from unmanned_aerial_vehicles_tpu.parallel import (
    batch_sharding,
    hyperparameter_search_step,
    make_mesh,
    shard_batch,
    sharded_flight_sweep,
)
from unmanned_aerial_vehicles_tpu.trajectories import ramped_figure8_reference


def test_mesh_has_eight_devices():
    mesh = make_mesh()
    assert mesh.devices.size == 8  # conftest forces 8 virtual CPU devices


def test_shard_batch_places_across_devices():
    mesh = make_mesh()
    arr = jnp.arange(16 * 3, dtype=jnp.float32).reshape(16, 3)
    sharded = shard_batch(arr, mesh)
    assert sharded.sharding == batch_sharding(mesh)
    assert len(sharded.sharding.device_set) == 8
    np.testing.assert_array_equal(np.asarray(sharded), np.asarray(arr))


def test_hyperparameter_search_step_finds_best(rng):
    mesh = make_mesh()
    # ground truth: data generated from a known length scale
    X = jnp.asarray(rng.normal(size=(64, 4)), jnp.float32)
    true_params = GPParams.create(0.8, 1.0, 0.01)
    from unmanned_aerial_vehicles_tpu.gp.kernels import rbf_kernel

    K = rbf_kernel(X, X, 0.8, 1.0) + 0.01 * jnp.eye(64)
    L = jnp.linalg.cholesky(K)
    Y = (L @ jnp.asarray(rng.normal(size=(64, 2)), jnp.float32))

    ls_grid = jnp.asarray([0.05, 0.2, 0.8, 3.0, 10.0, 30.0, 100.0, 300.0])
    candidates = jax.vmap(lambda l: GPParams.create(l, 1.0, 0.01))(ls_grid)
    sweep = hyperparameter_search_step(
        mesh, candidates, X[:48], Y[:48], X[48:], Y[48:]
    )
    # the true length scale (or a neighbour) must win on validation MSE
    assert float(ls_grid[int(sweep.best_index)]) in (0.2, 0.8, 3.0)
    assert np.isfinite(np.asarray(sweep.val_mse)).all()
    assert np.isfinite(np.asarray(sweep.lml)).all()


def test_sharded_flight_sweep_matches_single_flights():
    mesh = make_mesh()
    cfg = FlightLoopConfig()
    mpc = LinearMPC(LinearMPCConfig(horizon=5, admm_iterations=15))

    def ref(t):
        pos, yaw = ramped_figure8_reference(t, amplitude=2.0, frequency=0.05)
        return pos + jnp.array([0.0, 0.0, cfg.takeoff_height]), yaw

    def one_flight(x0):
        return mpc_flight_rollout(mpc, ref, num_steps=20, cfg=cfg, initial_state=x0)

    B = 16
    starts = jnp.zeros((B, 12), jnp.float32).at[:, 2].set(
        jnp.float32(cfg.takeoff_height)
    )
    starts = starts.at[:, 0].set(jnp.linspace(-0.5, 0.5, B, dtype=jnp.float32))
    result = sharded_flight_sweep(mesh, one_flight, starts)

    assert result["rms_per_flight"].shape == (B,)
    # cross-check two flights against unsharded single runs
    for i in (0, B - 1):
        outs = jax.jit(one_flight)(starts[i])
        err = outs["pos_ref"] - outs["state"][:, 0:3]
        rms = float(jnp.sqrt(jnp.mean(jnp.sum(err**2, axis=-1))))
        np.testing.assert_allclose(float(result["rms_per_flight"][i]), rms, rtol=1e-5)
    np.testing.assert_allclose(
        float(result["rms_mean"]), float(jnp.mean(result["rms_per_flight"])), rtol=1e-6
    )


def test_sharded_structured_sweep_matches_vmapped():
    """The batched throughput sweep under shard_map agrees with the plain
    vmapped rollout across the mesh."""
    import jax.numpy as jnp

    from unmanned_aerial_vehicles_tpu.control.mpc_linear import (
        LinearMPC,
        LinearMPCConfig,
    )
    from unmanned_aerial_vehicles_tpu.loop import FlightLoopConfig, mpc_flight_rollout
    from unmanned_aerial_vehicles_tpu.parallel import (
        sharded_flight_sweep,
        sharded_structured_flight_sweep,
    )
    from unmanned_aerial_vehicles_tpu.trajectories import ramped_figure8_reference

    def ref(t):
        pos, yaw = ramped_figure8_reference(t, amplitude=2.0, frequency=0.1)
        return pos + jnp.array([0.0, 0.0, 3.0]), yaw

    kw = dict(horizon=10, admm_iterations=40)
    mpc = LinearMPC(LinearMPCConfig(**kw))
    B, T = 16, 25
    starts = jnp.zeros((B, 12), jnp.float32).at[:, 2].set(3.0)
    starts = starts.at[:, 0].set(jnp.linspace(-0.5, 0.5, B, dtype=jnp.float32))

    mesh = make_mesh()
    out_k = sharded_structured_flight_sweep(
        mesh, mpc, ref, T, starts, cfg=FlightLoopConfig()
    )
    out_v = sharded_flight_sweep(
        mesh,
        lambda x0: mpc_flight_rollout(mpc, ref, T, cfg=FlightLoopConfig(),
                                      initial_state=x0),
        starts,
    )
    np.testing.assert_allclose(
        np.asarray(out_k["rms_per_flight"]),
        np.asarray(out_v["rms_per_flight"]), atol=5e-4,
    )
    assert abs(float(out_k["rms_mean"]) - float(out_v["rms_mean"])) < 5e-4
