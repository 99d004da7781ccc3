"""Plant parity tests: JAX dynamics vs independent NumPy transcription.

SURVEY.md section 7 stage 1 requires derivative and RK4-step parity to 1e-12
(f64) against the reference formulas.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from unmanned_aerial_vehicles_tpu.models import (
    GZ_QUADROTOR_PARAMS,
    RigidBodyParams,
    X500_PARAMS,
    double_integrator_step,
    rigid_body_derivative,
    rigid_body_rk4_step,
)
from unmanned_aerial_vehicles_tpu.models.double_integrator import (
    discrete_system_matrices,
)

from _numpy_reference import (
    np_nominal_double_integrator,
    np_rigid_body_derivative,
    np_rk4_step,
)


def random_states(rng, n):
    states = rng.normal(size=(n, 12))
    states[:, 6:9] *= 0.4  # keep angles away from the theta singularity
    controls = rng.normal(size=(n, 4)) * np.array([5.0, 0.05, 0.05, 0.05])
    controls[:, 0] += 5.0
    return states, controls


def test_rigid_body_derivative_parity(rng):
    states, controls = random_states(rng, 64)
    ours = jax.vmap(lambda s, c: rigid_body_derivative(s, c, GZ_QUADROTOR_PARAMS))(
        jnp.asarray(states), jnp.asarray(controls)
    )
    theirs = np.stack(
        [np_rigid_body_derivative(s, c) for s, c in zip(states, controls)]
    )
    np.testing.assert_allclose(np.asarray(ours), theirs, rtol=0, atol=1e-12)


def test_rigid_body_derivative_x500_params(rng):
    states, controls = random_states(rng, 16)
    ours = jax.vmap(lambda s, c: rigid_body_derivative(s, c, X500_PARAMS))(
        jnp.asarray(states), jnp.asarray(controls)
    )
    theirs = np.stack(
        [
            np_rigid_body_derivative(
                s,
                c,
                mass=2.0,
                Ixx=0.0217,
                Iyy=0.0217,
                Izz=0.04,
                k_drag_linear=0.0,
                k_drag_angular=0.0,
            )
            for s, c in zip(states, controls)
        ]
    )
    np.testing.assert_allclose(np.asarray(ours), theirs, rtol=0, atol=1e-12)


def test_rigid_body_residual_hook(rng):
    state = jnp.asarray(rng.normal(size=12) * 0.3)
    control = jnp.asarray([6.0, 0.01, -0.01, 0.0])
    residual = jnp.asarray(rng.normal(size=12) * 0.1)
    with_res = rigid_body_derivative(state, control, GZ_QUADROTOR_PARAMS, residual)
    without = rigid_body_derivative(state, control, GZ_QUADROTOR_PARAMS)
    np.testing.assert_allclose(
        np.asarray(with_res - without), np.asarray(residual), atol=1e-12
    )


def test_rk4_step_parity(rng):
    states, controls = random_states(rng, 32)
    dt = 0.01
    ours = jax.vmap(
        lambda s, c: rigid_body_rk4_step(s, c, GZ_QUADROTOR_PARAMS, dt)
    )(jnp.asarray(states), jnp.asarray(controls))
    theirs = np.stack([np_rk4_step(s, c, dt) for s, c in zip(states, controls)])
    np.testing.assert_allclose(np.asarray(ours), theirs, rtol=0, atol=1e-12)


def test_rk4_hover_equilibrium():
    """At hover (thrust = m g, level attitude) the plant must not drift."""
    p = GZ_QUADROTOR_PARAMS
    state = jnp.zeros(12).at[2].set(1.0)
    control = jnp.asarray([p.mass * p.gravity, 0.0, 0.0, 0.0])
    out = state
    for _ in range(100):
        out = rigid_body_rk4_step(out, control, p, 0.01)
    np.testing.assert_allclose(np.asarray(out), np.asarray(state), atol=1e-10)


def test_double_integrator_parity(rng):
    dt = 0.02
    for _ in range(16):
        s = rng.normal(size=6)
        c = rng.normal(size=4)
        ours = double_integrator_step(jnp.asarray(s), jnp.asarray(c), dt)
        theirs = np_nominal_double_integrator(s, c, dt)
        np.testing.assert_allclose(np.asarray(ours), theirs, atol=1e-15)


def test_discrete_matrices_match_step(rng):
    dt = 0.02
    A, B = discrete_system_matrices(dt, dtype=jnp.float64)
    s = jnp.asarray(rng.normal(size=6))
    c = jnp.asarray(rng.normal(size=4))
    np.testing.assert_allclose(
        np.asarray(A @ s + B @ c),
        np.asarray(double_integrator_step(s, c, dt)),
        atol=1e-15,
    )


def test_singularity_guard_no_nan():
    state = jnp.zeros(12).at[7].set(jnp.pi / 2)  # theta at the pole
    control = jnp.asarray([4.9, 0.0, 0.0, 0.0])
    d = rigid_body_derivative(state, control, GZ_QUADROTOR_PARAMS)
    assert bool(jnp.all(jnp.isfinite(d)))


def test_params_are_pytrees():
    leaves = jax.tree_util.tree_leaves(RigidBodyParams())
    assert len(leaves) == 10  # 7 physical params + 3 wind components


# ---------------------------------------------------------------------------
@pytest.mark.parametrize("substeps", [1, 2, 3])
def test_rk4_substeps_compose_rk4_steps(rng, substeps):
    """``rigid_body_rk4_substeps`` = ``substeps`` RK4 steps of dt/substeps
    under one held control and residual (the ZOH plant of the 12-state
    loops)."""
    from unmanned_aerial_vehicles_tpu.models import (
        GZ_QUADROTOR_PARAMS,
        rigid_body_rk4_step,
        rigid_body_rk4_substeps,
    )

    x = jnp.asarray(rng.normal(size=12) * 0.3).at[2].set(2.0)
    u = jnp.asarray([20.0, 0.01, -0.02, 0.005])
    res = jnp.asarray(rng.normal(size=12) * 0.05)
    dt = 0.1
    want = x
    for _ in range(substeps):
        want = rigid_body_rk4_step(want, u, GZ_QUADROTOR_PARAMS,
                                   dt / substeps, residual=res)
    got = rigid_body_rk4_substeps(x, u, GZ_QUADROTOR_PARAMS, dt,
                                  substeps=substeps, residual=res)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=1e-12)
