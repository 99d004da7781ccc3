"""Synthetic dynamics data generation + least-squares system ID.

Rebuild of the reference's system-identification utilities
(``/root/reference/src/px4/synthetic_dynamics_generator.py`` — fabricates
training transitions when comms fail — and ``dynamics_analyzer.py`` /
``analyze_simple_dynamics.py`` — fit simple linear models to recorded
transitions; SURVEY.md section 2 row 26).

Excitation rollouts are jitted scans over the true plant; the
residual-vs-double-integrator extraction is the exact inverse of the GP's
nominal model so the generated CSVs are drop-in training data for the
residual GP; system ID is one batched least-squares solve instead of the
reference's per-channel loops.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..models.params import RigidBodyParams
from ..models.px4_surrogate import RateLoopParams, px4_rate_tracking_step
from ..models.double_integrator import double_integrator_step


def generate_excitation_data(
    seed: int = 0,
    num_steps: int = 2000,
    dt: float = 0.02,
    body: RigidBodyParams = RigidBodyParams(),
    rate_loop: RateLoopParams = RateLoopParams(),
    smoothing: float = 0.95,
):
    """Fly the surrogate plant under smooth random accel-style commands and
    emit (X (n,10), Y (n,6)) residual training pairs in the gp_datasets
    schema. The "controls" recorded are the acceleration commands the
    GP-MPC uses, reconstructed from the commanded thrust/attitude."""
    dtype = jnp.result_type(float)
    key = jax.random.PRNGKey(seed)
    noise = jax.random.normal(key, (num_steps, 4), dtype) * jnp.asarray(
        [0.8, 0.8, 0.6, 0.2], dtype
    )

    def smooth(carry, n):
        c = smoothing * carry + (1.0 - smoothing) * n
        return c, c

    _, accel_cmd = jax.lax.scan(smooth, jnp.zeros(4, dtype), noise)

    from ..control.allocation import attitude_loop_init, geometric_control_allocation

    def step(carry, u):
        state, att = carry
        thrust, rates, _, att = geometric_control_allocation(
            att, u[0:3], jnp.zeros(()), u[3], state[6:9], state[9:12], dt_attitude=dt
        )
        control = jnp.concatenate([thrust[None], rates])
        new_state = state
        for _ in range(2):
            new_state = px4_rate_tracking_step(new_state, control, body, rate_loop, dt / 2)
        return (new_state, att), (state, new_state)

    x0 = jnp.zeros(12, dtype).at[2].set(3.0)
    _, (states, next_states) = jax.lax.scan(
        step, (x0, attitude_loop_init(dtype)), accel_cmd
    )

    X = jnp.concatenate([states[:, 0:6], accel_cmd], axis=1)
    nominal_next = jax.vmap(lambda s, u: double_integrator_step(s, u, dt))(
        states[:, 0:6], accel_cmd
    )
    Y = next_states[:, 0:6] - nominal_next
    return np.asarray(X), np.asarray(Y)


#: rows of the reference's flight-data corpus (SURVEY section 6)
CORPUS_ROWS = 19_816


def synthetic_corpus(
    num_rows: int = CORPUS_ROWS,
    seed: int = 0,
    max_samples: int | None = None,
):
    """A seeded stand-in for the reference's ``gp_datasets`` corpus: one
    excitation flight of ``num_rows`` ticks in the same 10 -> 6 schema,
    down-sampled evenly to ``max_samples`` like ``io.load_gp_datasets``."""
    X, Y = generate_excitation_data(seed=seed, num_steps=num_rows)
    if max_samples is not None and X.shape[0] > max_samples:
        idx = np.linspace(0, X.shape[0] - 1, max_samples).astype(int)
        X, Y = X[idx], Y[idx]
    return X, Y


def identify_linear_dynamics(states, controls, next_states):
    """Least-squares fit of ``x+ = A x + B u`` from transition data
    (``dynamics_analyzer.py`` equivalent). Returns (A, B, residual RMS)."""
    states = np.asarray(states)
    controls = np.asarray(controls)
    next_states = np.asarray(next_states)
    Z = np.hstack([states, controls])                     # (n, nx+nu)
    theta, *_ = np.linalg.lstsq(Z, next_states, rcond=None)
    nx = states.shape[1]
    A, B = theta[:nx].T, theta[nx:].T
    resid = next_states - Z @ theta
    return A, B, float(np.sqrt(np.mean(resid**2)))
