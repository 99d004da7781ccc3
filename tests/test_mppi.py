"""MPPI sampling-based MPC (control/mppi — no reference counterpart).

Pins closed-loop behaviour: hover regulation, circle tracking on the
rigid-body plant, control feasibility, and determinism given the carry key.
"""

import jax
import jax.numpy as jnp
import numpy as np

from unmanned_aerial_vehicles_tpu.control import MPPIConfig, MPPIController
from unmanned_aerial_vehicles_tpu.models import X500_PARAMS, rigid_body_rk4_step
from unmanned_aerial_vehicles_tpu.trajectories import ramped_circle_reference

CFG = MPPIConfig(horizon=15, num_samples=128)


def _fly(controller, ref_fn, steps, x0=None):
    dt = controller.config.dt
    if x0 is None:
        x0 = jnp.zeros(12, jnp.float32).at[2].set(3.0)

    def step(c, i):
        st, mc = c
        t = i.astype(jnp.float32) * dt
        pos_ref, yaw_ref = ref_fn(t)
        u, _, mc = controller.solve(mc, st, pos_ref, yaw_ref)
        st = rigid_body_rk4_step(st, u, X500_PARAMS, dt)
        return (st, mc), {"state": st, "pos_ref": pos_ref, "u": u}

    (_, _), outs = jax.lax.scan(
        step, (x0, controller.init_carry(x0)), jnp.arange(steps)
    )
    return outs


def test_mppi_hover_regulation():
    ctrl = MPPIController(CFG)
    ref = lambda t: (jnp.asarray([0.5, -0.5, 3.0], jnp.float32),
                     jnp.float32(0.0))
    outs = jax.jit(lambda: _fly(ctrl, ref, 250))()
    outs = {k: np.asarray(v) for k, v in outs.items()}
    err = np.linalg.norm(outs["state"][:, 0:3] - np.asarray([0.5, -0.5, 3.0]),
                         axis=1)
    assert np.isfinite(outs["state"]).all()
    assert err[-50:].mean() < 0.15, err[-50:].mean()


def test_mppi_tracks_circle():
    ctrl = MPPIController(CFG)

    def ref(t):
        pos, _, yaw = ramped_circle_reference(t, amplitude=2.0, height=3.0)
        return pos, yaw

    outs = jax.jit(lambda: _fly(ctrl, ref, 400))()
    outs = {k: np.asarray(v) for k, v in outs.items()}
    err = np.linalg.norm(outs["state"][:, 0:3] - outs["pos_ref"], axis=1)
    rms = float(np.sqrt((err[100:] ** 2).mean()))
    # the reference's early 12-state derivative-based run: 1.288 m RMS
    assert rms < 1.0, rms


def test_mppi_controls_feasible_and_deterministic():
    ctrl = MPPIController(CFG)
    ref = lambda t: (jnp.asarray([0.0, 0.0, 3.0], jnp.float32),
                     jnp.float32(0.0))
    outs1 = jax.jit(lambda: _fly(ctrl, ref, 50))()
    outs2 = jax.jit(lambda: _fly(ctrl, ref, 50))()
    outs1 = {k: np.asarray(v) for k, v in outs1.items()}
    outs2 = {k: np.asarray(v) for k, v in outs2.items()}
    u = outs1["u"]
    lo, hi = np.asarray(ctrl.u_lo), np.asarray(ctrl.u_hi)
    assert (u >= lo - 1e-5).all() and (u <= hi + 1e-5).all()
    # PRNG lives in the carry: same key -> identical flight
    np.testing.assert_array_equal(outs1["state"], outs2["state"])


def test_mppi_preview_beats_point_target():
    """Per-stage horizon references (the preview analogue) must beat the
    point-target formulation on a moving reference."""
    ctrl = MPPIController(CFG)
    dt = ctrl.config.dt
    N = ctrl.config.horizon

    def ref(t):
        pos, _, yaw = ramped_circle_reference(t, amplitude=2.0, height=3.0)
        return pos, yaw

    def fly(preview, steps=400):
        x0 = jnp.zeros(12, jnp.float32).at[2].set(3.0)

        def step(c, i):
            st, mc = c
            t = i.astype(jnp.float32) * dt
            pos_ref, yaw_ref = ref(t)
            if preview:
                ts = t + dt * jnp.arange(1, N + 1, dtype=jnp.float32)
                refs, _ = jax.vmap(ref)(ts)
            else:
                refs = None
            u, _, mc = ctrl.solve(mc, st, pos_ref, yaw_ref,
                                  reference_positions=refs)
            st = rigid_body_rk4_step(st, u, X500_PARAMS, dt)
            return (st, mc), {"state": st, "pos_ref": pos_ref}

        _, outs = jax.lax.scan(step, (x0, ctrl.init_carry(x0)),
                               jnp.arange(steps))
        return outs

    def rms(outs):
        err = np.linalg.norm(
            np.asarray(outs["state"][:, 0:3]) - np.asarray(outs["pos_ref"]),
            axis=1,
        )
        return float(np.sqrt((err[100:] ** 2).mean()))

    r_point = rms(jax.jit(lambda: fly(False))())
    r_prev = rms(jax.jit(lambda: fly(True))())
    assert r_prev < r_point, (r_prev, r_point)


def test_mppi_nominal_trajectory_flag():
    x0 = jnp.zeros(12, jnp.float32).at[2].set(3.0)
    tgt = jnp.asarray([0.0, 0.0, 3.0], jnp.float32)
    fast = MPPIController(CFG)
    u, X, _ = jax.jit(lambda: fast.solve(fast.init_carry(x0), x0, tgt))()
    assert X is None  # no wasted sequential rollout by default
    diag = MPPIController(CFG.replace(return_trajectory=True))
    u2, X2, _ = jax.jit(lambda: diag.solve(diag.init_carry(x0), x0, tgt))()
    assert X2.shape == (CFG.horizon + 1, 12)
    np.testing.assert_array_equal(np.asarray(u), np.asarray(u2))
