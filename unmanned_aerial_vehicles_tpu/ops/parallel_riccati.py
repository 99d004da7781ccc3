"""Parallel-in-horizon LQR: Riccati via ``jax.lax.associative_scan``.

``ops.riccati.lqr_tracking_solve`` is one backward + one forward
``lax.scan`` — O(N) sequential depth, which leaves the accelerator idle
between tiny dependent steps once horizons grow (long-horizon planning,
N in the hundreds). This module computes the SAME solution with O(log N)
depth by temporal parallelization (Sarkka & Garcia-Fernandez,
"Temporal Parallelization of Dynamic Programming and Linear Quadratic
Trackers"; see also the parallel Riccati factorisation of Nielsen &
Axehill, arXiv:1407.6898, and pi-MPC, arXiv:2601.14414 — PAPERS.md):

* backward pass: value functions compose as matrix fractional
  transformations; a stage is the 5-tuple ``(A, b, C, eta, J)`` and the
  composition rule below is associative, so ALL suffix value functions
  come from one ``associative_scan(reverse=True)``;
* forward pass: the closed-loop rollout ``x+ = (A - B K) x + v`` is a
  composition of affine maps ``(M, v)`` — another associative scan.

Semantics and signature match ``lqr_tracking_solve`` exactly (same costs,
same references, same feedback/feedforward outputs); parity is asserted to
1e-8 in ``tests/test_riccati.py``.

WHEN TO USE (nx=12/nu=4): at this state dimension each sequential Riccati
step is a handful of (12,12) ops, so cheap that the associative combine's 5-tuple
of (nx,nx) matmuls (~4x the per-element work) outweighs the O(log N)
depth saving at the horizons the MPCs here use (not measured on the GPU;
N=15..240 is the range to time). The crossover needs larger nx (combine cost
grows like the step cost) or horizons beyond any MPC here — which is why
``ilqr_solve(parallel=False)`` stays the default and the latency fix for
iLQR is the policy-reuse multitick loop (``loop.rigid_loop``), not this
solver.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .riccati import LQRSolution

_PREC = jax.lax.Precision.HIGHEST


def _mm(a, b):
    return jnp.matmul(a, b, precision=_PREC)


def _combine(e_i, e_j):
    """Compose conditional value elements: ``e_i`` spans the EARLIER
    interval. Each element is ``(A, b, C, eta, J)`` representing the
    interval's dynamics compression (A, b), accumulated control Gramian C,
    and cost-to-go quadratic/linear terms (J, eta)."""
    A_i, b_i, C_i, eta_i, J_i = e_i
    A_j, b_j, C_j, eta_j, J_j = e_j
    nx = A_i.shape[-1]
    I = jnp.eye(nx, dtype=A_i.dtype)

    # batched (leading dims from associative_scan) linear solves
    def solve(M, rhs):
        return jnp.linalg.solve(M, rhs)

    ICJ = I + _mm(C_i, J_j)
    A_ji = solve(ICJ, A_i)                 # (I + C_i J_j)^-1 A_i
    A = _mm(A_j, A_ji)
    b = _mm(A_j, solve(ICJ, b_i[..., None] + _mm(C_i, eta_j[..., None])))[
        ..., 0
    ] + b_j
    C = _mm(A_j, _mm(solve(ICJ, C_i), jnp.swapaxes(A_j, -1, -2))) + C_j

    IJC = I + _mm(J_j, C_i)
    eta = _mm(
        jnp.swapaxes(A_i, -1, -2),
        solve(IJC, eta_j[..., None] - _mm(J_j, b_i[..., None])),
    )[..., 0] + eta_i
    J = _mm(
        jnp.swapaxes(A_i, -1, -2), _mm(solve(IJC, J_j), A_i)
    ) + J_i
    return (A, b, C, eta, J)


def lqr_tracking_solve_parallel(
    A: jnp.ndarray,        # (N, nx, nx)
    B: jnp.ndarray,        # (N, nx, nu)
    c: jnp.ndarray,        # (N, nx)
    q_diag: jnp.ndarray,   # (N+1, nx) stage + terminal state cost diagonals
    r_diag: jnp.ndarray,   # (nu,)
    x_ref: jnp.ndarray,    # (N+1, nx)
    u_ref: jnp.ndarray,    # (N, nu)
    x0: jnp.ndarray,       # (nx,)
) -> LQRSolution:
    """Drop-in parallel replacement for ``lqr_tracking_solve``."""
    N, nx, nu = B.shape
    dtype = B.dtype
    R = jnp.diag(r_diag)
    Rinv = jnp.diag(1.0 / r_diag)

    # --- stage elements (u-ref absorbed: u = utilde + uref) ---------------
    # stage k in 0..N-1:  A=F_k, b=c_k + B uref_k, C = 1/2 B R^-1 B',
    #                     J = 2 Q_k, eta = 2 Q_k xref_k
    # terminal:           A=0, b=0, C=0, J = 2 Q_N, eta = 2 Q_N xref_N
    # (the 2x scaling maps our |.|^2_Q costs onto the 1/2|.|^2_X form the
    # composition rule is derived in; the suffix value V_k(x) is then
    # x' (J/2) x - eta' x + const, i.e. P_k = J_k / 2.)
    b_stage = c + jnp.einsum("kij,kj->ki", B, u_ref)
    C_stage = 0.5 * jnp.einsum("kij,jl,kml->kim", B, Rinv, B)
    J_stage = jax.vmap(jnp.diag)(2.0 * q_diag[:N])
    eta_stage = 2.0 * q_diag[:N] * x_ref[:N]

    elems = (
        jnp.concatenate([A, jnp.zeros((1, nx, nx), dtype)]),
        jnp.concatenate([b_stage, jnp.zeros((1, nx), dtype)]),
        jnp.concatenate([C_stage, jnp.zeros((1, nx, nx), dtype)]),
        jnp.concatenate([eta_stage, (2.0 * q_diag[N] * x_ref[N])[None]]),
        jnp.concatenate([J_stage, jnp.diag(2.0 * q_diag[N])[None]]),
    )

    # suffix value functions: S_k = e_k (x) e_{k+1} (x) ... (x) e_N.
    # reverse=True feeds the combine fn operands in reversed order (it
    # flips, scans, flips back), so swap them to keep e_earlier first.
    suffix = jax.lax.associative_scan(
        lambda a, b: _combine(b, a), elems, reverse=True
    )
    # V_{k+1} terms needed by the stage-k gains:
    P_next = 0.5 * suffix[4][1:]           # (N, nx, nx)
    eta_next = suffix[3][1:]               # (N, nx); q_{k+1} = -eta/2

    # --- per-stage gains (same algebra as the sequential solver) -----------
    def gains(A_k, B_k, c_k, P_n, eta_n, ur_k):
        BtP = _mm(B_k.T, P_n)
        S = R + _mm(BtP, B_k)
        S_chol = jnp.linalg.cholesky(S)
        K = jax.scipy.linalg.cho_solve((S_chol, True), _mm(BtP, A_k))
        q_n = -0.5 * eta_n
        d = jax.scipy.linalg.cho_solve(
            (S_chol, True), _mm(B_k.T, _mm(P_n, c_k) + q_n) - r_diag * ur_k
        )
        return K, d

    Ks, ds = jax.vmap(gains)(A, B, c, P_next, eta_next, u_ref)

    # --- forward rollout as an associative scan of affine maps -------------
    M = A - jnp.einsum("kij,kjl->kil", B, Ks)                  # (N, nx, nx)
    v = c - jnp.einsum("kij,kj->ki", B, ds)

    def compose(f, g):                     # f earlier: x -> M_f x + v_f
        M_f, v_f = f
        M_g, v_g = g
        return _mm(M_g, M_f), _mm(M_g, v_f[..., None])[..., 0] + v_g

    Mp, vp = jax.lax.associative_scan(compose, (M, v))
    X_tail = jnp.einsum("kij,j->ki", Mp, x0) + vp              # x_1..x_N
    X = jnp.concatenate([x0[None, :], X_tail], axis=0)
    U = -jnp.einsum("kij,kj->ki", Ks, X[:-1]) - ds
    return LQRSolution(U=U, X=X, gains=Ks, feedforward=ds)
