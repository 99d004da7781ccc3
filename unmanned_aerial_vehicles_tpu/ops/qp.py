"""Condensed box-constrained QP machinery (the Ipopt replacement).

The reference solves its linear MPC
(``/root/reference/src/px4/mpc.py:1338-1461``) as a sparse NLP through
CasADi/Ipopt: decision variables = all states and controls, equality
constraints = dynamics, box bounds on everything, an interior-point solve
with data-dependent iteration counts — none of which maps to an
accelerator.

Accelerator formulation: because the dynamics are **linear**, the states are
eliminated (*condensed*) so the QP lives in control-space only,

    min_U  1/2 U' H U + f' U      s.t.  l <= G U <= u,

with ``G = [I; Su]`` stacking the control box and the state box (mapped
through the prediction matrix ``Su``). For a fixed horizon every matrix here
is a **compile-time constant** — ``H``, ``G`` and the ADMM system inverse are
baked into the XLA program; the per-tick work is a handful of (256x128)-class
matmuls, with *fixed* iteration counts and zero branching.

Solver: over-relaxed ADMM (splitting ``z = G U``), the classic OSQP-style
iteration specialised to a constant system matrix:

    U  <- M^{-1} (-f + G'(rho z - y)),   M = H + rho G'G   (prefactored)
    Gt <- alpha G U + (1 - alpha) z
    z  <- clip(Gt + y / rho, l, u)
    y  <- y + rho (Gt - z)

Warm starts carry ``(z, y)`` across control ticks (the condensed analogue of
the reference's shifted-solution warm start, ``mpc.py:1632-1646``).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np


def condense_dynamics(A: np.ndarray, B: np.ndarray, N: int):
    """Prediction matrices for ``x_{k+1} = A x_k + B u_k + w_k``.

    Returns ``(Sx, Su, Sw)`` with stacked states ``X = [x_1; ...; x_N]``:
        X = Sx @ x0 + Su @ U + Sw @ W
    where ``U = [u_0; ...; u_{N-1}]`` and ``W = [w_0; ...; w_{N-1}]``.
    Pure NumPy — runs once at controller build time, in float64.
    """
    nx, nu = B.shape
    Sx = np.zeros((N * nx, nx))
    Su = np.zeros((N * nx, N * nu))
    Sw = np.zeros((N * nx, N * nx))

    Ak = np.eye(nx)
    powers = [Ak]
    for _ in range(N):
        Ak = A @ Ak
        powers.append(Ak)  # powers[k] = A^k

    for k in range(1, N + 1):
        Sx[(k - 1) * nx : k * nx, :] = powers[k]
        for j in range(k):
            blk = powers[k - 1 - j]
            Su[(k - 1) * nx : k * nx, j * nu : (j + 1) * nu] = blk @ B
            Sw[(k - 1) * nx : k * nx, j * nx : (j + 1) * nx] = blk
    return Sx, Su, Sw


class AdmmState(NamedTuple):
    primal: jnp.ndarray  # U
    slack: jnp.ndarray   # z  (constraint-space iterate)
    dual: jnp.ndarray    # y


def admm_box_qp(
    M_inv: jnp.ndarray,
    G: jnp.ndarray,
    f: jnp.ndarray,
    lower: jnp.ndarray,
    upper: jnp.ndarray,
    z0: jnp.ndarray,
    y0: jnp.ndarray,
    rho: float,
    iterations: int,
    over_relax: float = 1.6,
) -> AdmmState:
    """Fixed-iteration over-relaxed ADMM for ``min 1/2 U'HU + f'U,
    l <= GU <= u`` given the prefactored ``M_inv = (H + rho G'G)^{-1}``.

    Shapes: ``M_inv (n,n)``, ``G (m,n)``, ``f (n,)``, bounds/duals ``(m,)``.
    Everything is matmul + clip, no branching. Matmuls run at HIGHEST
    precision (never TF32) — ADMM convergence to the 1e-6 parity bar needs
    true f32 accumulation, and these GEMMs are far too small for the
    precision to cost anything.

    The returned primal is refreshed from the FINAL ``(z, y)`` pair (one
    extra half-step after the loop), matching ``admm_box_qp_composite``, so
    both paths return identical iterates.
    """
    GT = G.T
    prec = jax.lax.Precision.HIGHEST
    mm = lambda a, b: jnp.matmul(a, b, precision=prec)

    def body(_, state: AdmmState) -> AdmmState:
        rhs = -f + mm(GT, rho * state.slack - state.dual)
        U = mm(M_inv, rhs)
        GU = mm(G, U)
        Gt = over_relax * GU + (1.0 - over_relax) * state.slack
        z = jnp.clip(Gt + state.dual / rho, lower, upper)
        y = state.dual + rho * (Gt - z)
        return AdmmState(U, z, y)

    init = AdmmState(jnp.zeros(G.shape[1], dtype=f.dtype), z0, y0)
    out = jax.lax.fori_loop(0, iterations, body, init)
    U = mm(M_inv, -f + mm(GT, rho * out.slack - out.dual))
    return AdmmState(U, out.slack, out.dual)


def admm_box_qp_composite(
    P1: jnp.ndarray,      # (m, m) = G M^{-1} G'
    p0: jnp.ndarray,      # (m,)   = -G M^{-1} f   (per-tick)
    GMinvT: jnp.ndarray,  # (n, m) = M^{-1} G'     (for the final primal)
    Minv_f: jnp.ndarray,  # (n,)   = M^{-1} f      (per-tick)
    lower: jnp.ndarray,
    upper: jnp.ndarray,
    z0: jnp.ndarray,
    y0: jnp.ndarray,
    rho: float,
    iterations: int,
    over_relax: float = 1.6,
) -> AdmmState:
    """Operator-composed ADMM: algebraically identical to ``admm_box_qp``
    but with ONE matmul per iteration instead of three.

        GU = G M^{-1} (-f + G'(rho z - y)) = p0 + P1 (rho z - y)

    The per-iteration dependency chain is a single (m, m) matvec, so for
    latency-bound solves (sequential small matmuls) this is ~3x shorter; the
    primal U is recovered once at the end. ``P1`` is a compile-time constant
    for fixed-horizon linear MPC."""
    prec = jax.lax.Precision.HIGHEST
    mm = lambda a, b: jnp.matmul(a, b, precision=prec)

    def body(_, state: AdmmState) -> AdmmState:
        z, y = state.slack, state.dual
        GU = p0 + mm(P1, rho * z - y)
        Gt = over_relax * GU + (1.0 - over_relax) * z
        z_new = jnp.clip(Gt + y / rho, lower, upper)
        y_new = y + rho * (Gt - z_new)
        return AdmmState(state.primal, z_new, y_new)

    init = AdmmState(jnp.zeros(GMinvT.shape[0], dtype=lower.dtype), z0, y0)
    out = jax.lax.fori_loop(0, iterations, body, init)
    U = -Minv_f + mm(GMinvT, rho * out.slack - out.dual)
    return AdmmState(U, out.slack, out.dual)


def admm_box_qp_chol(
    M_chol: jnp.ndarray,
    G: jnp.ndarray,
    f: jnp.ndarray,
    lower: jnp.ndarray,
    upper: jnp.ndarray,
    z0: jnp.ndarray,
    y0: jnp.ndarray,
    rho: float,
    iterations: int,
    over_relax: float = 1.6,
) -> AdmmState:
    """ADMM with an in-graph Cholesky factor of ``M = H + rho G'G``.

    Used by the SQP/LTV controllers whose ``H`` is *traced* (re-linearised
    every tick, so no compile-time inverse exists): one ``cholesky`` per
    solve + two triangular solves per iteration.
    """
    GT = G.T
    prec = jax.lax.Precision.HIGHEST
    mm = lambda a, b: jnp.matmul(a, b, precision=prec)

    def body(_, state: AdmmState) -> AdmmState:
        rhs = -f + mm(GT, rho * state.slack - state.dual)
        U = jax.scipy.linalg.cho_solve((M_chol, True), rhs)
        GU = mm(G, U)
        Gt = over_relax * GU + (1.0 - over_relax) * state.slack
        z = jnp.clip(Gt + state.dual / rho, lower, upper)
        y = state.dual + rho * (Gt - z)
        return AdmmState(U, z, y)

    init = AdmmState(jnp.zeros(G.shape[1], dtype=f.dtype), z0, y0)
    return jax.lax.fori_loop(0, iterations, body, init)


def condense_ltv(A: jnp.ndarray, B: jnp.ndarray, c: jnp.ndarray):
    """In-graph condensation of time-varying affine dynamics.

    ``x_{k+1} = A_k x_k + B_k u_k + c_k`` with ``A (N,nx,nx)``,
    ``B (N,nx,nu)``, ``c (N,nx)`` (all traced — produced per tick by
    ``jax.jacfwd`` of the discrete step). Returns ``(Sx, Su, Sc)`` with

        X = Sx @ x0 + Su @ U + Sc,    X = [x_1..x_N],  U = [u_0..u_{N-1}]

    as ``(N*nx, nx)``, ``(N*nx, N*nu)``, ``(N*nx,)``. One ``lax.scan`` of
    three small matmuls per stage — the traced analogue of
    ``condense_dynamics``.
    """
    N, nx, nu = B.shape
    prec = jax.lax.Precision.HIGHEST

    def step(carry, inputs):
        row_x, row_u, row_c = carry          # (nx,nx), (nx,N*nu), (nx,)
        A_k, B_k, c_k, k = inputs
        new_x = jnp.matmul(A_k, row_x, precision=prec)
        new_u = jnp.matmul(A_k, row_u, precision=prec)
        new_u = jax.lax.dynamic_update_slice(new_u, B_k, (0, k * nu))
        new_c = jnp.matmul(A_k, row_c, precision=prec) + c_k
        carry = (new_x, new_u, new_c)
        return carry, carry

    init = (
        jnp.eye(nx, dtype=B.dtype),
        jnp.zeros((nx, N * nu), B.dtype),
        jnp.zeros((nx,), B.dtype),
    )
    _, (Sx, Su, Sc) = jax.lax.scan(step, init, (A, B, c, jnp.arange(N)))
    return (
        Sx.reshape(N * nx, nx),
        Su.reshape(N * nx, N * nu),
        Sc.reshape(N * nx),
    )


def condense_ltv_doubling(A: jnp.ndarray, B: jnp.ndarray, c: jnp.ndarray):
    """``condense_ltv`` with log-depth block doubling instead of an N-step
    serial scan.

    The serial condensation is a chain of N dependent (nx,nx) matmuls,
    bound by issue latency rather than work. Doubling combines adjacent horizon blocks

        Sx = [Sx_L; Sx_R PhiL],  Su = [[Su_L, 0], [Sx_R SuL_end, Su_R]],
        Sc = [Sc_L; Sx_R ScL_end + Sc_R]

    so depth is ``ceil(log2 N)`` levels of BATCHED small GEMMs. The horizon
    pads to a power of two with zero stages (A=B=c=0); their rows/columns
    are sliced off at the end. Same contraction precision (HIGHEST) as the
    serial form; association order differs, so results agree to f32
    rounding (~1e-6 relative — parity pinned in ``tests/test_mpc_sqp.py``),
    which is why the per-tick engines with 1e-6 external-solver parity
    bars keep the serial form and only the multitick dispatch preps use
    this one.
    """
    N, nx, nu = B.shape
    prec = jax.lax.Precision.HIGHEST
    P = 1 << max(N - 1, 0).bit_length()
    if P != N:
        pad = P - N
        A = jnp.concatenate([A, jnp.zeros((pad, nx, nx), A.dtype)])
        B = jnp.concatenate([B, jnp.zeros((pad, nx, nu), B.dtype)])
        c = jnp.concatenate([c, jnp.zeros((pad, nx), c.dtype)])
    mmb = lambda a, b: jnp.einsum("bij,bjk->bik", a, b, precision=prec)
    Sx, Su, Sc = A, B, c          # blocks of length L=1: (P, L*nx, .)
    L = 1
    while L < P:
        m = Sx.shape[0] // 2
        SxL, SxR = Sx[0::2], Sx[1::2]
        SuL, SuR = Su[0::2], Su[1::2]
        ScL, ScR = Sc[0::2], Sc[1::2]
        PhiL = SxL[:, -nx:, :]                    # end-state map of left
        SuLe = SuL[:, -nx:, :]
        ScLe = ScL[:, -nx:]
        Sx = jnp.concatenate([SxL, mmb(SxR, PhiL)], axis=1)
        Su = jnp.concatenate(
            [
                jnp.concatenate([SuL, jnp.zeros_like(SuL)], axis=2),
                jnp.concatenate([mmb(SxR, SuLe), SuR], axis=2),
            ],
            axis=1,
        )
        Sc = jnp.concatenate(
            [ScL,
             jnp.einsum("bij,bj->bi", SxR, ScLe, precision=prec) + ScR],
            axis=1,
        )
        L *= 2
    return (
        Sx[0, : N * nx],
        Su[0, : N * nx, : N * nu],
        Sc[0, : N * nx],
    )


def kkt_score(H, G, f, lower, upper, U, y):
    """Scalar KKT optimality score (infinity norm over all conditions).

    max of: stationarity ``|HU + f + G'y|``, primal violation
    ``max(0, GU - u, l - GU)``, and complementarity
    ``|max(y,0) (u - GU)|, |min(y,0) (GU - l)|`` (which also catches
    wrong-sign duals). Zero exactly at a KKT point.
    """
    prec = jax.lax.Precision.HIGHEST
    mm = lambda a, b: jnp.matmul(a, b, precision=prec)
    GU = mm(G, U)
    stat = jnp.max(jnp.abs(mm(H, U) + f + mm(G.T, y)))
    prim = jnp.max(jnp.maximum(jnp.maximum(GU - upper, lower - GU), 0.0))
    # bounds beyond 1e8 encode "unbounded" placeholder rows (the obstacle
    # 1e9 uppers of mpc_sqp._subproblem): cap their complementarity gap at 1
    # so a tiny mid-convergence dual on an inactive placeholder row cannot
    # dominate the score (same convention as nonlinear_kkt_score)
    hi_gap = jnp.where(upper > 1e8, 1.0, upper - GU)
    lo_gap = jnp.where(lower < -1e8, 1.0, GU - lower)
    comp = jnp.maximum(
        jnp.max(jnp.abs(jnp.maximum(y, 0.0) * hi_gap)),
        jnp.max(jnp.abs(jnp.minimum(y, 0.0) * lo_gap)),
    )
    return jnp.maximum(jnp.maximum(stat, prim), comp)


def active_set_polish(
    H: jnp.ndarray,
    G: jnp.ndarray,
    f: jnp.ndarray,
    lower: jnp.ndarray,
    upper: jnp.ndarray,
    state: AdmmState,
    tol: float = 1e-7,
    passes: int = 3,
    reg: float = 1e-9,
    refine_steps: int = 2,
):
    """OSQP-style active-set polish of an ADMM iterate (fixed shapes, jit).

    Detects the active set from the iterate's primal proximity + dual signs,
    then solves the equality-constrained KKT system restricted to it. The
    system keeps ALL m dual variables (XLA needs static shapes): active
    rows impose ``(GU)_i = b_i``, inactive rows impose ``nu_i = 0``:

        [ H      G'        ] [U ]   [ -f  ]
        [ D G    diag(1-D) ] [nu] = [ D b ]

    solved via a regularised LU factorisation plus ``refine_steps`` rounds of
    iterative refinement against the UNregularised matrix (recovering
    near-machine-precision solutions). Re-detects the active set ``passes``
    times; returns whichever iterate — input or any polished pass — has the
    best ``kkt_score`` (so a mis-detected active set can never make the
    answer worse).

    This is the ``solve-to-convergence`` layer that closes the gap between
    fixed-iteration ADMM (~1e-5) and the interior-point reference semantics
    of ``/root/reference/src/px4/mpc.py:1338-1461`` (Ipopt tol=1e-6): in f64
    the polished ``u0`` matches scipy trust-constr to <=1e-8.
    Returns ``(U, y, score)``.
    """
    n = H.shape[0]
    m = G.shape[0]
    dtype = f.dtype
    prec = jax.lax.Precision.HIGHEST
    mm = lambda a, b: jnp.matmul(a, b, precision=prec)

    reg_vec = jnp.concatenate(
        [jnp.full((n,), reg, dtype), jnp.full((m,), -reg, dtype)]
    )

    def one_pass(U, y):
        GU = mm(G, U)
        lo_act = (y < -tol) | (GU < lower + tol)
        hi_act = (y > tol) | (GU > upper - tol)
        D = (lo_act | hi_act).astype(dtype)
        b = jnp.where(lo_act, lower, upper)

        K = jnp.block(
            [[H, G.T], [D[:, None] * G, jnp.diag(1.0 - D)]]
        )
        rhs = jnp.concatenate([-f, D * b])
        lu = jax.scipy.linalg.lu_factor(K + jnp.diag(reg_vec))
        sol = jax.scipy.linalg.lu_solve(lu, rhs)
        for _ in range(refine_steps):
            r = rhs - mm(K, sol)
            sol = sol + jax.scipy.linalg.lu_solve(lu, r)
        return sol[:n], D * sol[n:]

    best_U, best_y = state.primal, state.dual
    best_score = kkt_score(H, G, f, lower, upper, best_U, best_y)
    U, y = best_U, best_y
    for _ in range(passes):
        U, y = one_pass(U, y)
        score = kkt_score(H, G, f, lower, upper, U, y)
        better = score < best_score
        best_U = jnp.where(better, U, best_U)
        best_y = jnp.where(better, y, best_y)
        best_score = jnp.minimum(score, best_score)
    return best_U, best_y, best_score


def ip_box_qp(
    H: jnp.ndarray,
    G: jnp.ndarray,
    f: jnp.ndarray,
    lower: jnp.ndarray,
    upper: jnp.ndarray,
    iterations: int = 60,
    sigma: float = 0.2,
    tau: float = 0.995,
    mu_floor: float | None = None,
) -> AdmmState:
    """Fixed-iteration primal-dual interior-point solve of
    ``min 1/2 U'HU + f'U  s.t.  l <= GU <= u`` (the Ipopt-semantics tier).

    Why this exists: the fixed-iteration ADMM tier is the FLIGHT path, and
    ``active_set_polish`` can snap a *nearly converged* iterate to machine
    precision — but on brutally conditioned QPs (the LTV tracking problem:
    RK4 prediction over N=20 at dt=0.1 with weights spanning 1e4) ADMM's
    tail is too slow for the active set to be detectable, and polish has
    nothing to work with. A primal-dual IPM's convergence rate does not
    degrade the same way, which is exactly why the reference leans on Ipopt
    (``/root/reference/src/px4/mpc.py:1427-1438``). This is the from-scratch
    in-graph equivalent: fixed iteration count, no branching, one (n,n)
    Cholesky per iteration — jit/vmap/scan-safe.

    Standard path-following with slacks ``s1 = GU - l``, ``s2 = u - GU``
    kept strictly positive by a fraction-to-boundary rule; centering
    ``sigma`` fixed (no Mehrotra corrector — simplicity beats the ~2x
    iteration saving at these sizes). Placeholder "infinite" bounds
    (|b| ~ 1e9) participate harmlessly: their slacks stay ~1e9 and their
    duals fall to ~mu/1e9.

    Returns an ``AdmmState`` (primal ``U``, slack ``GU`` clipped, dual
    ``y = z2 - z1`` in the ADMM sign convention) so downstream tooling
    (``kkt_score``, ``active_set_polish``) applies unchanged.
    """
    n = H.shape[0]
    m = G.shape[0]
    dtype = f.dtype
    if mu_floor is None:
        # the Newton system's conditioning grows like 1/mu; freeze while a
        # Cholesky in this dtype is still trustworthy (f64: 1e-13; f32: the
        # verification tier runs in f64, but keep the f32 path from
        # diverging when driven on-chip)
        mu_floor = 1e-13 if dtype == jnp.float64 else 1e-6
    prec = jax.lax.Precision.HIGHEST
    mm = lambda a, b: jnp.matmul(a, b, precision=prec)

    U0 = jnp.zeros(n, dtype)
    g0 = mm(G, U0)
    # strictly interior slacks; duals sized so each row's complementarity
    # product starts at ~1 (keeps astronomically wide placeholder rows from
    # dominating the barrier parameter)
    s1 = jnp.maximum(g0 - lower, 1.0)
    s2 = jnp.maximum(upper - g0, 1.0)
    z1 = 1.0 / s1
    z2 = 1.0 / s2

    def body(_, state):
        U, s1, s2, z1, z2 = state
        g = mm(G, U)
        mu = (jnp.dot(s1, z1) + jnp.dot(s2, z2)) / (2.0 * m)
        # freeze once converged: past mu_floor the slacks underflow and
        # z/s blows up the Newton matrix (fixed-iteration analogue of a
        # convergence test — no branching, just a masked update)
        live = (mu > mu_floor).astype(dtype)

        r_d = mm(H, U) + f - mm(G.T, z1) + mm(G.T, z2)
        r_p1 = g - s1 - lower
        r_p2 = upper - g - s2
        r_c1 = z1 * s1 - sigma * mu
        r_c2 = z2 * s2 - sigma * mu

        w = z1 / s1 + z2 / s2
        M = H + mm(G.T * w[None, :], G)
        rhs = (
            -r_d
            - mm(G.T, (r_c1 + z1 * r_p1) / s1)
            + mm(G.T, (r_c2 + z2 * r_p2) / s2)
        )
        L = jnp.linalg.cholesky(M)
        dU = jax.scipy.linalg.cho_solve((L, True), rhs)

        GdU = mm(G, dU)
        ds1 = GdU + r_p1
        ds2 = -GdU + r_p2
        dz1 = -(r_c1 + z1 * ds1) / s1
        dz2 = -(r_c2 + z2 * ds2) / s2

        # fraction-to-boundary: largest alpha keeping s, z > (1-tau) of
        # their current values
        def max_step(v, dv):
            ratio = jnp.where(dv < 0.0, -v / jnp.where(dv < 0.0, dv, -1.0),
                              jnp.inf)
            return jnp.minimum(1.0, tau * jnp.min(ratio))

        alpha_p = live * jnp.minimum(max_step(s1, ds1), max_step(s2, ds2))
        alpha_d = live * jnp.minimum(max_step(z1, dz1), max_step(z2, dz2))

        # NaN-proof the frozen branch: a singular Newton matrix after
        # convergence would otherwise poison the masked update (0 * nan)
        dU = jnp.nan_to_num(dU)
        ds1, ds2 = jnp.nan_to_num(ds1), jnp.nan_to_num(ds2)
        dz1, dz2 = jnp.nan_to_num(dz1), jnp.nan_to_num(dz2)
        return (
            U + alpha_p * dU,
            s1 + alpha_p * ds1,
            s2 + alpha_p * ds2,
            z1 + alpha_d * dz1,
            z2 + alpha_d * dz2,
        )

    U, s1, s2, z1, z2 = jax.lax.fori_loop(
        0, iterations, body, (U0, s1, s2, z1, z2)
    )
    return AdmmState(
        primal=U,
        slack=jnp.clip(mm(G, U), lower, upper),
        dual=z2 - z1,
    )


def kkt_residuals(H, G, f, lower, upper, state: AdmmState):
    """Diagnostics: (primal infeasibility, dual residual) of an ADMM iterate.

    Solver-independent optimality check used by the parity tests:
    primal: ``max(0, GU - u, l - GU)``; dual: ``HU + f + G'y``.
    """
    prec = jax.lax.Precision.HIGHEST
    GU = jnp.matmul(G, state.primal, precision=prec)
    primal = jnp.maximum(jnp.maximum(GU - upper, lower - GU), 0.0)
    dual = (jnp.matmul(H, state.primal, precision=prec) + f
            + jnp.matmul(G.T, state.dual, precision=prec))
    return jnp.max(jnp.abs(primal)), jnp.max(jnp.abs(dual))
