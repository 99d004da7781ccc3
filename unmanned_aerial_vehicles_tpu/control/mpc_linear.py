"""6-state linear GP-MPC as a condensed box-QP (the flagship controller).

Re-formulation of the reference's CasADi/Ipopt MPC
(``/root/reference/src/px4/mpc.py:1305-1646``):

* same model: double integrator, ``x_{k+1} = x_k + dt (f_nom + d_k)``
  with stage-wise GP dynamics residuals ``d_k``;
* same cost: ``Q_pos = diag(50,50,80)``, ``Q_vel = diag(12,12,18)``,
  ``R = diag(2,2,1,8)``, terminal ``3 Q_pos`` / ``2 Q_vel``
  (``mpc.py:1384-1418``);
* same box bounds on states and controls (``mpc.py:1440-1457``);
* same warm-start-by-shifting policy (``mpc.py:1632-1646``).

but instead of an interior-point NLP the states are eliminated and the
problem is solved in control space by fixed-iteration ADMM (``ops/qp.py``).
All horizon matrices are compile-time constants; GP residuals enter as a
traced parameter, so GP-posterior + QP-solve fuse into **one XLA program
per tick** — this removes the reference's per-tick Python GP loop
(``mpc.py:1490-1506``) and Ipopt's data-dependent iteration counts.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

from .. import struct
import jax
import jax.numpy as jnp
import numpy as np

from ..models.double_integrator import CONTROL_DIM, STATE_DIM
from ..ops.qp import AdmmState, admm_box_qp_composite, condense_dynamics


@struct.dataclass
class LinearMPCConfig:
    dt: float = 0.02
    horizon: int = 25
    q_pos: Tuple[float, float, float] = (50.0, 50.0, 80.0)
    q_vel: Tuple[float, float, float] = (12.0, 12.0, 18.0)
    r_control: Tuple[float, float, float, float] = (2.0, 2.0, 1.0, 8.0)
    terminal_pos_weight: float = 3.0
    terminal_vel_weight: float = 2.0
    state_lower: Tuple[float, ...] = (-30.0, -30.0, -5.0, -8.0, -8.0, -4.0)
    state_upper: Tuple[float, ...] = (30.0, 30.0, 20.0, 8.0, 8.0, 4.0)
    control_lower: Tuple[float, ...] = (-4.0, -4.0, -5.0, -1.0)
    control_upper: Tuple[float, ...] = (4.0, 4.0, 8.0, 1.0)
    # NOTE: the GP residual gain (mpc.py:1333) lives on ResidualGPConfig —
    # residuals arrive here already gain-scaled.
    admm_iterations: int = 80
    admm_rho: float = 8.0
    admm_over_relax: float = 1.6
    # solve-to-convergence mode: active-set polish of the ADMM iterate
    # (ops.qp.active_set_polish). With f64 this matches the reference's
    # interior-point semantics (Ipopt tol=1e-6, mpc.py:1427-1438) to <=1e-8
    # per-tick u0 — the 1e-6 solver-parity bar. Adds one (n+m) LU per tick.
    polish: bool = False
    polish_tol: float = 1e-7
    polish_passes: int = 3
    # uncertainty-aware constraint tightening (zero-order GP-MPC back-off,
    # arXiv:2211.15522): state boxes shrink by factor * propagated GP std.
    # 0.0 disables (bit-exact baseline behaviour).
    tightening_factor: float = 0.0


class MPCCarry(NamedTuple):
    """Warm-start state carried across ticks (condensed analogue of the
    reference's ``previous_solution``)."""

    slack: jnp.ndarray       # ADMM z  (m,)
    dual: jnp.ndarray        # ADMM y  (m,)
    X_prev: jnp.ndarray      # (N+1, 6) previous predicted states
    U_prev: jnp.ndarray      # (N, 4) previous optimal controls


class LinearMPC:
    """Condensed-QP linear MPC. Build once (NumPy, f64), solve under jit."""

    def __init__(self, config: LinearMPCConfig = LinearMPCConfig(), dtype=jnp.float32):
        self.config = config
        self.dtype = dtype
        N, dt = config.horizon, config.dt
        nx, nu = STATE_DIM, CONTROL_DIM

        A = np.eye(nx)
        A[0:3, 3:6] = dt * np.eye(3)
        B = np.zeros((nx, nu))
        B[3:6, 0:3] = dt * np.eye(3)

        Sx, Su, Sw = condense_dynamics(A, B, N)

        q_stage = np.concatenate([config.q_pos, config.q_vel])
        q_term = np.concatenate(
            [
                config.terminal_pos_weight * np.asarray(config.q_pos),
                config.terminal_vel_weight * np.asarray(config.q_vel),
            ]
        )
        qbar = np.concatenate([np.tile(q_stage, N - 1), q_term])
        rbar = np.tile(np.asarray(config.r_control), N)

        H = Su.T @ (qbar[:, None] * Su) + np.diag(rbar)
        G = np.vstack([np.eye(N * nu), Su])
        M = H + config.admm_rho * (G.T @ G)
        M_inv = np.linalg.inv(M)

        self.n_primal = N * nu
        self.n_constraints = G.shape[0]

        # Keep static problem data as HOST numpy arrays: under jit they embed
        # as compile-time constants of the step program.
        np_dtype = np.dtype(jnp.dtype(dtype).name)
        cast = lambda a: np.asarray(a, dtype=np_dtype)
        self._Sx, self._Su, self._Sw = cast(Sx), cast(Su), cast(Sw)
        self._qbar = cast(qbar)
        self._H, self._G, self._M_inv = cast(H), cast(G), cast(M_inv)
        self._SuT_q = cast(Su.T * qbar[None, :])
        # operator-composed ADMM data (ops.qp.admm_box_qp_composite):
        # one matmul per iteration instead of three
        GMinv = G @ M_inv
        self._GMinv = cast(GMinv)
        self._P1 = cast(GMinv @ G.T)
        self._u_lo = cast(np.tile(config.control_lower, N))
        self._u_hi = cast(np.tile(config.control_upper, N))
        self._x_lo = cast(np.tile(config.state_lower, N))
        self._x_hi = cast(np.tile(config.state_upper, N))
        self._Sw_sq = cast(Sw**2)   # variance propagation (tightening)


    # ------------------------------------------------------------------
    def init_carry(self, state: jnp.ndarray | None = None) -> MPCCarry:
        N = self.config.horizon
        x0 = jnp.zeros(STATE_DIM, self.dtype) if state is None else state.astype(self.dtype)
        return MPCCarry(
            slack=jnp.zeros(self.n_constraints, self.dtype),
            dual=jnp.zeros(self.n_constraints, self.dtype),
            X_prev=jnp.tile(x0[None, :], (N + 1, 1)),
            U_prev=jnp.zeros((N, CONTROL_DIM), self.dtype),
        )

    def _shift(self, carry: MPCCarry, x0: jnp.ndarray) -> MPCCarry:
        """Shift the warm start one stage forward (``mpc.py:1632-1646``)."""
        N = self.config.horizon

        def roll(mat):
            return jnp.concatenate([mat[1:], mat[-1:]], axis=0)

        zu = roll(carry.slack[: N * CONTROL_DIM].reshape(N, CONTROL_DIM)).reshape(-1)
        zx = roll(carry.slack[N * CONTROL_DIM :].reshape(N, STATE_DIM)).reshape(-1)
        yu = roll(carry.dual[: N * CONTROL_DIM].reshape(N, CONTROL_DIM)).reshape(-1)
        yx = roll(carry.dual[N * CONTROL_DIM :].reshape(N, STATE_DIM)).reshape(-1)
        X_prev = roll(carry.X_prev).at[0].set(x0)
        return MPCCarry(
            slack=jnp.concatenate([zu, zx]),
            dual=jnp.concatenate([yu, yx]),
            X_prev=X_prev,
            U_prev=roll(carry.U_prev),
        )

    # ------------------------------------------------------------------
    def solve(
        self,
        carry: MPCCarry,
        state: jnp.ndarray,
        target_pos: jnp.ndarray,
        residuals: jnp.ndarray | None = None,
        reference_states: jnp.ndarray | None = None,
        uncertainty: jnp.ndarray | None = None,
    ):
        """One MPC tick. ``state``: 6-vector, ``target_pos``: 3-vector,
        ``residuals``: optional ``(N, 6)`` stage-wise GP dynamics residuals
        d_k (already gain-scaled). Returns ``(u0, X_opt, new_carry)``.

        ``uncertainty``: optional ``(N, 6)`` stage-wise GP dynamics stds
        (``gp.build_horizon_uncertainty``). With
        ``config.tightening_factor`` kappa > 0 the state boxes shrink by
        kappa times the std propagated through the prediction matrix
        (independent-disturbance variance propagation: sigma_X =
        sqrt(Sw^2 (dt sigma_d)^2)) — the back-off of zero-order GP-MPC
        (arXiv:2211.15522), a use of the posterior variance the reference
        computes but never closes the loop on.

        ``reference_states``: optional ``(N, 6)`` per-stage state references
        (trajectory *preview*). The reference controller tracks only a point
        target per tick (``mpc.py:1384-1391``), which bakes a systematic lag
        into its tracking numbers; previewing the trajectory over the horizon
        is the same QP with a richer linear term and removes that lag.
        Overrides ``target_pos`` when given.
        """
        cfg = self.config
        N = cfg.horizon
        x0 = state.astype(self.dtype)

        carry = self._shift(carry, x0)

        if residuals is None:
            w = jnp.zeros(N * STATE_DIM, self.dtype)
        else:
            w = (cfg.dt * residuals.astype(self.dtype)).reshape(-1)

        if reference_states is not None:
            ref = reference_states.astype(self.dtype).reshape(-1)
        else:
            ref = jnp.tile(
                jnp.concatenate(
                    [target_pos.astype(self.dtype), jnp.zeros(3, self.dtype)]
                ),
                N,
            )
        mm = lambda a, b: jnp.matmul(a, b, precision=jax.lax.Precision.HIGHEST)
        offset = mm(self._Sx, x0) + mm(self._Sw, w)
        f = mm(self._SuT_q, offset - ref)

        x_lo, x_hi = self._x_lo, self._x_hi
        if uncertainty is not None and cfg.tightening_factor > 0.0:
            var_x = mm(
                self._Sw_sq,
                (cfg.dt * uncertainty.astype(self.dtype).reshape(-1)) ** 2,
            )
            tight = cfg.tightening_factor * jnp.sqrt(var_x)
            # never invert a box: cap at 45% of its width
            tight = jnp.minimum(tight, 0.45 * (x_hi - x_lo))
            x_lo = x_lo + tight
            x_hi = x_hi - tight
        lower = jnp.concatenate([self._u_lo, x_lo - offset])
        upper = jnp.concatenate([self._u_hi, x_hi - offset])

        p0 = -mm(self._GMinv, f)
        minv_f = mm(self._M_inv, f)

        sol = admm_box_qp_composite(
            self._P1,
            p0,
            self._GMinv.T,
            minv_f,
            lower,
            upper,
            carry.slack,
            carry.dual,
            cfg.admm_rho,
            cfg.admm_iterations,
            cfg.admm_over_relax,
        )
        if cfg.polish:
            from ..ops.qp import active_set_polish

            U_pol, y_pol, _ = active_set_polish(
                jnp.asarray(self._H),
                jnp.asarray(self._G),
                f,
                lower,
                upper,
                sol,
                tol=cfg.polish_tol,
                passes=cfg.polish_passes,
            )
            # slack = G U_pol keeps the downstream U-block extraction
            # intact (G = [I; Su] so its first block IS U_pol)
            sol = AdmmState(
                primal=U_pol, slack=mm(self._G, U_pol), dual=y_pol
            )

        # controls come from the slack's U-block: box-feasible by
        # construction at every iteration (the primal can violate bounds
        # mid-convergence or on infeasible problems, e.g. a state outside
        # its box after a disturbance); equals the primal at convergence
        U = sol.slack[: N * CONTROL_DIM].reshape(N, CONTROL_DIM)
        X_tail = (offset + mm(self._Su, sol.primal)).reshape(N, STATE_DIM)
        X_opt = jnp.concatenate([x0[None, :], X_tail], axis=0)

        new_carry = MPCCarry(slack=sol.slack, dual=sol.dual, X_prev=X_opt, U_prev=U)
        return U[0], X_opt, new_carry

    # ------------------------------------------------------------------
    def qp_data(self, state, target_pos, residuals=None):
        """(H, G, f, l, u) of the tick's QP — for KKT/parity tests."""
        cfg = self.config
        N = cfg.horizon
        x0 = state.astype(self.dtype)
        if residuals is None:
            w = jnp.zeros(N * STATE_DIM, self.dtype)
        else:
            w = (cfg.dt * residuals.astype(self.dtype)).reshape(-1)
        ref = jnp.tile(
            jnp.concatenate([target_pos.astype(self.dtype), jnp.zeros(3, self.dtype)]),
            N,
        )
        mm = lambda a, b: jnp.matmul(a, b, precision=jax.lax.Precision.HIGHEST)
        offset = mm(self._Sx, x0) + mm(self._Sw, w)
        f = mm(self._SuT_q, offset - ref)
        lower = jnp.concatenate([self._u_lo, self._x_lo - offset])
        upper = jnp.concatenate([self._u_hi, self._x_hi - offset])
        return self._H, self._G, f, lower, upper
