"""GP model checkpointing (npz pytree snapshots).

Replaces the reference's three checkpoint formats — sklearn pickle
(``/root/reference/src/px4/train_gp_offline.py:186-214``), per-dimension
model+scaler pickles (``src/px4/gp_trainer.py:207-229``), and the npz of the
from-scratch GP (``quadrotor_gp_mpc/gaussian_process.py:369-394``) — with a
single npz layout holding the training set, hyperparameters and
normalisation stats. Refitting on load (one Cholesky) reproduces the
posterior exactly, mirroring ``gaussian_process.py:380-394``.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from ..gp.exact_gp import GPParams, GPPosterior, fit_gp


def save_gp_checkpoint(path: str, posterior: GPPosterior, X, Y, jitter: float,
                       normalize_y: bool = True, metadata: dict | None = None):
    arrays = {
        "X_train": np.asarray(X),
        "Y_train": np.asarray(Y),
        "log_length_scale": np.asarray(posterior.params.log_length_scale),
        "log_signal_variance": np.asarray(posterior.params.log_signal_variance),
        "log_noise_variance": np.asarray(posterior.params.log_noise_variance),
        "jitter": np.asarray(jitter),
        "normalize_y": np.asarray(normalize_y),
    }
    for k, v in (metadata or {}).items():
        arrays[f"meta_{k}"] = np.asarray(v)
    np.savez(path, **arrays)


def load_gp_checkpoint(path: str, dtype=None):
    """Returns ``(posterior, X, Y, jitter, normalize_y)`` with the posterior
    refitted (``normalize_y`` is surfaced so any capacity-capped REfit can
    reproduce the checkpoint's normalisation choice exactly)."""
    data = np.load(path)
    X = data["X_train"]
    Y = data["Y_train"]
    if dtype is not None:
        X, Y = X.astype(dtype), Y.astype(dtype)
    params = GPParams(
        log_length_scale=data["log_length_scale"],
        log_signal_variance=data["log_signal_variance"],
        log_noise_variance=data["log_noise_variance"],
    )
    jitter = float(data["jitter"])
    normalize_y = bool(data["normalize_y"])
    posterior = fit_gp(params, X, Y, jitter=jitter, normalize_y=normalize_y)
    return posterior, X, Y, jitter, normalize_y


# ---------------------------------------------------------------------------
# Mid-flight resume checkpoints (loop.closed_loop.FlightResumeState)
# ---------------------------------------------------------------------------


def save_resume_state(path: str, rs) -> None:
    """Persist a ``FlightResumeState`` as an npz of its pytree leaves.

    The reference checkpoints GP models only and has no mid-run resume
    (SURVEY section 5); this stores the COMPLETE rollout scan carry so a
    flight continues bit-exactly after a crash/preemption.
    """
    import jax

    leaves = jax.tree_util.tree_leaves(rs.carry)
    np.savez(
        path,
        __tick__=np.asarray(rs.tick, np.int64),
        __meta__=np.asarray([int(m) for m in rs.meta], np.int64),
        __n_leaves__=np.asarray(len(leaves), np.int64),
        **{f"leaf_{i}": np.asarray(v) for i, v in enumerate(leaves)},
    )


def load_resume_state(path: str, like):
    """Load a resume checkpoint saved by ``save_resume_state``.

    ``like`` is a structurally-identical ``FlightResumeState`` from the
    SAME rollout configuration (obtain one cheaply by running a single
    segment with ``return_resume=True``): pytree STRUCTURE comes from the
    code/config, only the VALUES come from disk — so a stale or mismatched
    checkpoint fails loudly instead of silently reshaping.
    """
    import jax

    data = np.load(path)
    saved_meta = tuple(int(m) for m in data["__meta__"])
    like_meta = tuple(int(m) for m in like.meta)
    if saved_meta != like_meta:
        raise ValueError(
            f"checkpoint config mismatch: saved (horizon, gp_capacity, "
            f"variance, scaled) = {saved_meta}, current = {like_meta}"
        )
    n = int(data["__n_leaves__"])
    treedef = jax.tree_util.tree_structure(like.carry)
    if treedef.num_leaves != n:
        raise ValueError(
            f"checkpoint has {n} leaves but the rollout configuration "
            f"produces {treedef.num_leaves} — config mismatch"
        )
    like_leaves = jax.tree_util.tree_leaves(like.carry)
    leaves = []
    for i, ref_leaf in enumerate(like_leaves):
        v = data[f"leaf_{i}"]
        if tuple(v.shape) != tuple(np.shape(ref_leaf)):
            raise ValueError(
                f"checkpoint leaf {i} has shape {v.shape}, expected "
                f"{np.shape(ref_leaf)} — config mismatch"
            )
        leaves.append(jnp.asarray(v, jnp.asarray(ref_leaf).dtype))
    carry = jax.tree_util.tree_unflatten(treedef, leaves)
    return like.replace(carry=carry, tick=int(data["__tick__"]))

