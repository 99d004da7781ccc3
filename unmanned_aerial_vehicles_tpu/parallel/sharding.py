"""Device-mesh helpers for batch-parallel sweeps.

The reference has no compute collectives — its "distribution" is ROS 2 DDS
pub/sub between processes (SURVEY.md section 5). The equivalent here
(SURVEY.md section 2 rows P1-P3): the control loop itself fuses into one
single-device program, and multi-device scale comes from **sharding batch
axes** (trajectory sweeps, hyperparameter searches) over a
``jax.sharding.Mesh``, letting XLA insert the collectives for any
cross-batch reductions.

One mesh axis (``batch``) is the honest topology for this workload: there is
no model parallelism to express — every flight/hyperparameter candidate is
independent until the final reduction (argmin / metric gather), which XLA
lowers to an all-reduce.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec


def make_mesh(n_devices: int | None = None, axis_name: str = "batch") -> Mesh:
    """1-D device mesh over the first ``n_devices`` available devices."""
    devices = jax.devices()
    if n_devices is None:
        n_devices = len(devices)
    if n_devices > len(devices):
        raise ValueError(f"requested {n_devices} devices, have {len(devices)}")
    return Mesh(np.array(devices[:n_devices]), (axis_name,))


def batch_sharding(mesh: Mesh, axis_name: str = "batch") -> NamedSharding:
    """Shard the leading axis across the mesh; everything else replicated."""
    return NamedSharding(mesh, PartitionSpec(axis_name))


def replicated_sharding(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, PartitionSpec())


def shard_batch(array, mesh: Mesh, axis_name: str = "batch"):
    """Place ``array`` with its leading axis split across the mesh."""
    return jax.device_put(array, batch_sharding(mesh, axis_name))
