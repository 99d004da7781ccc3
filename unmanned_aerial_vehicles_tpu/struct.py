"""Frozen dataclasses that are JAX pytrees.

``@dataclass`` makes a frozen dataclass, registers it with
``jax.tree_util.register_dataclass`` and gives it a ``.replace`` method.
Fields are pytree leaves unless declared with ``field(pytree_node=False)``,
which makes them static: part of the treedef, hashed into the jit cache
key, never traced.
"""

from __future__ import annotations

import dataclasses

import jax


def field(pytree_node: bool = True, **kwargs):
    """``dataclasses.field`` with a ``pytree_node`` flag (False = static)."""
    metadata = dict(kwargs.pop("metadata", None) or {}, pytree_node=pytree_node)
    return dataclasses.field(metadata=metadata, **kwargs)


def _replace(self, **changes):
    return dataclasses.replace(self, **changes)


def dataclass(cls):
    cls = dataclasses.dataclass(frozen=True)(cls)
    data, meta = [], []
    for f in dataclasses.fields(cls):
        (data if f.metadata.get("pytree_node", True) else meta).append(f.name)
    cls.replace = _replace
    return jax.tree_util.register_dataclass(
        cls, data_fields=data, meta_fields=meta
    )
